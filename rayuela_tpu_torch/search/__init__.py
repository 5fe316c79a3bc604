"""Search: the decoded and code-resident scans and their kernels, norms
codebooks and recall evaluation (counterpart of `rayuela_tpu.search`)."""

from rayuela_tpu_torch.search.linscan import (eval_recall, linscan_cq,
                                              linscan_lsq, linscan_opq,
                                              linscan_pq, scan_topk)
from rayuela_tpu_torch.search.norms import get_norms_codebook, quantize_norms
from rayuela_tpu_torch.search.scan import (LinscanIndex, build_index,
                                           search, search_streamed)
from rayuela_tpu_torch.search.scan_codes import (build_codes_index,
                                                 search_codes,
                                                 search_codes_streamed)

__all__ = [
    "LinscanIndex", "build_codes_index", "build_index", "eval_recall",
    "get_norms_codebook", "linscan_cq", "linscan_lsq", "linscan_opq",
    "linscan_pq", "quantize_norms", "scan_topk", "search",
    "search_codes", "search_codes_streamed", "search_streamed",
]
