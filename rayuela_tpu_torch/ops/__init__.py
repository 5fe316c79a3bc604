"""Numeric ops: k-means, quantization error, the codebook updates and
the ICM and Viterbi encoders (counterpart of `rayuela_tpu.ops`)."""

from rayuela_tpu_torch.ops.codebook_update import (chain_dims,
                                                   codebook_stats,
                                                   get_cbdims_chain,
                                                   update_codebooks,
                                                   update_codebooks_chain,
                                                   update_codebooks_generic)
from rayuela_tpu_torch.ops.icm import encoding_icm, encoding_icm_checkpoints
from rayuela_tpu_torch.ops.kmeans import KMeansResult, assign
# NOTE: the `kmeans` and `qerror` FUNCTIONS are not re-exported here:
# they would shadow their submodules on the package namespace; use
# rayuela_tpu_torch.ops.kmeans.kmeans / rayuela_tpu_torch.ops.qerror.qerror.
from rayuela_tpu_torch.ops.qerror import (get_binaries, get_unaries,
                                          qerror_opq, qerror_pq,
                                          reconstruct, reconstruct_pq,
                                          veccost, veccost_chunked)
from rayuela_tpu_torch.ops.viterbi import chain_binaries, viterbi_encode

__all__ = [
    "KMeansResult", "assign", "chain_binaries", "chain_dims",
    "codebook_stats", "encoding_icm", "encoding_icm_checkpoints",
    "get_binaries", "get_cbdims_chain", "get_unaries", "qerror_opq",
    "qerror_pq", "reconstruct", "reconstruct_pq", "update_codebooks",
    "update_codebooks_chain", "update_codebooks_generic", "veccost",
    "veccost_chunked", "viterbi_encode",
]
