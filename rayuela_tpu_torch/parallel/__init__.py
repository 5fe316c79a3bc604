"""Multi-GPU training and search over `torch.distributed` (counterpart of
`rayuela_tpu.parallel`): one process a GPU, a ``(data, model)`` mesh of
ranks, all-reduced statistics and all-gathered top-k lists. Importing
creates no process group and builds no kernel."""

from rayuela_tpu_torch.parallel.chainq_sharded import (sharded_viterbi_encode,
                                                       train_chainq_sharded)
from rayuela_tpu_torch.parallel.launch import (global_mesh,
                                               host_local_to_global,
                                               initialize)
from rayuela_tpu_torch.parallel.lsq_sharded import (make_sr_train_step,
                                                    sharded_encoding_icm,
                                                    train_lsq_family_sharded)
from rayuela_tpu_torch.parallel.mesh import (make_mesh, pq_lloyd_step_sharded,
                                             replicate, shard_data,
                                             sharded_scan_topk, sharded_search,
                                             sharded_search_codes,
                                             sharded_search_codes_decode)
from rayuela_tpu_torch.parallel.train_sharded import (
    kmeans_sharded, norms_codebook_sharded, train_compq_sharded,
    train_ervq_from_scratch_sharded, train_ervq_sharded, train_opq_sharded,
    train_pq_sharded, train_rvq_sharded)

# `train_sharded`'s names (the JAX package reaches them through its
# compiler) are importable here but not listed: `__all__` keeps the JAX
# package's names
__all__ = ["global_mesh", "host_local_to_global", "initialize",
           "make_mesh", "make_sr_train_step", "pq_lloyd_step_sharded",
           "replicate", "shard_data", "sharded_encoding_icm",
           "sharded_scan_topk", "sharded_search", "sharded_search_codes",
           "sharded_search_codes_decode", "sharded_viterbi_encode",
           "train_chainq_sharded", "train_lsq_family_sharded"]
