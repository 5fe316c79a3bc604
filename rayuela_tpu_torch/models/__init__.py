"""Quantizer models: PQ, OPQ, RVQ, ERVQ, CompQ, ChainQ, the LSQ family
and the CQ interop (counterpart of `rayuela_tpu.models`)."""

from rayuela_tpu_torch.models.chainq import (ChainQModel, quantize_chainq,
                                             train_chainq,
                                             train_chainq_from_opq)
from rayuela_tpu_torch.models.compq import (CompQModel, quantize_compq,
                                            train_compq)
from rayuela_tpu_torch.models.cq import (CQParameters, dump_cq_parameters,
                                         load_cq_model, read_cq_bvecs,
                                         read_cq_fvecs, run_cq)
from rayuela_tpu_torch.models.ervq import (quantize_ervq, train_ervq,
                                           train_ervq_from_scratch)
from rayuela_tpu_torch.models.lsq import LSQModel, quantize_lsq, train_lsq
from rayuela_tpu_torch.models.opq import OPQModel, quantize_opq, train_opq
from rayuela_tpu_torch.models.pq import PQModel, quantize_pq, train_pq
from rayuela_tpu_torch.models.rvq import RVQModel, quantize_rvq, train_rvq
from rayuela_tpu_torch.models.sr import (apply_schedule, sr_c_perturb,
                                         sr_d_perturb, train_sr)

__all__ = [
    "ChainQModel", "CompQModel", "CQParameters", "LSQModel", "OPQModel",
    "PQModel", "RVQModel", "apply_schedule", "dump_cq_parameters",
    "load_cq_model", "quantize_chainq", "quantize_compq", "quantize_lsq",
    "quantize_ervq", "quantize_opq", "quantize_pq", "quantize_rvq",
    "read_cq_bvecs", "read_cq_fvecs", "run_cq", "sr_c_perturb",
    "sr_d_perturb", "train_chainq", "train_chainq_from_opq", "train_compq",
    "train_ervq", "train_ervq_from_scratch", "train_lsq", "train_opq",
    "train_pq", "train_rvq", "train_sr",
]
