"""Dataset I/O (counterpart of `rayuela_tpu.io`): TEXMEX xvecs and the
native C++ reader, built at its first use."""

from rayuela_tpu_torch.io.xvecs import (bvecs_read, bvecs_write, fvecs_read,
                                        fvecs_write, ivecs_read, ivecs_write)

__all__ = ["bvecs_read", "bvecs_write", "fvecs_read", "fvecs_write",
           "ivecs_read", "ivecs_write"]
