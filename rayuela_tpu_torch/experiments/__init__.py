"""Experiment drivers, datasets, result stores, plots and HPO
(counterpart of `rayuela_tpu.experiments`). Importing it loads neither
h5py nor matplotlib nor the CUDA kernels: they load in the calls that
need them."""

from rayuela_tpu_torch.experiments.datasets import (Dataset, make_synthetic,
                                                    read_dataset)
from rayuela_tpu_torch.experiments.drivers import (ALL_METHODS,
                                                   run_query_base,
                                                   run_train_query_base)
from rayuela_tpu_torch.experiments.store import (list_trials, load_results,
                                                 save_results)

__all__ = ["ALL_METHODS", "Dataset", "list_trials", "load_results",
           "make_synthetic", "read_dataset", "run_query_base",
           "run_train_query_base", "save_results"]
