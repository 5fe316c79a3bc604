"""The package surface of `rayuela_tpu_torch` against `rayuela_tpu`'s.

Every public name of the JAX package's subpackages (their ``__all__``)
is exported by the port's counterpart, or stands in `NOT_YET` beside the
ROADMAP queue-A item that brings it; no name of `NOT_YET` is exported.
Importing the package and its subpackages loads neither jax nor the
CUDA kernels (they build at their first launch)."""

import importlib
import os
import subprocess
import sys

import pytest

import rayuela_tpu
import rayuela_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's public names the port has not yet, by ROADMAP queue A
# item (none left: items 3 and 5 landed last)
NOT_YET = {
    "": {},
    "ops": {},
    "models": {},
    "search": {},
    "experiments": {},
    "io": {},
    "parallel": {},
}
SUBPACKAGES = ["models", "ops", "search", "experiments", "io", "parallel",
               ""]


def _pair(sub):
    if not sub:
        return rayuela_tpu, rayuela_tpu_torch
    return (importlib.import_module(f"rayuela_tpu.{sub}"),
            importlib.import_module(f"rayuela_tpu_torch.{sub}"))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_the_jax_names(sub):
    jax_pkg, port = _pair(sub)
    missing = [n for n in jax_pkg.__all__
               if n not in NOT_YET[sub] and n not in port.__all__]
    assert not missing, missing
    for name in port.__all__:
        if not sub and not name.startswith("__"):
            importlib.import_module(f"rayuela_tpu_torch.{name}")
        assert hasattr(port, name), name
    # the port exports no public name the JAX package does not
    assert set(port.__all__) <= set(jax_pkg.__all__)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_names_not_yet_ported_stay_unexported(sub):
    jax_pkg, port = _pair(sub)
    for name, item in NOT_YET[sub].items():
        assert name in jax_pkg.__all__, name
        assert item in (3, 4, 5)
        assert name not in port.__all__, name
        if sub:
            assert not hasattr(port, name), name


def test_exports_are_the_modules_own_objects():
    """A re-export is the defining module's object, and the `kmeans` and
    `qerror` submodules stay reachable (their functions would shadow
    them, so they are not re-exported)."""
    from rayuela_tpu_torch import models, ops, search
    from rayuela_tpu_torch.models import compq, cq, ervq
    from rayuela_tpu_torch.search import scan, scan_codes
    assert models.train_compq is compq.train_compq
    assert models.quantize_ervq is ervq.quantize_ervq
    assert models.CQParameters is cq.CQParameters
    assert search.LinscanIndex is scan.LinscanIndex
    assert search.search_codes_streamed is scan_codes.search_codes_streamed
    assert ops.kmeans.__name__ == "rayuela_tpu_torch.ops.kmeans"
    assert ops.qerror.__name__ == "rayuela_tpu_torch.ops.qerror"
    assert rayuela_tpu_torch.api.save_index is not None
    assert rayuela_tpu_torch.utils.segment_sum is not None


def test_imports_load_no_jax_and_no_kernels(tmp_path):
    """In a fresh interpreter, importing the package and each subpackage
    (the I/O, the drivers, HPO, the CLI and the multi-GPU layer among
    them) imports no jax module and nothing of the JAX package, neither
    builds nor loads the CUDA library nor the native xvecs reader, loads
    neither h5py nor matplotlib, and creates no process group."""
    code = (
        "import sys\n"
        "import rayuela_tpu_torch\n"
        "import rayuela_tpu_torch.models, rayuela_tpu_torch.ops\n"
        "import rayuela_tpu_torch.search, rayuela_tpu_torch.experiments\n"
        "import rayuela_tpu_torch.convert, rayuela_tpu_torch.io\n"
        "import rayuela_tpu_torch.experiments.drivers\n"
        "import rayuela_tpu_torch.experiments.hpo\n"
        "import rayuela_tpu_torch.experiments.viz\n"
        "import rayuela_tpu_torch.cli\n"
        "import rayuela_tpu_torch.parallel\n"
        "import rayuela_tpu_torch.parallel.dryrun\n"
        "import torch.distributed as dist\n"
        "from rayuela_tpu_torch.kernels import build\n"
        "from rayuela_tpu_torch.io import native\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(build._lib is None, native._lib is None, '_build/' in maps,\n"
        "      any(k == 'jax' or k.startswith('jax.') or k == 'jaxlib'\n"
        "          for k in sys.modules),\n"
        "      any(k == 'rayuela_tpu' or k.startswith('rayuela_tpu.')\n"
        "          for k in sys.modules),\n"
        "      'h5py' in sys.modules, 'matplotlib' in sys.modules,\n"
        "      dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "False", "False", "False",
                                  "False", "False", "False"]
