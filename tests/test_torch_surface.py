"""The package surface of `rayuela_tpu_torch` against `rayuela_tpu`'s.

Every public name of the JAX package's subpackages (their ``__all__``)
is exported by the port's counterpart, or stands in `NOT_YET` beside the
ROADMAP queue-A item that brings it; no name of `NOT_YET` is exported.
Every keyword of every public function of a JAX module is a keyword of
its twin (the function of that name in the port's module of that name,
`TWIN_MODULES` naming the Pallas modules' counterparts), or stands in
`KEYWORD_DIFFS` with its reason; a JAX function with no twin of its
name stands in `NO_TWIN` with its counterpart and the reason. Importing
the package and its subpackages loads neither jax nor the CUDA kernels
(they build at their first launch)."""

import importlib
import inspect
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


# the JAX package's modules whose public functions are held, by their
# path under `rayuela_tpu`; the port's twin module has the same path but
# for the Pallas modules (`TWIN_MODULES`)
JAX_MODULES = [
    "api", "cli", "utils", "experiments.datasets", "experiments.drivers",
    "experiments.hpo", "experiments.store", "experiments.viz", "io.native",
    "io.xvecs", "models.chainq", "models.compq", "models.cq", "models.ervq",
    "models.lsq", "models.opq", "models.pq", "models.rvq", "models.sr",
    "ops.codebook_update", "ops.icm", "ops.icm_pallas", "ops.kmeans",
    "ops.qerror", "ops.viterbi", "ops.viterbi_pallas",
    "parallel.chainq_sharded", "parallel.launch", "parallel.lsq_sharded",
    "parallel.mesh", "search.linscan", "search.norms",
    "search.scan_codes_pallas", "search.scan_pallas"]
TWIN_MODULES = {"ops.icm_pallas": "ops.icm",
                "ops.viterbi_pallas": "ops.viterbi",
                "search.scan_codes_pallas": "search.scan_codes",
                "search.scan_pallas": "search.scan"}
# keywords of the JAX package's functions that a twin does not take, and
# why (a twin that takes ``**kw`` passes every keyword on)
KEYWORD_DIFFS = {
    "key": "a jax.random PRNG key: the port draws from a torch.Generator "
           "(`gen`) or an integer `seed` in its place",
    "devices": "a list of JAX devices for the mesh: a torch.distributed "
               "process drives one `device`",
    "chunk": "the TPU's batch chunking that bounds a traced step's memory "
             "(HBM / VMEM); the port's loops pick their own chunks",
    "precision": "the TPU matmul precision (lax.Precision); the port's "
                 "matmuls run in exact f32 (`utils.exact_f32`)",
    "interpret": "runs a Pallas kernel in the TPU emulator; on CPU tensors "
                 "the port's wrappers take their kernels' plain versions",
}
# public JAX functions with no twin of their name: (the port's
# counterpart, the reason)
NO_TWIN = {
    "ops.icm_pallas.icm_sweeps_pallas": (
        "ops.icm.icm_sweeps",
        "the Pallas entry point of K11; its Hopper kernel's wrapper"),
    "ops.icm_pallas.encoding_ils_pallas": (
        "ops.icm.encoding_ils",
        "the Pallas entry point of K12; its Hopper kernel's wrapper"),
    "ops.icm_pallas.pallas_icm_available": (
        "ops.icm.icm_kernel_takes",
        "whether Mosaic compiles the TPU kernel; the card's routing asks "
        "the kernel's layout"),
    "ops.icm_pallas.pallas_icm_supported": (
        "ops.icm.icm_kernel_takes",
        "the TPU kernel's shape limits; the card's routing asks the "
        "kernel's layout"),
    "ops.viterbi_pallas.viterbi_encode_pallas": (
        "ops.viterbi.viterbi_encode",
        "the Pallas entry point of K13; `viterbi_encode(impl=...)` routes "
        "to its Hopper kernel"),
    "search.scan_codes_pallas.pallas_scan_codes_decode_topk": (
        "search.scan_codes.scan_codes_decode_topk",
        "the Pallas entry point of K4 / K14 (one-pass decode scan)"),
    "search.scan_codes_pallas.pallas_scan_codes_decode_topk_2p": (
        "search.scan_codes.scan_codes_decode_topk_2p",
        "the Pallas entry point of K1 → K2 (two-pass decode scan)"),
    "search.scan_codes_pallas.pallas_scan_codes_topk": (
        "search.scan_codes.scan_codes_topk",
        "the Pallas entry point of K5 / K6 (the LUT scans)"),
    "search.scan_codes_pallas.xla_lut_scan": (
        "search.scan_codes.lut_scan",
        "the XLA LUT oracle; the port's plain LUT scan"),
    "search.scan_pallas.pallas_scan_topk": (
        "search.scan.scan_topk_packed",
        "the Pallas entry point of K8 (``pack=True``; ``pack=False`` is "
        "`scan_topk_f32`, K9 / K10)"),
}


def _public_functions(mod):
    for name, obj in vars(mod).items():
        if (not name.startswith("_") and callable(obj)
                and not inspect.isclass(obj)
                and getattr(obj, "__module__", None) == mod.__name__):
            yield name, obj


def _twin_module(path):
    return importlib.import_module(
        "rayuela_tpu_torch." + TWIN_MODULES.get(path, path))


def _keyword_gaps(path):
    """``[(function, keyword)]`` of the JAX module ``path`` that its twin
    does not take, and ``[function]`` without a twin of its name."""
    jmod = importlib.import_module(f"rayuela_tpu.{path}")
    tmod = _twin_module(path)
    gaps, lone = [], []
    for name, fn in _public_functions(jmod):
        twin = getattr(tmod, name, None)
        if twin is None:
            lone.append(name)
            continue
        tp = inspect.signature(twin).parameters
        if any(p.kind == p.VAR_KEYWORD for p in tp.values()):
            continue
        for kw, p in inspect.signature(fn).parameters.items():
            if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or kw in tp:
                continue
            gaps.append((name, kw))
    return gaps, lone


@pytest.mark.parametrize("path", JAX_MODULES)
def test_every_jax_keyword_is_a_twin_keyword_or_documented(path):
    """Each public function's keywords are its twin's but for those of
    `KEYWORD_DIFFS`; a function without a twin stands in `NO_TWIN`, its
    counterpart a callable of the port."""
    gaps, lone = _keyword_gaps(path)
    undocumented = [g for g in gaps if g[1] not in KEYWORD_DIFFS]
    assert not undocumented, undocumented
    for name in lone:
        assert f"{path}.{name}" in NO_TWIN, f"{path}.{name} has no twin"
        where, reason = NO_TWIN[f"{path}.{name}"]
        mod, fn = where.rsplit(".", 1)
        assert callable(getattr(
            importlib.import_module(f"rayuela_tpu_torch.{mod}"), fn))
        assert reason


def test_keyword_differences_are_current():
    """Every entry of `KEYWORD_DIFFS` and `NO_TWIN` is one that the sweep
    still finds, and states its reason: a keyword the port comes to take
    leaves the table."""
    used, lone = set(), set()
    for path in JAX_MODULES:
        gaps, names = _keyword_gaps(path)
        used |= {kw for _, kw in gaps}
        lone |= {f"{path}.{n}" for n in names}
    assert set(KEYWORD_DIFFS) == used
    assert set(NO_TWIN) == lone
    assert all(len(r) > 20 for r in KEYWORD_DIFFS.values())
    assert all(len(r) > 20 for _, r in NO_TWIN.values())


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
