"""The multi-GPU layer of `rayuela_tpu_torch` (`parallel`) on the CPU: the
port runs as 4 gloo ranks (``data`` = 4 for search and training, a (2, 2)
mesh for the PQ Lloyd step), all its checks in one spawn per module
(`tests/torch_parallel_worker.py`), each check then a test of its own.
The results are held against the JAX package's `rayuela_tpu.parallel` on
the suite's 8-device CPU mesh (``make_mesh(4, 2)``) with
`tests/test_parallel.py`'s tolerances, and against the port's
single-process calls. Every rank's codebooks must be bit-identical.

The three spawns (the checks, the two-process bootstrap, the dry run)
start together when the module does and run while this process computes
the JAX package's results. They use file stores under temporary
directories (never a fixed port), a 60 s process-group timeout and a
join timeout (120 s; 300 s for the checks, whose ranks also train every
method: ~30 s alone, several times that beside the suite's other
workers), so a hang fails a test instead of running the suite's clock
out."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.parallel import chainq_sharded as jcq
from rayuela_tpu.parallel import lsq_sharded as jlsq
from rayuela_tpu.parallel import mesh as jmesh
from rayuela_tpu_torch import api
from rayuela_tpu_torch import parallel as tpar
from rayuela_tpu_torch.models.chainq import train_chainq
from rayuela_tpu_torch.models.lsq import train_lsq
from rayuela_tpu_torch.models.opq import train_opq
from rayuela_tpu_torch.models.rvq import train_rvq
from rayuela_tpu_torch.ops.codebook_update import (_solve_direct,
                                                   codebook_stats)
from rayuela_tpu_torch.ops.kmeans import assign, update_centers
from rayuela_tpu_torch.ops.qerror import qerror
from rayuela_tpu_torch.ops.viterbi import viterbi_encode
from rayuela_tpu_torch.parallel import dryrun
from rayuela_tpu_torch.search import scan, scan_codes
from rayuela_tpu_torch.search.linscan import exact_rescan, scan_topk
from tests import torch_parallel_worker as worker
from tests.torch_parity import assert_close_topk

WORLD = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lut_brute(T, B):
    """Float64 LUT sums ``(nq, n)``."""
    T = np.asarray(T, np.float64)
    return sum(T[j, B[:, j], :].T for j in range(T.shape[0]))


def _pq_data(rng, d, n, m, h):
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((m, h, d // m)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    return X, C, B


def _make_data():
    rng = np.random.default_rng(2024)
    g = {}
    X, C, B = _pq_data(rng, 16, 3001, 4, 16)         # ragged vs 4 shards
    g.update(scan_C=rng.standard_normal((4, 16, 16)).astype(np.float32),
             scan_B=B, scan_Q=rng.standard_normal((9, 16)).astype(
                 np.float32))
    # ragged vs 4 shards; not the n of `tests/test_parallel.py`'s codes
    # search, which counts its own miss of the JAX package's jit cache
    _, C, B = _pq_data(rng, 16, 2129, 4, 16)
    Q = rng.standard_normal((6, 16)).astype(np.float32)
    T = scan_codes.build_luts(_t(C), _t(Q), pq=True, d=16)
    g.update(codes_C=C, codes_B=B, codes_Q=Q, codes_T=T.numpy(),
             codes_packed=scan_codes.pack_codes(_t(B)).numpy())
    g.update(dec_Xd=rng.standard_normal((2111, 16)).astype(np.float32),
             dec_Q=rng.standard_normal((6, 16)).astype(np.float32))
    g.update(stats_X=rng.standard_normal((800, 12)).astype(np.float32),
             stats_B=rng.integers(0, 8, (800, 3)).astype(np.int32))
    g.update(step_X=rng.standard_normal((640, 16)).astype(np.float32),
             step_B=rng.integers(0, 8, (640, 3)).astype(np.int32))
    g.update(lloyd_X=rng.standard_normal((2, 512, 8)).astype(np.float32),
             lloyd_C=rng.standard_normal((2, 8, 8)).astype(np.float32))
    g.update(h2g_sizes=[700, 1100, 1000, 1296],
             h2g_B=rng.integers(0, 16, (4096, 4)).astype(np.int32),
             h2g_C=rng.standard_normal((4, 16, 32)).astype(np.float32),
             h2g_Q=rng.standard_normal((8, 32)).astype(np.float32))
    g.update(vit_X=rng.standard_normal((1013, 12)).astype(np.float32),
             vit_C=(rng.standard_normal((3, 8, 12)) * 0.3).astype(
                 np.float32))
    for key, n, niter in (("cq", 1000, 3), ("cq_ragged", 997, 2)):
        g.update({f"{key}_X": rng.standard_normal((n, 12)).astype(
            np.float32), f"{key}_B": rng.integers(0, 8, (n, 3)).astype(
                np.int32), f"{key}_niter": niter})
    g.update(lsq_X=rng.standard_normal((1000, 12)).astype(np.float32),
             lsq_B=rng.integers(0, 8, (1000, 3)).astype(np.int32))
    g.update(icm_X=rng.standard_normal((517, 12)).astype(np.float32),
             icm_C=(rng.standard_normal((3, 8, 12)) * 0.3).astype(
                 np.float32),
             icm_B=rng.integers(0, 8, (517, 3)).astype(np.int32))
    g.update(api_Xt=rng.standard_normal((600, 16)).astype(np.float32),
             api_Xb=rng.standard_normal((2000, 16)).astype(np.float32),
             api_Q=rng.standard_normal((7, 16)).astype(np.float32),
             api_train_X=rng.standard_normal((1000, 12)).astype(
                 np.float32))
    tie = rng.standard_normal((16384, 16)).astype(np.float32)
    v = rng.standard_normal((16,)).astype(np.float32) * 3.0
    tie[np.arange(24) * 128] = v
    tq = rng.standard_normal((4, 16)).astype(np.float32)
    tq[0] = v
    g.update(tie_Xb=tie, tie_Q=tq)
    _, C, B = _pq_data(rng, 16, 5000, 4, 16)
    Q = rng.standard_normal((6, 16)).astype(np.float32)
    g.update(seg_C=C, seg_B=B, seg_Q=Q,
             seg_T=scan_codes.build_luts(_t(C), _t(Q), pq=True,
                                         d=16).numpy(),
             seg_packed=scan_codes.pack_codes(_t(B)).numpy(),
             segd_Xd=rng.standard_normal((5000, 32)).astype(np.float32),
             segd_Q=rng.standard_normal((6, 32)).astype(np.float32))
    # the data-parallel trainers: a Lloyd step whose last 4 centres lie
    # far from every row (their clusters empty), an OPQ step, ERVQ and
    # CompQ from a port-trained RVQ init, the seeding's weights; the
    # stochastic trainings take the data of the meshless comparison
    # (`test_torch_ervq_compq.py::test_train_ervq_from_scratch_matches_jax_error`)
    X = rng.standard_normal((401, 8)).astype(np.float32)
    C = np.concatenate([X[rng.choice(401, 8, replace=False)],
                        50.0 + rng.standard_normal((4, 8))]).astype(
                            np.float32)
    g.update(dp_lloyd_X=X, dp_lloyd_C=C,
             dp_opq_X=rng.standard_normal((400, 16)).astype(np.float32))
    X = _clustered(rng, 800, 12)
    model, B, _ = train_rvq(torch.Generator().manual_seed(0), _t(X), 3, 16,
                            niter=4)
    g.update(dp_X=X, dp_B0=B.numpy(), dp_C0=model.codebooks.numpy(),
             dp_w=rng.uniform(0.05, 2.0, 37).astype(np.float32),
             dp_npicks=2400,
             dp_st_X=_clustered(np.random.default_rng(0), 2000, 16))
    return g


def _clustered(rng, n, d, ncenters=24):
    cent = rng.standard_normal((ncenters, d)).astype(np.float32) * 2
    return (cent[rng.integers(0, ncenters, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)


def _two_hosts_data():
    rng = np.random.default_rng(7)
    n, m, h, d, nq = 4096, 4, 16, 32, 8
    return dict(C=rng.standard_normal((m, h, d), dtype=np.float32),
                B=rng.integers(0, h, size=(n, m)).astype(np.int32),
                Q=rng.standard_normal((nq, d), dtype=np.float32))


@pytest.fixture(scope="module")
def data():
    return _make_data()


@pytest.fixture(scope="module")
def spawned(data):
    """The module's three spawns, started together: every rank's
    results of the checks (4 gloo ranks), of the two-process bootstrap,
    and rank 0's summary of `dryrun_multichip(4)`."""
    pool = ThreadPoolExecutor(3)
    futs = dict(
        checks=pool.submit(dryrun.run_ranks, worker.run_checks, WORLD,
                           (data,), timeout=300.0, pg_timeout=60.0),
        two_hosts=pool.submit(dryrun.run_ranks, worker.run_two_hosts, 2,
                              (_two_hosts_data(),), timeout=120.0),
        dryrun=pool.submit(dryrun.dryrun_multichip, 4))
    yield futs
    pool.shutdown(wait=True)


def _jax_refs(data):
    """The JAX package's sharded results on the 8-device mesh."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rayuela_tpu.ops.codebook_update import codebook_stats as jstats
    if len(jax.devices()) < 8:
        pytest.fail("the suite's 8 virtual CPU devices are missing")
    jm = jmesh.make_mesh(4, 2)
    a = {k: jnp.asarray(v) for k, v in data.items()
         if isinstance(v, np.ndarray)}
    ref = {}
    ref["scan"] = jmesh.sharded_scan_topk(jm, a["scan_Q"], a["scan_C"],
                                          a["scan_B"], k=20, tile=512)
    ref["codes"] = jmesh.sharded_search_codes(
        jm, a["codes_T"], a["codes_packed"], k=15, r=16, bq=8, tile=2048,
        lut_dtype=jnp.float32, interpret=True)
    ref["decode"] = jmesh.sharded_search_codes_decode(
        jm, a["codes_Q"], a["codes_C"], a["codes_packed"], k=15, pq=True,
        d=16, r=28, bq=8, tile=1024, keep=4, op_dtype=jnp.float32,
        interpret=True)
    x2 = jnp.sum(a["dec_Xd"] ** 2, -1)
    ref["decoded"] = jmesh.sharded_search(jm, a["dec_Xd"], x2, a["dec_Q"],
                                          k=15, r=16, bq=8, tile=2048,
                                          interpret=True)

    def local(X, B):
        G, F = jstats(X, B, 8, chunk=128)
        return jax.lax.psum(G, "data"), jax.lax.psum(F, "data")

    ref["stats"] = jax.jit(shard_map(
        local, mesh=jm, in_specs=(P("data", None), P("data", None)),
        out_specs=(P(), P()), check_vma=False))(a["stats_X"], a["stats_B"])
    step = jlsq.make_sr_train_step(jm, h=8, niter=4, ilsiter=2, icmiter=2,
                                   npert=1, method="LSQ", chunk=64,
                                   stats_chunk=128)
    ref["step_C"] = step(jmesh.shard_data(jm, a["step_X"]),
                         jmesh.shard_data(jm, a["step_B"]),
                         jnp.zeros((3, 8, 16), jnp.float32), jnp.int32(0),
                         jax.random.PRNGKey(0))[0]
    ref["lloyd"] = jmesh.pq_lloyd_step_sharded(
        jax.device_put(a["lloyd_X"], NamedSharding(jm, P("model", "data",
                                                         None))),
        jax.device_put(a["lloyd_C"], NamedSharding(jm, P("model", None,
                                                         None))), 8)
    ref["viterbi"] = jcq.sharded_viterbi_encode(jm, a["vit_X"], a["vit_C"])
    ref["cq"] = jcq.train_chainq_sharded(jm, data["cq_X"], data["cq_B"],
                                         jnp.eye(12), h=8,
                                         niter=data["cq_niter"])
    ref["lsq_obj"] = jlsq.train_lsq_family_sharded(
        jm, jax.random.PRNGKey(0), data["lsq_X"], data["lsq_B"],
        jnp.eye(12), h=8, niter=3, ilsiter=2, icmiter=2, npert=1,
        method="LSQ", chunk=256)[2]
    _jax_train_refs(jm, a, ref)
    return jax.tree_util.tree_map(np.asarray, ref)


def _jax_train_refs(jm, a, ref):
    """The JAX package's k-means step and trainers on ``Xt`` sharded over
    its ``data`` axis (GSPMD places the collectives)."""
    from rayuela_tpu import api as japi
    from rayuela_tpu.models import compq as jcompq
    from rayuela_tpu.models import ervq as jervq
    from rayuela_tpu.ops import kmeans as jkm

    ref["dp_lloyd"] = jkm._lloyd_step(a["dp_lloyd_X"], a["dp_lloyd_C"])[0]
    X = jmesh.shard_data(jm, a["dp_X"])
    ref["dp_ervq"] = jervq.train_ervq(X, a["dp_B0"], a["dp_C0"], niter=3)
    for update in ("sgd", "lsq"):
        ref[f"dp_compq_{update}"] = jcompq.train_compq(
            X, a["dp_C0"], a["dp_B0"], niter=4, H=4, chunk=512,
            update=update)
    st = {}
    for method, m in worker.STOCHASTIC:
        for seed in worker.SEEDS:
            mdl = japi.train(a["dp_st_X"], method=method, m=m, h=16, niter=4,
                             key=jax.random.PRNGKey(seed), mesh=jm,
                             **({"H": 4} if method == "compq" else {}))
            st[(method, seed)] = dict(C=mdl.codebooks, B=mdl.train_codes,
                                      R=mdl.R)
    ref["dp_stochastic"] = st


@pytest.fixture(scope="module")
def jref(data, spawned):
    """Computed while the spawned ranks run."""
    return _jax_refs(data)


@pytest.fixture(scope="module")
def ranks(spawned, jref):
    """Every rank's results of the checks."""
    return spawned["checks"].result()


@pytest.fixture(scope="module")
def out(ranks):
    return ranks[0]


def _same_on_every_rank(ranks, get):
    first = get(ranks[0])
    for r in ranks[1:]:
        other = get(r)
        if isinstance(first, list):
            for a, b in zip(first, other):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(first, other)


# ---------------------------------------------------------------------------
# The mesh and the bootstrap
# ---------------------------------------------------------------------------

def test_mesh_coordinates_and_one_rank_fallbacks(ranks):
    assert [r["coords"][0]["data"] for r in ranks] == [0, 1, 2, 3]
    assert sorted((r["coords"][1]["data"], r["coords"][1]["model"])
                  for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # no launcher here: initialize() does nothing, the meshes are one rank
    assert tpar.initialize() is False
    m = tpar.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.group("data") is None
    assert tpar.global_mesh(device="cpu").shape == m.shape
    with pytest.raises(ValueError, match="process group"):
        tpar.make_mesh(2, 1, device="cpu")
    x = torch.arange(10.0)
    p, n = jmesh.pad_to_multiple(jnp.asarray(x.numpy()), 4)
    tp, tn = tpar.mesh.pad_to_multiple(x, 4, fill=-1)
    assert tn == n == 10 and tp.shape == p.shape == (12,)
    assert tp[-1] == -1 and tpar.replicate(m, x).device.type == "cpu"


def test_host_local_to_global_uneven_shares(ranks, data):
    sizes = data["h2g_sizes"]
    for r, res in enumerate(ranks):
        h = res["h2g"]
        assert (h["start"], h["n"], h["rows"]) == (sum(sizes[:r]), 4096,
                                                    sizes[r])
        assert res["global_mesh"] == {"data": 2, "model": 2}
    d, i = scan_topk(_t(data["h2g_Q"]), _t(data["h2g_C"]),
                     _t(data["h2g_B"]), k=10)
    np.testing.assert_array_equal(ranks[0]["h2g"]["scan"][1], i.numpy())
    np.testing.assert_allclose(ranks[0]["h2g"]["scan"][0], d.numpy(),
                               rtol=1e-5, atol=1e-4)


def test_two_process_host_local_to_global_scan(spawned, jref):
    """Two ranks, each passing only its half of the codes (the JAX
    package's two-process test), against a numpy brute force."""
    g = _two_hosts_data()
    C, B, Q = g["C"], g["B"], g["Q"]
    (n, m), k = B.shape, 10
    res = spawned["two_hosts"].result()
    Xhat = C[np.arange(m), B].sum(axis=1)
    full = ((Q[:, None, :] - Xhat[None]) ** 2).sum(-1)
    ref_ids = np.argsort(full, axis=1, kind="stable")[:, :k]
    ref_d = np.take_along_axis(full, ref_ids, axis=1)
    for r, out in enumerate(res):
        assert (out["n"], out["start"]) == (n, r * n // 2)
        np.testing.assert_allclose(out["d"], ref_d, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(out["i"], ref_ids)


def test_dryrun_multichip_on_four_ranks(spawned, jref):
    res = spawned["dryrun"].result()
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["solve_rel"] < 1e-3
    fn, args = dryrun.entry(device="cpu")
    d, i = fn(*args)
    assert d.shape == i.shape == (32, 100) and bool(torch.isfinite(d).all())


# ---------------------------------------------------------------------------
# The sharded searches
# ---------------------------------------------------------------------------

def test_sharded_scan_matches_local(out, data, jref):
    Q, C, B = data["scan_Q"], data["scan_C"], data["scan_B"]
    d_ref, i_ref = scan_topk(_t(Q), _t(C), _t(B), k=20, tile=512)
    np.testing.assert_array_equal(out["scan"][1], i_ref.numpy())
    np.testing.assert_allclose(out["scan"][0], d_ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    dj, ij = jref["scan"]
    np.testing.assert_array_equal(out["scan"][1], np.asarray(ij))
    np.testing.assert_allclose(out["scan"][0], np.asarray(dj), rtol=1e-4,
                               atol=1e-4)


def test_sharded_codes_search_matches_local(out, data, jref):
    """The LUT form (K5 → K2 → K3 on each rank) against the float64 LUT
    sums, the JAX package's sharded search and the single-device scan
    of the whole base. A query may be flagged (its certificate: more of
    the top-k in one (lane, tile) than the plan's keep = 2); the facade
    rescues those, so the comparison holds on the others."""
    T, B = data["codes_T"], data["codes_B"]
    s, i, fl = out["codes"]
    ok = ~fl
    assert ok.sum() >= 4
    s64 = _lut_brute(T, B)
    ref = np.sort(s64, 1)[:, :15]
    np.testing.assert_allclose(s[ok], ref[ok], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.take_along_axis(s64, i.astype(np.int64),
                                                  1)[ok], s[ok], rtol=1e-4,
                               atol=1e-3)
    sj, ij, flj = jref["codes"]
    both = ok & ~np.asarray(flj)
    assert both.sum() >= 4
    np.testing.assert_allclose(s[both], np.asarray(sj)[both], rtol=1e-4,
                               atol=1e-3)
    # the single-device packed LUT scan of the whole base: one step
    ss, si, sf = scan_codes.scan_codes_topk(
        _t(T), _t(data["codes_packed"]), k=15, r=16, tile=2048, keep=2,
        lut_dtype=torch.float32)
    both = ok & ~sf.numpy()
    idbits = scan._pack_idbits(2048)
    assert_close_topk(s[both], i[both], ss.numpy()[both], si.numpy()[both],
                      idbits, atol=1e-4)


def test_sharded_codes_search_pack_false_is_exact(out, data):
    """``pack=False``: the exact top-k of the f32 table sums, identical
    ids to the single-device exact-float LUT scan."""
    s, i, fl = out["codes_f32"]
    assert not fl.any()
    v, ids = scan_codes.lut_scan(_t(data["codes_T"]), _t(data["codes_B"]),
                                 15)
    np.testing.assert_array_equal(i, ids.numpy())
    np.testing.assert_array_equal(s, v.numpy())


@pytest.mark.parametrize("form", ["decode", "decode_qsuper"])
def test_sharded_codes_decode_search_matches_local(out, data, jref, form):
    T, B = data["codes_T"], data["codes_B"]
    s, i, fl = out[form]
    assert not fl.any()
    s64 = _lut_brute(T, B)
    np.testing.assert_allclose(s, np.sort(s64, 1)[:, :15], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(np.take_along_axis(s64, i.astype(np.int64),
                                                  1), s, rtol=1e-4,
                               atol=1e-3)
    if form == "decode":
        sj, _, flj = jref["decode"]
        assert not np.asarray(flj).any()
        np.testing.assert_allclose(s, np.asarray(sj), rtol=1e-4, atol=1e-3)


def test_sharded_pallas_search_matches_local(out, data, jref):
    """The decoded form (K8 → K2 → K3 on each rank) against the exact
    scan and the JAX package's sharded search on the queries no
    certificate flags; `sharded_search_exact` rescues the others, so its
    result is the exact scan's on every query."""
    Xd, Q = data["dec_Xd"], data["dec_Q"]
    x2 = (Xd * Xd).sum(-1)
    d_ref, i_ref = exact_rescan(_t(Q), _t(Xd), _t(x2), 15)
    d, i, fl = out["decoded"]
    ok = ~fl
    assert ok.sum() >= 4
    np.testing.assert_array_equal(i[ok], i_ref.numpy()[ok])
    np.testing.assert_allclose(d[ok], d_ref.numpy()[ok], rtol=1e-4,
                               atol=1e-3)
    dj, ij, flj = jref["decoded"]
    both = ok & ~np.asarray(flj)
    assert both.sum() >= 4
    np.testing.assert_array_equal(i[both], np.asarray(ij)[both])
    np.testing.assert_allclose(d[both], np.asarray(dj)[both], rtol=1e-4,
                               atol=1e-3)
    de, ie = out["decoded_exact"]
    np.testing.assert_array_equal(ie, i_ref.numpy())
    np.testing.assert_allclose(de, d_ref.numpy(), rtol=1e-4, atol=1e-3)
    # pack=False: identical to the single-device exact-float search
    df, if_, flf = out["decoded_f32"]
    assert not flf.any()
    ix = scan.LinscanIndex(_t(Xd), _t(x2))
    sd, si = scan.search(ix, _t(Q), 15, pack=False)
    np.testing.assert_array_equal(if_, si.numpy())
    np.testing.assert_allclose(df, sd.numpy(), rtol=1e-6, atol=1e-5)


def test_sharded_codes_search_segments_big_shards(out, data):
    T, B = data["seg_T"], data["seg_B"]
    s64 = _lut_brute(T, B)
    ref = np.sort(s64, 1)[:, :15]
    for key in ("seg_codes", "seg_decode"):
        s, i, fl = out[key]
        assert not fl.any(), key
        np.testing.assert_allclose(s, ref, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(
            np.take_along_axis(s64, i.astype(np.int64), 1), s, rtol=1e-4,
            atol=1e-3)


def test_sharded_decoded_search_segments_big_shards(out, data):
    Xd, Q = data["segd_Xd"], data["segd_Q"]
    d1, _, d2, i2 = out["seg_decoded"]
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)
    D = ((Q[:, None, :] - Xd[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d2, np.sort(D, 1)[:, :15], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(np.take_along_axis(D, i2.astype(np.int64),
                                                  1), d2, rtol=1e-4,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# Statistics, steps, training, encoders
# ---------------------------------------------------------------------------

def test_sharded_stats_match_single_device(ranks, data, jref):
    X, B = data["stats_X"], data["stats_B"]
    G, F = codebook_stats(_t(X), _t(B), 8, chunk=128)
    Gs, Fs = ranks[0]["stats"]
    np.testing.assert_array_equal(Gs, G.numpy())
    np.testing.assert_allclose(Fs, F.numpy(), rtol=1e-4, atol=1e-3)
    Gj, Fj = jref["stats"]
    np.testing.assert_allclose(Gs, np.asarray(Gj), atol=1e-4)
    np.testing.assert_allclose(Fs, np.asarray(Fj), rtol=1e-4, atol=1e-3)
    _same_on_every_rank(ranks, lambda r: r["stats"])


def test_sharded_sr_step_improves_and_matches_codebooks(ranks, data, jref):
    X, B = data["step_X"], data["step_B"]
    st = ranks[0]["step"]
    C_ref = _solve_direct(*codebook_stats(_t(X), _t(B), 8, chunk=128), 8,
                          1e-4)
    np.testing.assert_allclose(st["C"], C_ref.numpy(), atol=5e-2)
    e_sh = float(qerror(_t(X), _t(st["C"]), _t(B)))
    e_ref = float(qerror(_t(X), C_ref, _t(B)))
    assert abs(e_sh - e_ref) / e_ref < 1e-3
    assert st["obj"] <= e_sh + 1e-4            # the encode improved on it
    np.testing.assert_allclose(st["C"], jref["step_C"], atol=5e-2)
    # every rank holds the same bits: the LSQ solve and SR-D's draws
    _same_on_every_rank(ranks, lambda r: [r["step"]["C"], r["step_srd_C"],
                                          r["step"]["B"]])


def test_pq_lloyd_sharded_matches_unsharded(ranks, data, jref):
    Xs, cent = data["lloyd_X"], data["lloyd_C"]
    ref = []
    for i in range(2):
        a, mind2 = assign(_t(Xs[i]), _t(cent[i]))
        ref.append(update_centers(_t(Xs[i]), a, 8, _t(cent[i]),
                                  costs=mind2).numpy())
    new_c, obj = ranks[0]["lloyd"]
    np.testing.assert_allclose(new_c, np.stack(ref), rtol=1e-4, atol=1e-4)
    jc, jobj = jref["lloyd"]
    np.testing.assert_allclose(new_c, np.asarray(jc), rtol=1e-4, atol=1e-4)
    assert float(obj) == pytest.approx(float(jobj), rel=1e-5)
    _same_on_every_rank(ranks, lambda r: r["lloyd"])


def test_sharded_viterbi_matches_single(out, data, jref):
    X, C = data["vit_X"], data["vit_C"]
    ref = viterbi_encode(_t(X), _t(C)).numpy()
    np.testing.assert_array_equal(out["viterbi"], ref)
    np.testing.assert_array_equal(out["viterbi"], jref["viterbi"])


@pytest.mark.parametrize("key", ["cq", "cq_ragged"])
def test_train_chainq_sharded_matches_single(ranks, data, jref, key):
    X, B0, niter = data[f"{key}_X"], data[f"{key}_B"], data[f"{key}_niter"]
    got = ranks[0][key]
    mref, Bref, oref = train_chainq(_t(X), _t(B0), torch.eye(12), h=8,
                                    niter=niter)
    assert got["B"].shape == B0.shape
    np.testing.assert_allclose(got["obj"], oref.numpy(), rtol=1e-3)
    assert (got["B"] == Bref.numpy()).mean() > 0.95
    np.testing.assert_allclose(got["R"], mref.R.numpy(), atol=1e-3)
    if key == "cq":
        mj, Bj, oj = jref["cq"]
        np.testing.assert_allclose(got["obj"], np.asarray(oj), rtol=1e-3)
        assert (got["B"] == np.asarray(Bj)).mean() > 0.95
        np.testing.assert_allclose(got["R"], np.asarray(mj.R), atol=1e-3)
    _same_on_every_rank(ranks, lambda r: [r[key]["C"], r[key]["R"]])


def test_train_lsq_family_sharded_improves(ranks, data, jref):
    X, B0 = data["lsq_X"], data["lsq_B"]
    lsq = ranks[0]["lsq"]
    _, _, oref = train_lsq(torch.Generator().manual_seed(0), _t(X), _t(B0),
                           torch.eye(12), h=8, niter=3, ilsiter=2,
                           icmiter=2, npert=1)
    osh = lsq["LSQ"]["obj"]
    assert lsq["LSQ"]["B"].shape == B0.shape and osh.shape == (4,)
    assert osh[-1] <= osh[0] + 1e-5
    assert abs(osh[-1] - float(oref[-1])) / float(oref[-1]) < 0.2
    oj = jref["lsq_obj"]
    assert abs(osh[-1] - float(oj[-1])) / float(oj[-1]) < 0.2
    for method in ("SR_D", "SR_C"):
        assert np.isfinite(lsq[method]["obj"]).all()
        assert lsq[method]["B"].shape == B0.shape
    _same_on_every_rank(ranks, lambda r: [r["lsq"][m]["C"]
                                          for m in ("LSQ", "SR_D", "SR_C")])


def test_sharded_encoding_icm_matches_budget(out, data):
    X, C, B0 = data["icm_X"], data["icm_C"], data["icm_B"]
    assert out["icm"].shape == B0.shape
    assert float(qerror(_t(X), _t(C), _t(out["icm"]))) \
        <= float(qerror(_t(X), _t(C), _t(B0))) + 1e-5


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

def test_api_search_with_mesh_matches_single(out, data):
    d1, i1, d2, i2 = out["api_decoded"]
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)
    Q, Xd, x2 = data["api_Q"], out["api_decoded_Xd"], out["api_decoded_x2"]
    D = -2.0 * Q @ Xd.T + x2[None] + (Q ** 2).sum(-1, keepdims=True)
    np.testing.assert_allclose(np.take_along_axis(D, i2.astype(np.int64),
                                                  1), d2, rtol=1e-4,
                               atol=1e-3)


def test_api_search_codes_with_mesh_matches_single(out):
    d1, i1, d2, i2 = out["api_codes"]
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(i2, i1)


def test_api_search_codes_mesh_flagged_rescue_is_tiled(out):
    res = out["api_rescue"]
    assert res["flagged"], "the tie-saturated base did not flag"
    assert res["seen"] and max(res["seen"]) <= 16384 // WORLD
    np.testing.assert_allclose(res["s"], res["ref"], rtol=1e-4, atol=1e-3)


def test_api_train_with_mesh_matches_without(out):
    t = out["api_train"]
    assert t["cb"][0] == t["cb"][1]
    assert (t["got"] == t["ref"]).mean() > 0.9
    assert t["lsq"] == ((3, 8, 12), (1000, 3))


def test_drivers_mesh_encode_the_base_on_each_ranks_rows(ranks):
    """The drivers under ``mesh=`` on 4 ranks: ChainQ's and SR-D's base
    encodes run on each rank's rows and are all-gathered, the same codes
    on every rank; ChainQ's base codes agree with the meshless run's on
    more than 95% (the training differs by the reduction order), SR-D's
    base error is within 20% of the meshless one, and the all-reduced
    base error is the error of the gathered codes."""
    from rayuela_tpu_torch.experiments.datasets import make_synthetic
    ref = worker.driver_runs()
    Xb = torch.as_tensor(make_synthetic(**worker.DRIVER_DATA).Xb)
    for name in ("chainq", "sr_d"):
        _same_on_every_rank(ranks, lambda o: o["drivers"][name]["B_base"])
        got = ranks[0]["drivers"][name]
        assert got["B_base"].shape == ref[name]["B_base"].shape == (1003, 3)
        assert np.isfinite(got["train_error"])
    cq = ranks[0]["drivers"]["chainq"]
    assert (cq["B_base"] == ref["chainq"]["B_base"]).mean() > 0.95
    sr = ranks[0]["drivers"]["sr_d"]
    assert sr["base_error"] <= 1.2 * ref["sr_d"]["base_error"]
    err = float(qerror(Xb, _t(sr["C"]), _t(sr["B_base"])))
    np.testing.assert_allclose(sr["base_error"], err, rtol=1e-5)


# ---------------------------------------------------------------------------
# Data-parallel training of PQ, OPQ, RVQ, ERVQ, CompQ (and the k-means,
# the seeding, OPQ's rotation step, the facade and the drivers under it)
# ---------------------------------------------------------------------------

def _train_error(X, method, C, B, R=None):
    """Float64 mean squared error of a trained model on ``X``."""
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    B = np.asarray(B)
    if method in ("pq", "opq"):
        X = X if R is None else X @ np.asarray(R, np.float64)
        Xh = np.concatenate([C[j][B[:, j]] for j in range(C.shape[0])], 1)
    else:
        Xh = sum(C[j][B[:, j]] for j in range(C.shape[0]))
    return float(((X - Xh[:, :X.shape[1]]) ** 2).sum(1).mean())


def test_sharded_lloyd_step_repicks_like_jax(ranks, data, jref):
    """One Lloyd step on 4 ranks' rows (401, ragged) with 4 clusters
    empty: the centres equal the JAX package's `_lloyd_step` to 1e-5,
    the empty ones take the same rows, which lie on several ranks; to
    the reduction order, the centres are the meshless step's."""
    X, C0 = data["dp_lloyd_X"], data["dp_lloyd_C"]
    got = ranks[0]["dp_lloyd"]
    ref = np.asarray(jref["dp_lloyd"])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    a, mind2 = assign(_t(X), _t(C0))
    meshless = update_centers(_t(X), a, 12, _t(C0), costs=mind2).numpy()
    np.testing.assert_allclose(got, meshless, rtol=1e-5, atol=1e-5)
    empty = np.bincount(a.numpy(), minlength=12) == 0
    assert empty.sum() == 4
    rows = [int(np.flatnonzero((X == c).all(1))[0]) for c in got[empty]]
    np.testing.assert_array_equal(got[empty], ref[empty])
    owners = {r // 101 if r < 101 else 1 + (r - 101) // 100 for r in rows}
    assert len(owners) >= 2, rows
    _same_on_every_rank(ranks, lambda r: r["dp_lloyd"])


def test_sharded_opq_rotation_step_matches_meshless(ranks, data):
    """One OPQ iteration on 4 ranks against the meshless port's from the
    same (X, C, B) (the same seed draws the same init rows): R to
    1e-5."""
    got = ranks[0]["dp_opq"]
    model, _, obj = train_opq(torch.Generator().manual_seed(3),
                              _t(data["dp_opq_X"]), 4, 8, niter=1)
    np.testing.assert_allclose(got["R"], model.R.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["C"], model.codebooks.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["obj"], obj.numpy(), rtol=1e-5)
    _same_on_every_rank(ranks, lambda r: [r["dp_opq"]["R"],
                                          r["dp_opq"]["C"]])


def test_train_ervq_sharded_matches_jax(ranks, data, jref):
    """ERVQ from the same (C0, B0) on 4 ranks against the JAX package's
    `train_ervq` on X sharded over its mesh: the error within 1e-5
    relative, >= 99% of codes equal (the meshless tolerances)."""
    got = ranks[0]["dp_ervq"]
    _, jB, je = jref["dp_ervq"]
    assert got["B"].shape == data["dp_B0"].shape
    assert abs(got["err"] - float(je)) <= 1e-5 * float(je)
    assert (got["B"] == np.asarray(jB)).mean() >= 0.99
    _same_on_every_rank(ranks, lambda r: [r["dp_ervq"]["C"],
                                          r["dp_ervq"]["B"]])


@pytest.mark.parametrize("update", ["sgd", "lsq"])
def test_train_compq_sharded_matches_jax(ranks, data, jref, update):
    """CompQ from the same (C0, B0) on 4 ranks against the JAX package's
    `train_compq` on X sharded over its mesh: ``obj`` within 1e-4
    relative, >= 99% of codes equal."""
    got = ranks[0][f"dp_compq_{update}"]
    _, jB, jo = jref[f"dp_compq_{update}"]
    np.testing.assert_allclose(got["obj"], np.asarray(jo), rtol=1e-4)
    assert (got["B"] == np.asarray(jB)).mean() >= 0.99
    _same_on_every_rank(ranks, lambda r: [r[f"dp_compq_{update}"]["C"],
                                          r[f"dp_compq_{update}"]["B"]])


@pytest.mark.parametrize("method,m", worker.STOCHASTIC)
def test_sharded_training_error_matches_jax(ranks, data, jref, method, m):
    """The trainers ``api.train(mesh=)`` runs, at its generator of each
    seed (ERVQ and CompQ from the seed's RVQ, as it trains them), on 4
    ranks against the JAX package's ``api.train(mesh=)`` on its 8
    devices and against the port's
    meshless ``api.train``, seeds 0-11 (threefry against Philox, and the
    sharded seeding's sampler against `torch.multinomial`) on the data
    of the meshless comparison with the JAX package: the mean train
    error within 5% of each mean; every rank holds the same codebooks
    (and R) and the global train codes."""
    X = data["dp_st_X"]
    kw = {"H": 4} if method == "compq" else {}
    got = [_train_error(X, method, **ranks[0]["dp_stochastic"][(method, s)])
           for s in worker.SEEDS]
    ref = [_train_error(X, method, **jref["dp_stochastic"][(method, s)])
           for s in worker.SEEDS]
    alone = []
    for s in worker.SEEDS:
        mdl = api.train(X, method=method, m=m, h=16, niter=4, seed=s,
                        device="cpu", **kw)
        alone.append(_train_error(X, method, mdl.codebooks.numpy(),
                                  mdl.train_codes.numpy(),
                                  None if mdl.R is None else mdl.R.numpy()))
    for other in (ref, alone):
        assert abs(np.mean(got) - np.mean(other)) <= 0.05 * np.mean(other), (
            got, ref, alone)
    for s in worker.SEEDS:
        assert ranks[0]["dp_stochastic"][(method, s)]["B"].shape == (2000, m)
        _same_on_every_rank(ranks, lambda r: [
            v for v in r["dp_stochastic"][(method, s)].values()
            if v is not None])


@pytest.mark.parametrize("layout", ["even", "empty rank"])
def test_kmeanspp_spread_draws_in_proportion(ranks, data, layout):
    """The seeding's draw over 4 ranks: 2,400 picks of 37 rows (spread
    evenly, or as 10 / 0 / 15 / 12) follow the weights (chi-square), the
    same rows on every rank, and a rank without rows is never picked
    (no pick comes back empty)."""
    from scipy.stats import chisquare
    picks = ranks[0]["dp_picks"][layout]
    assert picks.shape == (data["dp_npicks"],)
    assert (picks >= 1).all() and (picks <= 37).all()
    counts = np.bincount(picks.astype(np.int64) - 1, minlength=37)
    w = data["dp_w"].astype(np.float64)
    assert chisquare(counts, w / w.sum() * counts.sum()).pvalue > 1e-3
    _same_on_every_rank(ranks, lambda r: r["dp_picks"][layout])


def test_kmeans_sharded_with_an_empty_rank(ranks):
    """k-means over 37 rows spread as 10 / 0 / 15 / 12: the rank without
    rows runs every collective, and every rank ends with the same
    centres; the assignments come back as each rank's own."""
    sizes = (10, 0, 15, 12)
    for r, res in enumerate(ranks):
        assert res["dp_kmeans_empty_rank"]["a"].shape == (sizes[r],)
    assert np.isfinite(ranks[0]["dp_kmeans_empty_rank"]["obj"])
    _same_on_every_rank(ranks, lambda r: r["dp_kmeans_empty_rank"]["C"])


@pytest.mark.parametrize("method", ["pq", "opq", "rvq", "ervq", "compq",
                                    "chainq", "lsq", "sr_c", "sr_d"])
def test_api_train_on_each_ranks_own_rows(ranks, method):
    """``api.train(RowShard, mesh=)``: each rank passes only its rows
    (100 / 0 / 150 / 153 of 403) and gets the same codebooks (and R) and
    the global (403, 3) train codes."""
    got = ranks[0]["dp_api"][method]
    assert got["B"].shape == (403, 3) and got["B"].dtype == np.int32
    assert (got["R"] is not None) == (method in ("opq", "chainq"))
    assert np.isfinite(got["C"]).all()
    _same_on_every_rank(ranks, lambda r: [
        v for v in r["dp_api"][method].values() if v is not None])


@pytest.mark.parametrize("name", ["pq", "opq", "rvq", "ervq", "compq"])
def test_drivers_mesh_train_encode_and_search_on_each_ranks_rows(
        ranks, name):
    """The drivers' PQ, OPQ, RVQ, ERVQ and CompQ under ``mesh=`` on 4
    ranks: the same base codes on every rank, a finite train error, and
    recall@1 (the protocol's row) within 0.05 of the meshless run's."""
    ref = worker.driver_runs()[name]
    _same_on_every_rank(ranks, lambda o: o["drivers"][name]["B_base"])
    got = ranks[0]["drivers"][name]
    assert got["B_base"].shape == ref["B_base"].shape
    assert np.isfinite(got["train_error"])
    assert abs(got["recall"][0] - ref["recall"][0]) <= 0.05, (
        got["recall"], ref["recall"])
