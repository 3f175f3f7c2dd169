"""The port's windowed gather-reduce (ops/windowed.py), column gather
(ops/take_columns.py) and probes (probes.py) on the CPU, where each kernel
wrapper runs its plain version:

  - `plan_windows` gives tools.windowed_kernels' plan, array for array, and
    its cache returns the same object for the same index table; its column
    plan (what the CUDA kernel stages) names every reference, on the
    renumbered and on the unrenumbered mesh;
  - `slot_reduce_windowed` and `edge_pairs_windowed` match
    tools.windowed_kernels run with interpret=True on
    renumber_mesh(generate_mesh(levels=4)) at 1e-6 of the largest magnitude
    (float32; the bound of tests/test_windowed.py);
  - `take_columns` and `probes.gather_probe` at small shapes match jnp.take
    exactly and the probe's slot-reduce formula at float32 round-off;
    `probes.windowed_study` on the renumbered mesh is within its round-off
    bound and times nothing on the CPU."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.mesh.renumber import renumber_mesh as j_renumber
from mpas_tpu.ops import stencils as JS

from mpas_tpu_torch import probes
from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.mesh.generator import generate_mesh as t_generate
from mpas_tpu_torch.mesh.renumber import renumber_mesh as t_renumber
from mpas_tpu_torch.ops import gather_reduce as K2
from mpas_tpu_torch.ops import take_columns as K4
from mpas_tpu_torch.ops import windowed as K3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools import windowed_kernels as JW  # noqa: E402

RTOL = 1e-6
PLAN_FIELDS = ("R", "M", "nb", "Rp", "W", "block", "pad", "ws", "idx_localT",
               "min_table_width")


@pytest.fixture(scope="module")
def rmesh():
    return j_renumber(j_generate(levels=4))[0]


@pytest.mark.parametrize("table", ["edgesOnCell", "cellsOnEdge",
                                   "edgesOnEdge"])
def test_plan_matches(rmesh, table):
    idx = np.asarray(getattr(rmesh, table), np.int32)
    pj, pt = JW.plan_windows(jnp.asarray(idx)), K3.plan_windows(idx)
    for name in PLAN_FIELDS:
        assert np.array_equal(getattr(pj, name), getattr(pt, name)), name


def test_plan_cache_and_bounds(rmesh):
    eoc = np.asarray(rmesh.edgesOnCell, np.int32)
    p1 = K3.plan_windows(eoc)
    assert K3.plan_windows(torch.from_numpy(eoc.copy())) is p1
    assert K3.plan_windows(eoc[::-1].copy()) is not p1
    assert p1.W < rmesh.nEdges // 8          # renumbering made windows narrow
    assert p1.idx_localT.min() >= 0 and p1.idx_localT.max() < p1.W


@pytest.fixture(scope="module")
def meshes(rmesh):
    return {"renumbered": rmesh, "default": j_generate(levels=4)}


@pytest.mark.parametrize("numbering", ["renumbered", "default"])
@pytest.mark.parametrize("table", ["edgesOnCell", "cellsOnEdge",
                                   "edgesOnEdge"])
def test_column_plan_names_every_reference(meshes, numbering, table):
    idx = np.asarray(getattr(meshes[numbering], table), np.int32)
    p = K3.plan_windows(idx)
    R, M = idx.shape
    assert p.cols.shape == (p.nb, p.U) and p.idx_colsT.shape == (M, p.Rp)
    assert p.U % 32 == 0 and p.U <= 128 * M
    assert p.ncols.min() >= 1 and p.ncols.max() <= p.U < p.ncols.max() + 32
    for b in range(p.nb):
        n = p.ncols[b]
        assert np.all(np.diff(p.cols[b, :n]) > 0)           # sorted, distinct
        assert np.all(p.cols[b, n:] == p.cols[b, n - 1])    # padding
    assert p.idx_colsT.min() >= 0
    assert np.all(p.idx_colsT < np.repeat(p.ncols, 128)[None, :])
    block_of = np.arange(R) // 128
    assert np.array_equal(p.cols[block_of[None, :], p.idx_colsT[:, :R]],
                          idx.T)
    assert p.max_index == idx.max()
    if numbering == "renumbered":
        # only the columns a block reads: far fewer than its window holds
        assert p.U < p.W or table == "cellsOnEdge"


@pytest.mark.parametrize("numbering", ["renumbered", "default"])
@pytest.mark.parametrize("table", ["edgesOnCell", "cellsOnEdge",
                                   "edgesOnEdge"])
def test_plain_version_equals_gather_reduce_plain(meshes, numbering, table):
    """The plain version reads through the column plan and needs no table
    wider than the largest index; it gives gather_reduce_plain's result bit
    for bit (same gathers, same order of summation)."""
    idx = np.asarray(getattr(meshes[numbering], table), np.int32)
    p = K3.plan_windows(idx)
    rng = np.random.default_rng(4)
    tbl = torch.from_numpy(rng.standard_normal((5, int(idx.max()) + 1),
                                               np.float32))
    w = torch.from_numpy(rng.standard_normal((2,) + idx.shape, np.float32))
    wT = torch.stack([K3.pad_weights(p, x) for x in w])
    got = K3.windowed_gather_reduce(p, tbl, wT)
    assert torch.equal(got, K2.gather_reduce_plain(tbl, torch.from_numpy(idx),
                                                   w))


def test_slot_reduce_matches(rmesh):
    m = rmesh
    rng = np.random.default_rng(0)
    eoc = np.asarray(m.edgesOnCell, np.int32)
    sign = (m.edgesOnCellSign * m.edgesOnCell_mask).astype(np.float32)
    sign_dv = (sign * m.dvEdge[m.edgesOnCell]).astype(np.float32)
    ru = rng.standard_normal((9, m.nEdges), np.float32)
    fw = rng.standard_normal((10, m.nEdges), np.float32)
    j_sign, j_dv = jnp.asarray(sign), jnp.asarray(sign_dv)
    t_sign, t_dv = torch.from_numpy(sign), torch.from_numpy(sign_dv)
    ref = JW.slot_reduce_windowed(
        jnp.asarray(eoc), [(jnp.asarray(ru), [j_dv, j_sign]),
                           (jnp.asarray(fw), [j_sign])], interpret=True)
    got = K3.slot_reduce_windowed(
        torch.from_numpy(eoc), [(torch.from_numpy(ru), [t_dv, t_sign]),
                                (torch.from_numpy(fw), [t_sign])])
    assert [len(r) for r in got] == [2, 1]
    for i in range(2):
        for j in range(len(ref[i])):
            a, b = np.asarray(ref[i][j]), got[i][j].numpy()
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= RTOL * np.abs(a).max(), (i, j)
    # and the unwindowed reduction of mpas_tpu
    plain = JS.slot_reduce(jnp.asarray(eoc), [(jnp.asarray(fw), [j_sign])])
    a = np.asarray(plain[0][0])
    assert np.abs(a - got[1][0].numpy()).max() <= RTOL * np.abs(a).max()


def test_edge_pairs_match(rmesh):
    m = rmesh
    rng = np.random.default_rng(1)
    coe = np.asarray(m.cellsOnEdge, np.int32)
    fa = rng.standard_normal((9, m.nCells), np.float32)
    fb = rng.standard_normal((10, m.nCells), np.float32)
    ref = JW.edge_pairs_windowed(jnp.asarray(coe), jnp.asarray(fa),
                                 jnp.asarray(fb), interpret=True)
    got = K3.edge_pairs_windowed(torch.from_numpy(coe), torch.from_numpy(fa),
                                 torch.from_numpy(fb))
    for i in range(2):
        for side in range(2):
            np.testing.assert_allclose(got[i][side].numpy(),
                                       np.asarray(ref[i][side]),
                                       rtol=RTOL, atol=RTOL)


def test_more_than_four_weight_sets(rmesh):
    """Weight sets go to the kernel four at a time; six sets give what six
    separate reductions give."""
    eoc = np.asarray(rmesh.edgesOnCell, np.int32)
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.standard_normal((3, rmesh.nEdges), np.float32))
    ws = [torch.from_numpy(rng.standard_normal(eoc.shape, np.float32))
          for _ in range(6)]
    got = K3.slot_reduce_windowed(torch.from_numpy(eoc), [(f, ws)])[0]
    for w, g in zip(ws, got):
        ref = K3.slot_reduce_windowed(torch.from_numpy(eoc), [(f, [w])])[0][0]
        assert torch.equal(g, ref)


def test_level_chunk():
    plan = K3.plan_windows(np.arange(40962 * 6).reshape(-1, 6) // 2)
    kc, smem = K3.level_chunk(plan, 168, 1)
    assert kc >= 1 and smem <= K3.SMEM_TARGET
    assert -(-168 // kc) * kc >= 168


@pytest.mark.parametrize("M,U", [(4, 512), (10, 1280)])
@pytest.mark.parametrize("Kin,S", [(48, 1), (168, 4), (3, 2)])
def test_level_chunk_ring_fits(M, U, Kin, S):
    """A block of 128 rows whose references are all distinct: U = 128 M.
    The ring of two stages, the column list and the index and weight tiles
    fit in the shared memory a block may have, in SMEM_TARGET where two
    stages of one level do."""
    plan = K3.plan_windows(np.arange(128 * M, dtype=np.int32).reshape(128, M))
    assert plan.U == U and plan.ncols.tolist() == [U]
    kc, smem = K3.level_chunk(plan, Kin, S)
    extra = 4 * (U + 128 * M * (1 + S))
    assert 1 <= kc <= Kin and smem == 8 * kc * U + extra <= K3.SMEM_MAX
    if 8 * U + extra <= K3.SMEM_TARGET:
        assert smem <= K3.SMEM_TARGET
    slices = K3.level_slices(plan, Kin, kc, smem, n_sm=132)
    assert 1 <= slices <= -(-Kin // kc)


def test_level_chunk_refuses_a_list_too_long_for_shared_memory():
    plan = K3.plan_windows(np.arange(128 * 240, dtype=np.int32
                                     ).reshape(128, 240))
    with pytest.raises(ValueError, match="shared memory"):
        K3.level_chunk(plan, 8, 1)


def test_table_needs_no_padding_to_the_window(rmesh):
    """A table as wide as the index range is enough, though the plan's
    window (a TPU need) would overrun it."""
    eoc = np.asarray(rmesh.edgesOnCell, np.int32)
    plan = K3.plan_windows(eoc)
    assert plan.min_table_width > rmesh.nEdges
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.standard_normal((4, rmesh.nEdges), np.float32))
    w = torch.from_numpy(rng.standard_normal(eoc.shape, np.float32))
    (out,) = K3.windowed_reduce(plan, [f], [w], [(0, 0)])
    ref = K2.gather_reduce_plain(f, torch.from_numpy(eoc), w[None])[0]
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="columns"):
        K3.windowed_reduce(plan, [f[:, :-1]], [w], [(0, 0)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_take_columns_plain_matches_jnp_take(dtype):
    inp = probes.gather_probe_inputs(K=7, C=300, R=1000, M=3, seed=5)
    tbl = inp["tbl"].astype(dtype)
    ref = np.asarray(jnp.take(jnp.asarray(tbl), jnp.asarray(inp["idx"]),
                              axis=1))
    got = K4.take_columns(torch.from_numpy(tbl), torch.from_numpy(inp["idx"]))
    assert got.dtype == torch.from_numpy(tbl).dtype
    assert np.array_equal(got.numpy(), ref)


def test_gather_probe_small(rmesh):
    K, C, R, M = 6, 200, 900, 10
    res = probes.gather_probe(K=K, C=C, R=R, M=M, device="cpu", seed=3)
    inp = probes.gather_probe_inputs(K, C, R, M, seed=3)
    tbl = jnp.asarray(inp["tbl"])
    a, b, c = (t.numpy() for t in res["outputs"])
    take = np.asarray(jnp.take(tbl, jnp.asarray(inp["idx"]), axis=1))
    assert np.array_equal(a, take) and np.array_equal(b, take)
    # the probe's own slot-reduce formula (reduce_xla)
    acc = None
    for m in range(M):
        t = (jnp.asarray(inp["w"][:, m])[None, :]
             * jnp.take(tbl, jnp.asarray(inp["idx_slots"][:, m]), axis=1))
        acc = t if acc is None else acc + t
    acc = np.asarray(acc)
    assert np.abs(c - acc).max() <= RTOL * np.abs(acc).max()
    for key in "ABC":
        row = res[key]
        assert row["max_abs_err"] == 0.0 and row["ms"] is None
    assert res["C"]["flops"] == 2 * K * R * M


def test_windowed_study_small():
    mesh = t_renumber(t_generate(levels=4))[0]
    rows = probes.windowed_study(mesh, Kst=(5, 12), device="cpu")
    assert [r["Kst"] for r in rows] == [5, 12]
    for r in rows:
        assert r["err_over_bound"] <= 1.0
        assert r["err_over_bound_vs_index_select"] <= 1.0
        assert r["W"] == K3.plan_windows(
            np.asarray(mesh.edgesOnCell, np.int32)).W
        assert r["ms"] is None and r["library_ms"] is None


def test_probes_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        probes.gather_probe(K=2, C=10, R=20, M=2)
    with pytest.raises(RuntimeError):
        probes.compare_numberings(Namelist(config_nvertlevels=4),
                                  t_generate(levels=2, lloyd_iterations=0))
