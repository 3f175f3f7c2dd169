"""The two CUDA kernels of mpas_tpu_torch: their plain PyTorch versions
against mpas_tpu's functions in float64 at 1e-12, and the wrappers' CPU and
error paths (tests/test_torch_gpu.py holds each kernel against its plain
version on the card).

  - Kernel 1, acoustic_column_update: against mpas_tpu's Pallas kernel run
    in interpret mode (mpas_tpu/ops/pallas_acoustic.py), on the implicit
    coefficients of a JW state and random perturbation fields.
  - Kernel 2, gather_reduce: against mpas_tpu.ops.stencils.slot_reduce on
    the mesh's index tables and random tables and weights.

Setup: generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.ops import acoustic as JA
from mpas_tpu.ops import pallas_acoustic as JP
from mpas_tpu.ops import recover as JR
from mpas_tpu.ops import stencils as JS

from mpas_tpu_torch import probes
from mpas_tpu_torch.config import Namelist as TNamelist
from mpas_tpu_torch.dynamics.model import build_model as t_build
from mpas_tpu_torch.mesh.generator import generate_mesh as t_generate
from mpas_tpu_torch.ops import acoustic as TA
from mpas_tpu_torch.ops import acoustic_column as K1
from mpas_tpu_torch.ops import gather_reduce as K2

RTOL = 1e-12
DTS = 240.0
EPSSM = 0.1


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def model():
    mesh = j_generate(levels=3, lloyd_iterations=2)
    nl = JNamelist(config_nvertlevels=8, config_ztop=30000.0,
                   dtype="float64", config_jw_u_perturbation=1.0)
    return j_build(namelist=nl, mesh=mesh)


@pytest.fixture(scope="module")
def column_inputs(model):
    """Kernel 1's arguments: the implicit coefficients and metrics of the JW
    state, and random perturbation fields, as numpy arrays."""
    state = JR.compute_moist_coefficients(model.state, model.mesh_arrays)
    coefs = JA.compute_vert_imp_coefs(state, model.static, model.vert,
                                      model.namelist, DTS)
    K, C = state.theta_m.shape
    rng = np.random.default_rng(7)
    r = lambda k, s: rng.normal(0.0, s, (k, C))
    iface = lambda k, s: np.concatenate(
        [np.zeros((1, C)), r(k - 2, s), np.zeros((1, C))])
    zz = np.asarray(model.static.zz)
    fzm, fzp = np.asarray(model.vert.fzm), np.asarray(model.vert.fzp)
    interp = lambda f: np.concatenate(
        [np.zeros((1, C)), fzm[1:K, None] * f[1:] + fzp[1:K, None] * f[:-1],
         np.zeros((1, C))])
    dss = np.asarray(model.static.dss)
    args = dict(
        rs0=r(K, 1e-4), ts0=r(K, 1e-2), ac_rho_pp=r(K, 1e-4),
        ac_rtheta_pp=r(K, 1e-2), ac_rw_p=iface(K + 1, 1e-3),
        wwAvg=iface(K + 1, 1e-3), tend_rho=np.zeros((K, C)),
        tend_rt=np.zeros((K, C)), tend_w=iface(K + 1, 1e-5),
        zz=zz, dss_i=np.concatenate([np.zeros((1, C)), dss[1:],
                                     np.zeros((1, C))]),
        zz_rho_i=interp(zz) * interp(np.asarray(state.rho_zz)),
        w=iface(K + 1, 1e-2), dw_save=iface(K + 1, 1e-3))
    coefs_np = {f.name: np.array(getattr(coefs, f.name))
                for f in dataclasses.fields(coefs)}
    return args, coefs_np


def _k1_call(fn, coefs_cls, args, coefs_np, conv, **kw):
    a = {k: conv(v) for k, v in args.items()}
    coefs = coefs_cls(**{k: conv(v) for k, v in coefs_np.items()})
    return fn(a["rs0"], a["ts0"], a["ac_rho_pp"], a["ac_rtheta_pp"],
              a["ac_rw_p"], a["wwAvg"], a["tend_rho"], a["tend_rt"],
              a["tend_w"], coefs, a["zz"], a["dss_i"], a["zz_rho_i"], a["w"],
              a["dw_save"], DTS, EPSSM, **kw)


def test_acoustic_column_plain_matches_pallas(column_inputs):
    args, coefs_np = column_inputs
    ref = _k1_call(JP.acoustic_column_update, JA.ImplicitCoefs, args,
                   coefs_np, jnp.asarray, interpret=True)
    out = _k1_call(K1.acoustic_column_update_plain, TA.ImplicitCoefs, args,
                   coefs_np, torch.from_numpy)
    for name, r, o in zip(("rho_pp", "rtheta_pp", "rw_p", "wwAvg"), ref, out):
        assert rel_err(r, o.numpy()) < RTOL, name


def test_acoustic_column_none_tendencies_read_as_zero(column_inputs):
    args, coefs_np = column_inputs
    with_zeros = _k1_call(K1.acoustic_column_update, TA.ImplicitCoefs, args,
                          coefs_np, torch.from_numpy)
    args = dict(args, tend_rho=None, tend_rt=None)
    conv = lambda v: None if v is None else torch.from_numpy(v)
    with_none = _k1_call(K1.acoustic_column_update, TA.ImplicitCoefs, args,
                         coefs_np, conv)
    for a, b in zip(with_zeros, with_none):
        assert torch.equal(a, b)


@pytest.mark.parametrize("table,weights_per_set", [
    ("edgesOnCell", 1), ("edgesOnCell", 3), ("edgesOnVertex", 1),
    ("edgesOnEdge", 1), ("edgesOnEdge", 2), ("advCellsForEdge", 2)])
def test_gather_reduce_plain_matches_slot_reduce(model, table,
                                                  weights_per_set):
    mesh = model.mesh_arrays
    idx = np.asarray(getattr(mesh, table))
    R, M = idx.shape
    N = mesh.nCells if table == "advCellsForEdge" else mesh.nEdges
    rng = np.random.default_rng(R + M + weights_per_set)
    f1, f2 = rng.normal(size=(8, N)), rng.normal(size=(9, N))
    ws = [rng.normal(size=(R, M)) for _ in range(weights_per_set)]
    ref = JS.slot_reduce(jnp.asarray(idx),
                         [(jnp.asarray(f1), [jnp.asarray(w) for w in ws]),
                          (jnp.asarray(f2), [jnp.asarray(w) for w in ws])])
    out = K2.gather_reduce_plain(
        torch.from_numpy(np.concatenate([f1, f2])),
        torch.from_numpy(idx.astype(np.int32)),
        torch.from_numpy(np.stack(ws)))
    for s in range(weights_per_set):
        assert rel_err(ref[0][s], out[s, :8].numpy()) < RTOL
        assert rel_err(ref[1][s], out[s, 8:].numpy()) < RTOL


def test_wrappers_on_cpu_run_the_plain_versions(model):
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(np.asarray(model.mesh_arrays.edgesOnCell, np.int32))
    tbl = torch.from_numpy(rng.normal(size=(4, model.mesh_arrays.nEdges)))
    w = torch.from_numpy(rng.normal(size=(2,) + tuple(idx.shape)))
    K2.launches = 0
    assert torch.equal(K2.gather_reduce(tbl, idx, w),
                       K2.gather_reduce_plain(tbl, idx, w))
    assert K2.launches == 0


@pytest.mark.parametrize("table,bad", [("edgesOnCell", -1),
                                       ("edgesOnEdge", "n"),
                                       ("advCellsForEdge", "n")])
def test_mesh_arrays_refuse_out_of_range_indices(model, table, bad):
    """The tables the gather-reduce kernel reads unchecked are checked once,
    when the MeshArrays are made."""
    from mpas_tpu_torch.weights import from_jax_numpy
    as_np = lambda x: {f.name: None if getattr(x, f.name) is None
                       else np.asarray(getattr(x, f.name))
                       for f in dataclasses.fields(x)}
    mesh = from_jax_numpy(as_np(model.mesh_arrays), as_np(model.vert),
                          as_np(model.static), as_np(model.state),
                          device="cpu", dtype=torch.float64)[0]
    t = getattr(mesh, table).clone()
    t[0, 0] = (mesh.nCells if table == "advCellsForEdge" else mesh.nEdges) \
        if bad == "n" else bad
    with pytest.raises(ValueError, match=table):
        mesh.replace(**{table: t})


def test_gather_reduce_rejects_other_devices():
    tbl = torch.zeros((2, 5), device="meta")
    with pytest.raises(ValueError):
        K2.gather_reduce(tbl, torch.zeros((3, 2), dtype=torch.int32,
                                          device="meta"),
                         torch.zeros((1, 3, 2), device="meta"))


# ---- which form of Kernel 2 runs: the scatter statistic and its cache ----

MESH_TABLES = ("edgesOnCell", "edgesOnVertex", "edgesOnEdge", "cellsOnEdge")


@pytest.fixture(scope="module")
def mesh4():
    return t_generate(levels=4)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("table", MESH_TABLES)
def test_scatter_statistic_is_low_on_a_mesh(mesh4, table, itemsize):
    idx = np.asarray(getattr(mesh4, table), np.int32)
    N = mesh4.nCells if table == "cellsOnEdge" else mesh4.nEdges
    s = K2.scatter_sectors(idx, itemsize)
    assert 1.0 / idx.shape[1] <= s < 16.0
    assert K2.row_form_gain(s, itemsize, N, *idx.shape) < K2.ROW_FORM_MIN_GAIN


@pytest.mark.parametrize("itemsize", [4, 8])
def test_scatter_statistic_is_near_32_at_random_indices(itemsize):
    inp = probes.gather_probe_inputs(K=2, C=40962, R=4096, M=10, seed=1)
    s = K2.scatter_sectors(inp["idx_slots"], itemsize)
    assert 30.0 < s <= 32.0
    # at the probe's own shape (R = 122880 rows share the transpose)
    assert K2.row_form_gain(s, itemsize, 40962, 122880, 10) > \
        K2.ROW_FORM_MIN_GAIN


def test_scatter_statistic_counts_sectors_of_a_warps_tile():
    # 32 rows x 2 slots, all in one float32 sector: 1 sector over 2 slots
    assert K2.scatter_sectors(np.zeros((32, 2), np.int32), 4) == 0.5
    # every reference 8 columns from the next: one sector each
    idx = (np.arange(64, dtype=np.int32) * 8).reshape(32, 2)
    assert K2.scatter_sectors(idx, 4) == 32.0
    assert K2.scatter_sectors(idx, 8) == 32.0
    # adjacent columns: 64 references in 8 float32 or 16 float64 sectors;
    # a short last warp counts with the rows it has
    idx = np.arange(64, dtype=np.int32).reshape(32, 2)
    assert K2.scatter_sectors(idx, 4) == 4.0
    assert K2.scatter_sectors(idx, 8) == 8.0
    assert K2.scatter_sectors(np.concatenate([idx, idx[:3]]), 4) == \
        (4.0 + 0.5) / 2


def test_index_scatter_is_cached_per_table(monkeypatch):
    calls = []
    real = K2.scatter_sectors
    monkeypatch.setattr(K2, "scatter_sectors",
                        lambda a, size: calls.append(a.shape) or real(a, size))
    monkeypatch.setattr(K2, "_scatter_cache", {})
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.integers(0, 5000, (640, 10), dtype=np.int32))
    v = K2.index_scatter(base, 4)
    assert K2.index_scatter(base, 4) == v and len(calls) == 1
    # a view of other columns is another table; the same view again is not
    tail = K2.index_scatter(base[:, 2:], 4)
    assert K2.index_scatter(base[:, 2:], 4) == tail and len(calls) == 2
    assert calls[-1] == (640, 8)
    # another element size is another statistic
    K2.index_scatter(base, 8)
    assert len(calls) == 3
    # an in-place write is seen
    base[:, 0] = 0
    assert K2.index_scatter(base, 4) != v and len(calls) == 4
    # the cache stays small and keeps its tables alive (no address reuse)
    for i in range(K2.SCATTER_CACHE_SIZE + 3):
        K2.index_scatter(torch.zeros((32, 1), dtype=torch.int32), 4)
    assert len(K2._scatter_cache) == K2.SCATTER_CACHE_SIZE
    assert all(hit[0].data_ptr() == key[1]
               for key, hit in K2._scatter_cache.items())


@pytest.mark.parametrize("orient", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_every_table_of_the_step_takes_the_direct_form(orient, dtype):
    """MeshArrays holds the statistic of each index table the step's
    reductions read, and none of them is sent to the row-read form; a random
    table of the same shape is."""
    nl = TNamelist(config_nvertlevels=8, config_ztop=30000.0, dtype=dtype,
                   config_jw_u_perturbation=1.0, config_orient_edges=orient)
    m = t_build(nl, t_generate(levels=3, lloyd_iterations=2),
                device="cpu").mesh_arrays
    size = m.edgesOnCell_mask.element_size()
    tables = {"edgesOnCell": (m.edgesOnCell, m.nEdges),
              "edgesOnVertex": (m.edgesOnVertex, m.nEdges),
              "edgesOnEdge": (m.edgesOnEdge, m.nEdges),
              "advCellsForEdge[:, 2:]": (m.advCellsForEdge[:, 2:], m.nCells),
              # the moist and cell-form steps: scalar transport reads every
              # advection slot, Hollingsworth / APVM reduce over vertices
              "advCellsForEdge": (m.advCellsForEdge, m.nCells),
              "verticesOnCell": (m.verticesOnCell, m.nVertices)}
    if orient:
        tables["eoc_split.idx"] = (m.eoc_split.idx, m.nEdges)
    assert set(m.gather_sectors) == set(tables)
    for name, (idx, N) in tables.items():
        tbl = torch.zeros((16, N), dtype=m.edgesOnCell_mask.dtype)
        assert m.gather_sectors[name] == K2.index_scatter(idx, size), name
        assert not K2.uses_row_form(tbl, idx), name
    rng = np.random.default_rng(2)
    rand = torch.from_numpy(rng.integers(0, m.nEdges, (m.nEdges, 10),
                                         dtype=np.int32))
    tbl = torch.zeros((16, m.nEdges), dtype=m.edgesOnCell_mask.dtype)
    assert K2.uses_row_form(tbl, rand)
    # a table with less than a sector's worth of levels stays direct
    assert not K2.uses_row_form(tbl[:32 // size - 1], rand)


@pytest.mark.parametrize("Kt,dtype,Ktp", [
    (83, torch.float32, 88), (82, torch.float32, 88), (8, torch.float32, 8),
    (1, torch.float32, 8), (83, torch.float64, 84), (41, torch.float64, 44),
    (4, torch.float64, 4)])
def test_transposed_scratch_rows_start_on_sector_boundaries(Kt, dtype, Ktp):
    tbl = torch.zeros((Kt, 37), dtype=dtype)
    assert K2.padded_levels(Kt, tbl.element_size()) == Ktp
    scratch = K2.transposed_scratch(tbl)
    assert scratch.shape == (37, Ktp) and scratch.dtype == dtype
    assert scratch.is_contiguous()
    assert (Ktp * tbl.element_size()) % K2.SECTOR_BYTES == 0


def test_named_forms_refuse_cpu_tensors():
    """Only `gather_reduce` takes the plain version, and only for tensors
    on the CPU; the two forms are kernels."""
    tbl = torch.zeros((2, 5))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.zeros((1, 3, 2))
    for form in (K2.gather_reduce_direct, K2.gather_reduce_rows):
        with pytest.raises(ValueError, match="unsupported device"):
            form(tbl, idx, w)
