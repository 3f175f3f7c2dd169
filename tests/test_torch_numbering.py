"""The port's mesh numberings against mpas_tpu's, on the CPU, on
generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels, float64:

  - the numpy copies (renumber_mesh, block_spans, orient_edges, save_grid
    and generate_and_cache through load_mesh) give equal arrays;
  - every ownership-aligned `_m` stencil matches mpas_tpu.ops.stencils' at
    1e-12 of each output's largest magnitude, on random fields;
  - for config_orient_edges, config_renumber_mesh and both: build_model's
    initial state matches the reference's at 1e-12, and 2 SRK3 steps from a
    state carried across with `from_jax_numpy` match at 1e-10 per field
    (the bounds of tests/test_torch_srk3.py);
  - the port's aligned trajectory is its unaligned one through the edge
    permutation and flip (`perms["new_of_old"]`, `perms["flip"]`) at 1e-11
    after 2 steps, as tests/test_orient.py states it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh import orient as j_orient
from mpas_tpu.mesh import renumber as j_renumber
from mpas_tpu.mesh import writer as j_writer
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.mesh.loader import load_mesh as j_load
from mpas_tpu.ops import stencils as JS

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics import srk3
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh import orient as t_orient
from mpas_tpu_torch.mesh import renumber as t_renumber
from mpas_tpu_torch.mesh import writer as t_writer
from mpas_tpu_torch.mesh.generator import generate_mesh as t_generate
from mpas_tpu_torch.mesh.loader import load_mesh as t_load
from mpas_tpu_torch.ops import stencils as TS
from mpas_tpu_torch.weights import from_jax_numpy

OP_RTOL = 1e-12
INIT_RTOL = 1e-12
STEP_RTOL = 1e-10
ALIGNED_RTOL = 1e-11
FIELDS = ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p")
KW = dict(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
          config_jw_u_perturbation=1.0)
CONFIGS = {"orient": dict(config_orient_edges=True),
           "renumber": dict(config_renumber_mesh=True),
           "both": dict(config_orient_edges=True, config_renumber_mesh=True)}


def as_dict(x):
    return {f.name: (None if getattr(x, f.name) is None
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


def rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def assert_same(a, b, what=""):
    """Every field of two dataclasses / dicts is equal, arrays exactly."""
    if dataclasses.is_dataclass(a):
        a, b = vars(a), vars(b)
    assert set(a) == set(b), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y),
                                  equal_nan=True), f"{what}.{k}"
        else:
            assert x == y, f"{what}.{k}"


@pytest.fixture(scope="module")
def meshes():
    return (j_generate(levels=3, lloyd_iterations=2),
            t_generate(levels=3, lloyd_iterations=2))


# ---------------------------------------------------------------------------
# the numpy copies
# ---------------------------------------------------------------------------

def test_renumber_mesh_equal(meshes):
    jm, jp = j_renumber.renumber_mesh(meshes[0])
    tm, tp = t_renumber.renumber_mesh(meshes[1])
    assert_same(jm, tm, "mesh")
    assert_same(jp, tp, "perms")


def test_block_spans_equal(meshes):
    tm, _ = t_renumber.renumber_mesh(meshes[1])
    for name in ("edgesOnCell", "cellsOnEdge", "edgesOnEdge"):
        idx = getattr(tm, name)
        for block in (32, 128):
            assert np.array_equal(j_renumber.block_spans(idx, block),
                                  t_renumber.block_spans(idx, block)), name


@pytest.mark.parametrize("renumber", [False, True])
def test_orient_edges_equal(meshes, renumber):
    jm, tm = meshes
    if renumber:
        jm, tm = (j_renumber.renumber_mesh(jm)[0],
                  t_renumber.renumber_mesh(tm)[0])
    jn, jp = j_orient.orient_edges(jm)
    tn, tp = t_orient.orient_edges(tm)
    assert tn.edges_owner_aligned and tn.nEdges == 3 * tn.nCells
    assert_same(jn, tn, "mesh")
    assert_same(jp, tp, "perms")


def test_save_grid_load_mesh_equal(meshes, tmp_path):
    j_writer.save_grid(meshes[0], str(tmp_path / "j.nc"))
    t_writer.save_grid(meshes[1], str(tmp_path / "t.nc"))
    a, b = j_load(str(tmp_path / "j.nc")), t_load(str(tmp_path / "t.nc"))
    assert_same(a, b, "loaded")
    assert_same(t_load(str(tmp_path / "j.nc")), b, "cross")


@pytest.mark.parametrize("levels", [2, 3])
def test_generate_and_cache(tmp_path, levels):
    """The first call (which generates and writes the cache) returns the
    mesh every later call loads; at level 3 the unit-sphere round trip moves
    the coordinates, so the generated mesh itself would differ."""
    m1 = t_writer.generate_and_cache(levels, cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    m2 = t_writer.generate_and_cache(levels, cache_dir=str(tmp_path))
    assert len(files) == 1 and list(tmp_path.iterdir()) == files
    assert_same(m1, m2, "cached")
    assert_same(j_writer.generate_and_cache(levels, cache_dir=str(tmp_path)),
                m1, "reference")


# ---------------------------------------------------------------------------
# the aligned `_m` stencils
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aligned(meshes):
    """mpas_tpu's model on the aligned mesh and the port's MeshArrays and
    static fields carried across from it, with random fields."""
    m = j_build(namelist=JNamelist(**KW, config_orient_edges=True),
                mesh=meshes[0])
    assert m.mesh_arrays.owner_aligned
    tm, _, tst, _ = from_jax_numpy(
        as_dict(m.mesh_arrays), as_dict(m.vert), as_dict(m.static),
        as_dict(m.state), device="cpu", dtype=torch.float64)
    assert tm.owner_aligned and tm.eoc_split is not None
    C, E = m.mesh.nCells, m.mesh.nEdges
    rng = np.random.default_rng(4321)
    f = dict(cell=rng.normal(size=(8, C)), cell2=rng.normal(size=(5, C)),
             iface=rng.normal(size=(9, C)), edge=rng.normal(size=(8, E)),
             edge2=rng.normal(size=(3, E)), eiface=rng.normal(size=(9, E)),
             wc=rng.normal(size=(C, 6)), wc2=rng.normal(size=(C, 6)))
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    tf = {k: torch.from_numpy(v) for k, v in f.items()}
    jf.update(zb=m.static.zb_cell, zb3=m.static.zb3_cell)
    tf.update(zb=tst.zb_cell, zb3=tst.zb3_cell)
    return (m.mesh_arrays, jf), (tm, tf)


_ALIGNED_CASES = {
    "edge_pairs_m": lambda S, m, f: S.edge_pairs_m(m, f["cell"], f["iface"]),
    "edge_pair_m": lambda S, m, f: S.edge_pair_m(m, f["cell"]),
    "avg_cell_to_edge_m": lambda S, m, f: S.avg_cell_to_edge_m(m, f["iface"]),
    "diff_cell_to_edge_m": lambda S, m, f: S.diff_cell_to_edge_m(m, f["cell"]),
    "slot_reduce_m_1set": lambda S, m, f: S.slot_reduce_m(
        m, m.edgesOnCell, [(f["edge"], [f["wc"]]), (f["edge2"], [f["wc"]])]),
    "slot_reduce_m_2sets": lambda S, m, f: S.slot_reduce_m(
        m, m.edgesOnCell, [(f["edge"], [f["wc"], f["wc2"]]),
                           (f["eiface"], [f["wc2"], f["wc"]]),
                           (f["edge2"], [f["wc2"]])]),
    "slot_reduce_m_other_table": lambda S, m, f: S.slot_reduce_m(
        m, m.edgesOnVertex, [(f["edge"], [m.edgesOnVertexSign])]),
    "zb_metric_m": lambda S, m, f: S.zb_metric_m(
        m, f["eiface"], m.edgesOnCellSign, f["zb"], f["zb3"]),
    "sum_edges_to_cell_m": lambda S, m, f: S.sum_edges_to_cell_m(
        m, f["eiface"], f["wc2"]),
}


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return sum((_leaves(v) for v in x), [])
    return [x.numpy() if torch.is_tensor(x) else np.asarray(x)]


@pytest.mark.parametrize("name", sorted(_ALIGNED_CASES))
def test_aligned_stencil_matches(aligned, name):
    (jm, jf), (tm, tf) = aligned
    fn = _ALIGNED_CASES[name]
    a, b = _leaves(fn(JS, jm, jf)), _leaves(fn(TS, tm, tf))
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert np.abs(x - y).max() <= OP_RTOL * np.abs(x).max(), name


def test_zb_metric_m_keeps_its_planes(aligned):
    """The per-plane zb/zb3/sign tables are built at the first call and
    reused while the same static tensors are passed."""
    _, (tm, tf) = aligned
    TS.zb_metric_m(tm, tf["eiface"], tm.edgesOnCellSign, tf["zb"], tf["zb3"])
    planes = tm.eoc_split.zb_planes(tf["zb"], tf["zb3"], tm.edgesOnCellSign)
    again = tm.eoc_split.zb_planes(tf["zb"], tf["zb3"], tm.edgesOnCellSign)
    assert all(p is q for p, q in zip(planes, again))


# ---------------------------------------------------------------------------
# the whole step on each numbering
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(meshes):
    """Per configuration, lazily: mpas_tpu's model and its state after 2
    steps, and the port's state after 2 steps from the carried-across
    initial state."""
    cache = {}

    def get(name):
        if name not in cache:
            m = j_build(namelist=JNamelist(**KW, **CONFIGS[name]),
                        mesh=meshes[0])
            tm, tv, tst, ts = from_jax_numpy(
                as_dict(m.mesh_arrays), as_dict(m.vert), as_dict(m.static),
                as_dict(m.state), device="cpu", dtype=torch.float64)
            nl = Namelist(**KW, **CONFIGS[name])
            for _ in range(2):
                ts = srk3.atm_srk3(ts, tst, tm, tv, nl, nl.config_dt)
            cache[name] = (m, m.step_fn(m.step_fn(m.state)), ts)
        return cache[name]
    return get


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_two_steps_match(runs, config, field):
    _, jstate, ts = runs(config)
    b = getattr(ts, field).numpy()
    assert np.isfinite(b).all()
    assert rel_err(np.asarray(getattr(jstate, field)), b) < STEP_RTOL


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_build_model_matches_reference(runs, meshes, config):
    jm = runs(config)[0]
    model = build_model(Namelist(**KW, **CONFIGS[config]), meshes[1],
                        device="cpu")
    assert model.mesh.nEdges == jm.mesh.nEdges
    assert model.mesh_arrays.owner_aligned == jm.mesh_arrays.owner_aligned
    assert_same(jm.mesh, model.mesh, "mesh")
    for f in dataclasses.fields(model.state):
        t = getattr(model.state, f.name)
        if t is not None:
            assert rel_err(np.asarray(getattr(jm.state, f.name)),
                           t.numpy()) < INIT_RTOL, f.name


def test_aligned_mesh_given_is_kept(meshes):
    """An already-aligned mesh is taken as it is, as mpas_tpu takes it."""
    n, _ = t_orient.orient_edges(meshes[1])
    model = build_model(Namelist(**KW, config_orient_edges=True), n,
                        device="cpu")
    assert model.mesh is n and "orient_edges" not in model.setup_seconds


def test_aligned_trajectory_equals_unaligned(meshes):
    off = build_model(Namelist(**KW), meshes[1], device="cpu")
    on = build_model(Namelist(**KW, config_orient_edges=True), meshes[1],
                     device="cpu")
    _, perms = t_orient.orient_edges(meshes[1])
    no, fl = perms["new_of_old"], perms["flip"]
    np.testing.assert_allclose(on.state.u.numpy()[:, no],
                               fl[None, :] * off.state.u.numpy(), atol=1e-12)
    off.step(2)
    on.step(2)
    for name in ("theta_m", "rho_zz", "w", "exner"):
        a = getattr(off.state, name).numpy()
        b = getattr(on.state, name).numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < ALIGNED_RTOL, name
    u_off = off.state.u.numpy()
    u_on = on.state.u.numpy()[:, no] * fl[None, :]
    assert np.abs(u_on - u_off).max() / np.abs(u_off).max() < ALIGNED_RTOL
