"""mpas_tpu_torch.io.lbc against mpas_tpu.io.lbc, float64 on the CPU, on
the NH-cap regional zones of generate_mesh(levels=3, lloyd_iterations=3)
(642 cells; mark_regional_zones with latCell > 0.15, 5 relaxation rings),
6 levels, dt 480 s, as tests/test_lbc.py.

  - the numpy parts array-equal: zone indices, Davies weights, the stream's
    window, extract_lbc, build_stream, lbc_filename, CoarseToFine (level-2
    coarse mesh onto the marked level-3 one);
  - streams (.npz) and lbc.*.nc files written by either package read in
    the other, array-equal;
  - make_lbc_apply_fn and the zone re-diagnosis (_make_recouple_fn) at
    1e-12 of each field's largest magnitude;
  - RegionalDriver against mpas_tpu's for 4 steps at 1e-10 (this runs the
    config_apply_lbcs branches of ops/recover.py);
  - the specified zone equals the stream at each step's start, the interior
    tracks the global run, and the model refuses a driver without
    config_apply_lbcs."""

import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.io import lbc as JL
from mpas_tpu.mesh.coefficients import mark_regional_zones as j_mark
from mpas_tpu.mesh.generator import generate_mesh as j_generate

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.core.vertical import make_vertical_grid
from mpas_tpu_torch.dynamics import srk3
from mpas_tpu_torch.dynamics.model import Model, build_model
from mpas_tpu_torch.io import lbc as TL
from mpas_tpu_torch.mesh.coefficients import mark_regional_zones as t_mark
from mpas_tpu_torch.mesh.generator import generate_mesh as t_generate

from test_torch_cellform import carry
from test_torch_ops import assert_close

DT = 480.0
K = 6
LBC_EVERY = 3
DRIVE_STEPS = 6
KW = dict(config_nvertlevels=K, config_ztop=30000.0, dtype="float64",
          config_dt=DT, config_jw_u_perturbation=1.0)
STEP_RTOL = 1e-10


def marked(generate):
    m = generate(levels=3, lloyd_iterations=3)
    mark = j_mark if generate is j_generate else t_mark
    return mark(m, m.latCell > 0.15, n_relax=5)


@pytest.fixture(scope="module")
def meshes():
    return marked(j_generate), marked(t_generate)


def port_of(jm, mesh, state=None, **changes):
    """A port Model on the containers carried across from the JAX model
    `jm` (and, optionally, a JAX state), on the port's copy of its mesh."""
    tm, tv, tst, ts = carry(jm, state)
    nl = Namelist(**jm.namelist.to_dict()).replace(**changes)
    return Model(namelist=nl, mesh=mesh,
                 vgrid=make_vertical_grid(nl.config_nvertlevels,
                                          nl.config_ztop,
                                          nl.config_vertical_stretch),
                 mesh_arrays=tm, vert=tv, static=tst, state=ts,
                 step_fn=srk3.make_step_fn(tst, tm, tv, nl),
                 step_count=jm.step_count)


@pytest.fixture(scope="module")
def drive(meshes):
    """The JAX driving run: (initial JAX model, final state, stream of a
    snapshot every LBC_EVERY steps, the snapshots' JAX states)."""
    jm = j_build(namelist=JNamelist(**KW), mesh=meshes[0])
    s0 = jm.state
    cells, edges = JL.zone_indices(meshes[0])
    times, snaps, states = [0.0], [JL.extract_lbc(s0, cells, edges)], [s0]
    s = s0
    for i in range(DRIVE_STEPS):
        s = jm.step_fn(s)
        if (i + 1) % LBC_EVERY == 0:
            times.append((i + 1) * DT)
            snaps.append(JL.extract_lbc(s, cells, edges))
            states.append(s)
    return jm, s, JL.build_stream(times, cells, edges, snaps), states


def same_stream(a, b):
    for k in ("times", "cells", "edges"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert set(a.cell_data) == set(b.cell_data)
    for n in a.cell_data:
        assert np.array_equal(a.cell_data[n], b.cell_data[n]), n
    for n in a.edge_data:
        assert np.array_equal(a.edge_data[n], b.edge_data[n]), n
    assert (a.scalars is None) == (b.scalars is None)
    if a.scalars is not None:
        assert np.array_equal(a.scalars, b.scalars)


def test_zone_indices_and_weights_equal(meshes):
    jz, tz = JL.zone_indices(meshes[0]), TL.zone_indices(meshes[1])
    for a, b in zip(jz, tz, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert 0 < len(jz[0]) < meshes[0].nCells
    for mask in ("bdyMaskCell", "bdyMaskEdge"):
        for n in (1, 5):
            assert np.array_equal(
                JL.davies_weights(getattr(meshes[0], mask), n),
                TL.davies_weights(getattr(meshes[1], mask), n))


def test_davies_weights(meshes):
    bdy = meshes[1].bdyMaskCell
    w = TL.davies_weights(bdy, 5)
    assert (w[bdy == 0] == 0.0).all() and (w[bdy == 6] == 1.0).all()
    means = [w[bdy == r].mean() for r in range(1, 6)]
    assert all(a > b for a, b in zip(means, means[1:]))
    assert means[0] == 1.0


@pytest.mark.parametrize("t", [-5.0, 0.0, 100.0, 1440.0, 2000.0, 2880.0,
                               9999.0])
def test_window_and_filename_equal(drive, t):
    j_stream = drive[2]
    t_stream = TL.LBCStream(**vars(j_stream))
    assert j_stream.window(t) == t_stream.window(t)
    assert JL.lbc_filename(abs(t) * 97) == TL.lbc_filename(abs(t) * 97)


def test_extract_and_build_stream_equal(meshes, drive):
    jm, _, j_stream, states = drive
    cells, edges = TL.zone_indices(meshes[1])
    snaps = [TL.extract_lbc(carry(jm, s)[3], cells, edges) for s in states]
    same_stream(j_stream, TL.build_stream(j_stream.times, cells, edges, snaps))


@pytest.mark.parametrize("writer", ["mpas_tpu", "mpas_tpu_torch"])
def test_stream_files_cross_package(drive, tmp_path, writer):
    stream = drive[2]
    w, r = (JL, TL) if writer == "mpas_tpu" else (TL, JL)
    path = str(tmp_path / "lbc.npz")
    w.write_lbc(path, stream)
    same_stream(stream, r.read_lbc(path))


def test_lbc_netcdf_cross_package(meshes, drive, tmp_path):
    """lbc.*.nc files of the same two states written by each package are
    the same files, and each package reads both sets into the same
    stream."""
    jm, _, _, states = drive
    pm = port_of(jm, meshes[1])
    sets = {}
    for pkg, model in (("j", jm), ("t", pm)):
        (tmp_path / pkg).mkdir()
        paths = []
        for t, s in ((0.0, states[0]), (LBC_EVERY * DT, states[1])):
            p = str(tmp_path / pkg / TL.lbc_filename(t))
            if pkg == "j":
                JL.write_lbc_netcdf(p, t, s, model)
            else:
                TL.write_lbc_netcdf(p, t, carry(jm, s)[3], model)
            paths.append(p)
        sets[pkg] = paths
    ref = JL.read_lbc_netcdf(sets["j"], jm)
    assert np.array_equal(ref.times, [0.0, LBC_EVERY * DT])
    for paths in sets.values():
        same_stream(ref, JL.read_lbc_netcdf(paths, jm))
        same_stream(ref, TL.read_lbc_netcdf(paths, pm))
    same_stream(JL.read_lbc_netcdf(sets["t"], jm, n_scalars=2),
                TL.read_lbc_netcdf(sets["j"], pm, n_scalars=2))


def test_coarse_to_fine_equal(meshes, drive):
    jm = drive[0]
    cells, edges = TL.zone_indices(meshes[1])
    coarse_j = j_generate(levels=2, lloyd_iterations=3)
    coarse_t = t_generate(levels=2, lloyd_iterations=3)
    a = JL.CoarseToFine(coarse_j, meshes[0], cells, edges)
    b = TL.CoarseToFine(coarse_t, meshes[1], cells, edges)
    for k in ("ci", "cw", "ei", "ew", "angle"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    rng = np.random.default_rng(7)
    f = rng.normal(size=(K, coarse_j.nCells))
    assert np.array_equal(a.cell_field(f), b.cell_field(torch.from_numpy(f)))
    uz, um = (rng.normal(size=(K, coarse_j.nCells)) for _ in range(2))
    assert np.array_equal(a.edge_normal_u(uz, um), b.edge_normal_u(uz, um))
    # a coarse state: any state of the coarse mesh's shape will do
    cm = j_build(namelist=JNamelist(**KW), mesh=coarse_j)
    sa, sb = a.snapshot(cm.state), b.snapshot(carry(cm)[3])
    for x, y in zip(sa[:2], sb[:2]):
        for n in x:
            assert np.array_equal(x[n], y[n]), n


@pytest.fixture(scope="module")
def regional(meshes, drive):
    """A JAX regional model and the port's on its containers, the same
    stream, both at step 0."""
    jm, _, stream, _ = drive
    jr = j_build(namelist=JNamelist(**KW, config_apply_lbcs=True),
                 mesh=meshes[0])
    return jr, port_of(jr, meshes[1]), stream


def test_apply_and_recouple_match(regional):
    """One blend toward the fields at t = 1000 s from a state one step on
    (its zone differs from the stream's), then the re-diagnosis."""
    jr, pm, stream = regional
    s1 = jr.step_fn(jr.state)
    j_apply = JL.make_lbc_apply_fn(jr.mesh_arrays, jr.namelist, stream,
                                   jr.dtype)
    t_apply = TL.make_lbc_apply_fn(pm.mesh_arrays, pm.namelist, stream,
                                   pm.dtype)
    j_fields = JL.interp_fields(stream, 1000.0, jr.dtype)
    t_fields = TL.interp_fields(stream, 1000.0, pm.dtype, "cpu")
    assert_close(dict(j_fields), t_fields, rtol=0.0)
    ts1 = carry(jr, s1)[3]
    j_out, t_out = j_apply(s1, j_fields), t_apply(ts1, t_fields)
    names = TL.CELL_FIELDS + TL.EDGE_FIELDS
    assert_close([getattr(j_out, n) for n in names],
                 [getattr(t_out, n) for n in names], rtol=1e-12)
    # the input was not written, and the blend moved the zone
    assert torch.equal(ts1.theta_m, carry(jr, s1)[3].theta_m)
    assert not torch.equal(t_out.theta_m, ts1.theta_m)
    j_re = JL._make_recouple_fn(jr)(j_out)
    t_re = TL._make_recouple_fn(pm)(t_out)
    names = ("ru", "rw", "rho_p", "rtheta_p", "exner", "pressure_p")
    assert_close([getattr(j_re, n) for n in names],
                 [getattr(t_re, n) for n in names], rtol=1e-12)


def test_regional_driver_matches(regional):
    """4 regional steps, both packages: every prognostic at 1e-10."""
    jr, pm, stream = regional
    j_drv, t_drv = JL.RegionalDriver(jr, stream), TL.RegionalDriver(pm, stream)
    j_drv.step(4)
    t_drv.step(4)
    assert pm.step_count == jr.step_count == 4
    names = ("u", "w", "theta_m", "rho_zz", "ru", "rw", "rho_p", "rtheta_p",
             "exner", "pressure_p")
    assert_close([getattr(jr.state, n) for n in names],
                 [getattr(pm.state, n) for n in names], rtol=STEP_RTOL)


def test_specified_zone_tracks_stream(meshes, drive):
    """With forcing every step the specified zone is hard-set to the stream
    at the step's start and held through the step; the interior tracks the
    global run's interior; a model without config_apply_lbcs is refused."""
    jm, final, stream, _ = drive
    nl = Namelist(**KW, config_apply_lbcs=True)
    m = build_model(nl, meshes[1], device="cpu")
    with pytest.raises(ValueError, match="config_apply_lbcs"):
        TL.RegionalDriver(build_model(nl.replace(config_apply_lbcs=False),
                                      meshes[1], device="cpu"), stream)
    drv = TL.RegionalDriver(m, stream)
    spec_c = meshes[1].bdyMaskCell > nl.nRelaxZone
    spec_e = meshes[1].bdyMaskEdge > nl.nRelaxZone
    zc = np.searchsorted(stream.cells, np.where(spec_c)[0])
    ze = np.searchsorted(stream.edges, np.where(spec_e)[0])
    for _ in range(DRIVE_STEPS):
        f = TL.interp_fields(stream, m.step_count * DT, m.dtype, "cpu")
        drv.step(1)
        for n in ("theta_m", "rho_zz"):
            assert_close(f[n][:, zc], getattr(m.state, n)[:, spec_c],
                         rtol=1e-12)
        assert_close(f["u"][:, ze], m.state.u[:, spec_e], rtol=1e-12)
    ref = carry(jm, final)[3]
    interior_c, interior_e = meshes[1].bdyMaskCell == 0, meshes[1].bdyMaskEdge == 0
    assert float((m.state.u - ref.u)[:, interior_e].abs().max()) < 0.2
    assert float((m.state.theta_m - ref.theta_m)[:, interior_c].abs().max()) < 0.2
    assert m.summarize()["nan_detected"] == 0.0
