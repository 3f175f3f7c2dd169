"""mpas_tpu_torch.io.history against mpas_tpu.io.history, float64 on the
CPU, on generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels,
moist JW with Kessler (so `scalars` and `rainnc` are in the files).

  - a history (level 0 and full 3-D, one snapshot and a time series)
    written by the port holds the variables, dimensions and values of the
    one mpas_tpu writes for the same state, at 1e-12;
  - save_restart / load_restart round-trip bit-equal, and a resumed step is
    bit-equal to the step from the saved state;
  - a checkpoint of either package restores into the other, bit-equal;
  - the named errors: a moist checkpoint into a dry model, a shape
    mismatch, the layout version, the shard count;
  - the torch.save pair round-trips bit-equal and checks the same markers."""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.io import history as JH
from mpas_tpu.mesh.generator import generate_mesh as j_generate

from mpas_tpu_torch.io import history as TH
from mpas_tpu_torch.mesh.netcdf_io import read_netcdf

from test_torch_cellform import KW, carry
from test_torch_coupling import port_model
from test_torch_ops import assert_close

MOIST = dict(config_moisture=True, config_microphysics="kessler")


@pytest.fixture(scope="module")
def models():
    """(JAX model one step on, port model on its state): w, v and the
    species are all non-trivial."""
    m = j_build(namelist=JNamelist(**KW, **MOIST),
                mesh=j_generate(levels=3, lloyd_iterations=2))
    m.step(1)
    return m, port_model(m)


@pytest.fixture
def port(models):
    """The port model, its state and step count put back after the test."""
    pm = models[1]
    state, count = pm.state, pm.step_count
    yield pm
    pm.state, pm.step_count = state, count


def same_files(a, b, rtol=1e-12):
    da, db = read_netcdf(a), read_netcdf(b)
    assert set(da) == set(db) and da["_dims"] == db["_dims"]
    for k in da:
        if k == "_dims":
            continue
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        assert_close(da[k], db[k], rtol=rtol)
    return db


def assert_state_equal(state, ref):
    """Every field of a port State bit-equal to `ref` (a port or JAX
    State)."""
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(ref, f.name)
        if b is None:
            assert a is None, f.name
            continue
        assert np.array_equal(a.numpy(), np.asarray(b)), f.name


@pytest.mark.parametrize("full_3d", [False, True], ids=["level0", "full3d"])
def test_history_matches_jax(tmp_path, models, full_3d):
    m, pm = models
    JH.write_history(str(tmp_path / "j.nc"), m, full_3d=full_3d)
    TH.write_history(str(tmp_path / "t.nc"), pm, full_3d=full_3d)
    d = same_files(tmp_path / "j.nc", tmp_path / "t.nc")
    K = pm.state.theta_m.shape[0]
    assert d["theta"].shape == (1, pm.mesh.nCells, K if full_3d else 1)
    assert d["u"].shape[1] == pm.mesh.nEdges
    sp = d["surface_pressure"]
    assert sp.min() > 9.0e4 and sp.max() < 1.06e5
    assert np.abs(d["w"]).max() > 0.0


def test_time_series_history_matches_jax(tmp_path, models, port):
    """Three snapshots, a step apart, written by HistoryWriter: the same
    three states (the JAX model's, carried across) give the same file at
    1e-12."""
    m, _ = models
    jw, tw = JH.HistoryWriter(m, full_3d=True), TH.HistoryWriter(port,
                                                               full_3d=True)
    js = m.state
    for i in range(3):
        jw.record(state=js, time_value=float(i))
        tw.record(state=carry(m, js)[3], time_value=float(i))
        js = m.step_fn(js)
    jw.write(str(tmp_path / "j.nc"))
    tw.write(str(tmp_path / "t.nc"))
    d = same_files(tmp_path / "j.nc", tmp_path / "t.nc")
    assert d["_dims"]["Time"] == 3
    np.testing.assert_array_equal(d["xtime"], [0.0, 1.0, 2.0])
    assert np.abs(d["u"][2] - d["u"][0]).max() > 0.0
    # the default time of a record is the model's step count
    tw2 = TH.HistoryWriter(port)
    tw2.record()
    assert tw2.snapshots[0][0] == float(port.step_count)


def test_restart_roundtrip_and_exact_resume(tmp_path, port):
    path = str(tmp_path / "restart.npz")
    s0, count = port.state, port.step_count
    TH.save_restart(path, port)
    ref = port.step_fn(s0)
    port.state = s0.replace(u=s0.u + 1.0, scalars=s0.scalars * 2.0)
    port.step_count = 99
    TH.load_restart(path, port)
    assert port.step_count == count
    assert_state_equal(port.state, s0)
    assert port.state.u.is_contiguous()
    assert_state_equal(port.step_fn(port.state), ref)


def test_jax_checkpoint_restores_into_port(tmp_path, models, port):
    m, _ = models
    path = str(tmp_path / "jax.npz")
    JH.save_restart(path, m)
    port.state = port.state.replace(theta_m=port.state.theta_m * 1.01)
    TH.load_restart(path, port)
    assert port.step_count == m.step_count
    assert_state_equal(port.state, m.state)


def test_port_checkpoint_restores_into_jax(tmp_path, models, port):
    m, _ = models
    path = str(tmp_path / "port.npz")
    port.state = port.state.replace(w=port.state.w * 0.5)
    port.step_count = 7
    TH.save_restart(path, port)
    j_state, j_count = m.state, m.step_count
    try:
        JH.load_restart(path, m)
        assert m.step_count == 7
        assert_state_equal(port.state, m.state)
    finally:
        m.state, m.step_count = j_state, j_count


def rewrite(path, **changes):
    with np.load(path) as f:
        data = dict(f)
    data.update(changes)
    for k, v in changes.items():
        if v is None:
            del data[k]
    np.savez_compressed(path, **data)


@pytest.mark.parametrize("fault,match", [
    ("moist_into_dry", "config mismatch"), ("shape", "shape"),
    ("layout", "layout version"), ("unmarked", "layout version"),
    ("shards", "shards")])
def test_restart_named_errors(tmp_path, port, fault, match):
    path = str(tmp_path / "ck.npz")
    TH.save_restart(path, port)
    if fault == "moist_into_dry":
        port.state = port.state.replace(scalars=None, rainnc=None)
    elif fault == "shape":
        rewrite(path, u=np.zeros((3, 4)))
    elif fault == "layout":
        rewrite(path, __layout__=np.asarray(0))
    elif fault == "unmarked":
        rewrite(path, __layout__=None)
    else:
        rewrite(path, __n_shards__=np.asarray(4))
    with pytest.raises(ValueError, match=match):
        TH.load_restart(path, port)


def test_torch_save_pair_roundtrip(tmp_path, port):
    path = str(tmp_path / "ck.pt")
    s0, count = port.state, port.step_count
    TH.save_restart_torch(path, port)
    payload = torch.load(path, weights_only=True)
    assert int(payload["__layout__"]) == TH.RESTART_LAYOUT_VERSION
    with np.load(TH.save_restart(str(tmp_path / "ck.npz"), port)) as f:
        assert set(payload) == set(f.files)
    port.state = s0.replace(u=s0.u + 1.0, theta_m=s0.theta_m * 1.01)
    port.step_count = count + 5
    TH.load_restart_torch(path, port)
    assert port.step_count == count
    assert_state_equal(port.state, s0)
    payload["__layout__"] = torch.tensor(0)
    torch.save(payload, path)
    with pytest.raises(ValueError, match="layout version"):
        TH.load_restart_torch(path, port)
