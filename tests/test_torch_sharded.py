"""mpas_tpu_torch.parallel.sharded (the stacked back end) against
mpas_tpu.parallel.sharded.shard_model(m, 4) on 8 virtual CPU devices,
float64, generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8
levels; the JAX model's state carried across with `from_jax_numpy`.

  - 2 steps, dry JW and JW + WSM6 + PBL, each with both
    config_halo_exchange modes: owned entries (gather_state) at 1e-11 of
    each field's largest magnitude (tests/test_sharded.py's bound; moist at
    its moist bound, 1e-10: mpas_tpu's sharded moist step leaves the
    species' halo stale at the step's top, which the port repairs), the raw
    [S, K, L] blocks where mpas_tpu's are finite (dry), and the port's
    single-device step on owned entries;
  - the halo exchange: the stacked source vector of each plan against the
    all_to_all algebra, the exchange count per step against mpas_tpu's
    collective count, the bytes against partition.exchange_bytes_per_step;
  - summarize against host_summarize_oracle and mpas_tpu's;
  - sharded radiation against the single-device call;
  - sharded checkpoints across packages, both ways, and the refusals;
  - the gathered history against the single-device one;
  - weights.stack_blocks / split_blocks."""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.io import history as JH
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.parallel import sharded as JS

from mpas_tpu_torch.io import history as TH
from mpas_tpu_torch.mesh.netcdf_io import read_netcdf
from mpas_tpu_torch.parallel import halo as TH_halo
from mpas_tpu_torch.parallel import partition as TP
from mpas_tpu_torch.parallel import sharded as TS
from mpas_tpu_torch.weights import split_blocks, stack_blocks

from test_torch_cellform import KW
from test_torch_coupling import port_model

S = 4
OWNED_RTOL = 1e-11
CONFIGS = {"dry": dict(),
           "wsm6": dict(config_moisture=True, config_microphysics="wsm6",
                        config_pbl="ysu_lite")}
FIELDS = ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p", "exner",
          "pressure_p", "ru", "rw")


@pytest.fixture(scope="module")
def base():
    """name -> the JAX single-device model of each configuration, built
    once (the sharded runs copy it)."""
    mesh = j_generate(levels=3, lloyd_iterations=2)
    return {name: j_build(namelist=JNamelist(**KW, **cfg), mesh=mesh)
            for name, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def runs(base):
    """(config, mode) -> (JAX sharded model, port sharded model, port
    single-device model, exchanges counted in the port's 2 steps), all 2
    steps on, built when first asked for."""
    done = {}

    def get(name, mode):
        if (name, mode) not in done:
            m = base[name]
            jm = dataclasses.replace(m, namelist=m.namelist.replace(
                config_halo_exchange=mode))
            js = JS.shard_model(jm, S)
            pm = port_model(jm)
            ts = TS.shard_model(pm, S)
            assert ts.rank is None and not ts.mesh_arrays.owner_aligned
            js.step(2)
            TH_halo.exchanges = TH_halo.halo_bytes = 0
            ts.step(2)
            counts = (TH_halo.exchanges, TH_halo.halo_bytes)
            pm.step(2)
            done[(name, mode)] = (js, ts, pm, counts)
        return done[(name, mode)]

    return get


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("mode", ["ppermute", "all_to_all"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_stacked_step_matches_jax_sharded_step(base, runs, name, mode):
    """Dry, the two algorithms are the same: owned entries at 1e-11 and
    the raw blocks too. Moist, mpas_tpu's step leaves the species' outer
    halo ring stale at the step's top (see
    test_species_halo_refreshed_at_step_top), so it is held at its own
    moist test's bound, 1e-10, on owned entries."""
    js, ts, pm, _ = runs(name, mode)
    mesh = base[name].mesh
    gj, gt = js.gather_state(mesh), ts.gather_state(pm.mesh)
    names = FIELDS + (("scalars", "rainnc") if name == "wsm6" else ())
    tol = OWNED_RTOL if name == "dry" else 1e-10
    for n in names:
        assert rel(gj[n], gt[n]) < tol, n
    # against the port's own single-device step
    for n in names:
        assert rel(getattr(pm.state, n).numpy(), gt[n]) < 1e-12, n
    if name != "dry":
        return
    # the raw blocks, halo slots and padding included, where mpas_tpu's are
    # finite: each shard read its own block only
    blocks = ts.state_blocks()
    for n in names:
        a = np.asarray(getattr(js.state, n))
        assert a.shape == blocks[n].shape, n
        fin = np.isfinite(a)
        assert fin.mean() > 0.9, n
        assert rel(np.where(fin, a, 0.0), np.where(fin, blocks[n], 0.0)) \
            < OWNED_RTOL, n


def test_species_halo_refreshed_at_step_top(base, runs):
    """The fault this port repairs: mpas_tpu's sharded moist step refreshes
    no species at the step's top, so the garbage transport leaves in their
    outer halo ring reaches the moist coefficients and, from there, owned
    entries: its sharded and single-device steps differ (tests/
    test_sharded.py allows 1e-10 for it). The port's step-top refresh
    carries the species, and its stacked moist step is the single-device
    step bit for bit."""
    js, ts, pm, _ = runs("wsm6", "ppermute")
    gj, gt = js.gather_state(base["wsm6"].mesh), ts.gather_state(pm.mesh)
    for n in ("u", "theta_m", "scalars", "rainnc"):
        assert np.array_equal(getattr(pm.state, n).numpy(), gt[n]), n
    # the single-device steps of the two packages agree far closer than
    # mpas_tpu's sharded step does with either
    single = port_model(base["wsm6"])
    jm = base["wsm6"]
    s = jm.state
    for _ in range(2):
        s = jm.step_fn(s)
    assert rel(np.asarray(s.u), single.step(2).u.numpy()) < 1e-13
    assert rel(np.asarray(s.u), gj["u"]) > 1e3 * rel(np.asarray(s.u), gt["u"])


@pytest.mark.parametrize("mode", ["ppermute", "all_to_all"])
def test_source_vector_is_the_all_to_all_exchange(base, mode):
    """Both plans give the same source vector, and a gather at it is the
    all_to_all algebra of mpas_tpu/parallel/halo.py, per shard."""
    p = TP.build_partition(base["dry"].mesh, S)
    rng = np.random.default_rng(3)
    for ent in ("cell", "edge", "vertex"):
        xt = getattr(p, f"{ent}_x")
        L = getattr(p, f"{ent}_l2g").shape[1]
        src = TS.stacked_source(xt, L, mode)
        assert np.array_equal(src, TS.stacked_source(xt, L, "all_to_all"))
        x = rng.normal(size=(3, S * L))
        blocks = split_blocks(x, S)                           # [S, 3, L]
        send = np.stack([blocks[d][:, xt.send_idx[d]] * xt.send_mask[d]
                         for d in range(S)])                  # [d, 3, s, m]
        for s in range(S):
            recv = send[:, :, s].transpose(1, 0, 2).reshape(3, -1)
            new = recv[:, xt.recv_pos[s]]
            ref = np.where(xt.recv_is_halo[s] > 0, new, blocks[s])
            assert np.array_equal(split_blocks(x[:, src], S)[s], ref), ent


@pytest.mark.parametrize("name", list(CONFIGS))
def test_exchange_count_and_bytes(runs, name):
    """12 packed exchanges a dry step, as mpas_tpu's collective count
    (tests/test_sharded.py: 6 cell + 6 edge), 2 more with scalar transport;
    the bytes are exchange_bytes_per_step's volume of the same refreshes."""
    js, ts, pm, (exchanges, nbytes) = runs(name, "ppermute")
    n_scalars = 0 if name == "dry" else ts.state.scalars.shape[0]
    acc = TP.exchange_bytes_per_step(
        ts.partition, ts.namelist, ts.namelist.config_nvertlevels,
        bytes_per_value=8, n_scalars=n_scalars)
    assert exchanges == 2 * acc["packed_exchanges"]
    assert exchanges == 2 * (12 if name == "dry" else 14)
    # the step-top refresh of the species rides in the cell exchange that
    # exchange_bytes_per_step counts without them
    species = n_scalars * acc["cell_field_bytes"]
    # exchange_bytes_per_step counts every field K deep; w, rw and wwAvg
    # are K+1 deep, so the step moves a little more than its estimate
    assert acc["total_bytes_per_step"] < nbytes / 2 - species < 1.1 * acc[
        "total_bytes_per_step"]


def test_summarize_matches_oracle_and_jax(runs):
    js, ts, _, _ = runs("dry", "ppermute")
    a = TS.sharded_summarize(ts)
    b = TS.host_summarize_oracle(ts)
    c = JS.sharded_summarize(js)
    assert a["nan_detected"] is b["nan_detected"] is False
    for k in ("w_min", "w_max", "u_min", "u_max", "wsp_max", "theta_min",
              "theta_max"):
        assert a[k] == b[k], k
        np.testing.assert_allclose(a[k], c[k], rtol=1e-11, err_msg=k)


def test_sharded_radiation_matches_single_device(base):
    from mpas_tpu_torch.physics.driver import physics_init
    phys = physics_init()
    pm = port_model(base["wsm6"])
    ts = TS.shard_model(pm, S)
    with pytest.raises(RuntimeError, match="enable_physics"):
        ts.apply_physics(phys)
    ts.enable_physics(phys)
    ts.apply_physics(phys, julian=80.25)
    pm.apply_physics(phys, julian=80.25)
    a = pm.state.rt_diabatic_tend.numpy()
    assert np.abs(a).max() > 0.0
    assert rel(a, ts.gather_state(pm.mesh)["rt_diabatic_tend"]) < 1e-10


@pytest.mark.parametrize("writer", ["mpas_tpu", "mpas_tpu_torch"])
def test_sharded_checkpoints_across_packages(runs, tmp_path, writer):
    """A 4-shard checkpoint written by either package restores into the
    other bit for bit; the shard count and the block shapes are checked."""
    js, ts, pm, _ = runs("wsm6", "ppermute")
    path = str(tmp_path / "ck.npz")
    if writer == "mpas_tpu":
        JH.save_restart(path, js)
        before = ts.state
        TH.load_restart(path, ts)
        try:
            blocks = ts.state_blocks()
            for f in dataclasses.fields(js.state):
                x = getattr(js.state, f.name)
                if x is not None:
                    assert np.array_equal(np.asarray(x), blocks[f.name]), f.name
            assert ts.step_count == js.step_count
        finally:
            ts.state = before
    else:
        TH.save_restart(path, ts)
        with np.load(path) as f:
            assert int(f["__n_shards__"]) == S
            assert f["u"].shape == ts.block_shape("u")
        before = js.state
        JH.load_restart(path, js)
        try:
            blocks = ts.state_blocks()
            for k, v in blocks.items():
                assert np.array_equal(np.asarray(getattr(js.state, k)), v), k
        finally:
            js.state = before
    with pytest.raises(ValueError, match="shards"):
        TH.load_restart(path, pm)
    other = TS.shard_model(pm, 2)
    with pytest.raises(ValueError, match="shards"):
        TH.load_restart(path, other)


def test_sharded_restart_round_trip(base, tmp_path):
    """save, step, load, step: the same state as stepping on, bit for
    bit."""
    ts = TS.shard_model(port_model(base["dry"]), S)
    ts.step(1)
    path = str(tmp_path / "ck.npz")
    TH.save_restart(path, ts)
    ts.step(1)
    ref = ts.state_blocks()
    TH.load_restart(path, ts)
    assert ts.step_count == 1
    ts.step(1)
    for k, v in ts.state_blocks().items():
        assert np.array_equal(v, ref[k]), k
    TH.save_restart_torch(str(tmp_path / "ck.pt"), ts)
    TH.load_restart_torch(str(tmp_path / "ck.pt"), ts)
    assert ts.step_count == 2


def test_gathered_history_matches(base, runs, tmp_path):
    """At step 0 the gathered history equals the single-device history; 2
    steps on, the port's gathered history equals mpas_tpu's."""
    pm = port_model(base["dry"])
    ts = TS.shard_model(pm, S)
    p1, p2 = str(tmp_path / "sharded.nc"), str(tmp_path / "single.nc")
    TH.write_history(p1, pm, state=TH.gathered_state(ts, pm))
    TH.write_history(p2, pm)
    d1, d2 = read_netcdf(p1), read_netcdf(p2)
    for k in d2:
        if k != "_dims":
            assert np.array_equal(d1[k], d2[k]), k
    js, ts2, pm2, _ = runs("dry", "ppermute")
    jm = base["dry"]
    p3, p4 = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    JH.write_history(p3, jm, state=JH.gathered_state(js, jm), full_3d=True)
    TH.write_history(p4, pm2, state=TH.gathered_state(ts2, pm2), full_3d=True)
    d3, d4 = read_netcdf(p3), read_netcdf(p4)
    for k in ("u", "v", "w", "theta", "rho", "pressure", "surface_pressure"):
        assert rel(d3[k], d4[k]) < OWNED_RTOL, k


def test_stack_and_split_blocks():
    rng = np.random.default_rng(0)
    b = rng.normal(size=(S, 2, 3, 5))
    x = stack_blocks(b)
    assert x.shape == (2, 3, S * 5)
    assert np.array_equal(x[..., 5:10], b[1])
    assert np.array_equal(split_blocks(x, S), b)
    t = torch.from_numpy(b)
    assert torch.equal(stack_blocks(t), torch.from_numpy(x))
    assert torch.equal(split_blocks(stack_blocks(t), S), t)
