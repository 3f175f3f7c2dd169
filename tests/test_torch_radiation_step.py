"""The radiation on Model.step's own path (config_radt_lw_scheme /
config_radt_sw_scheme, config_radtlw_interval / config_radtsw_interval),
float64 on the CPU.

  - MPAS's alarm: step n rings when n is 0 or a multiple of the interval
    lies in (t - dt, t]; rt_diabatic_tend holds between rings; radiation
    off makes no call and no `rad.*` span, radiation on tiles each call
    with top-level `rad.*` spans; a mismatch of the four keys raises
    ValueError naming its key, and so does sharding a radiating model; the
    CLI's `--radt-steps n` rings every n steps at a dt that is not round; a
    model rebuilt at step 4 (as a restart resumes one) rings on the steps
    of one that ran straight through;
  - the step's radiation equals the plain radiation of the benchmark's
    reference (benchmark/references/plain_camrad.py, which imports nothing
    of the port) at 1e-10 of the largest heating, on generate_mesh(3) at
    8 and 26 levels, on the day and the night side of the date line, with
    seeded condensate, without condensate and dry;
  - build_model with radiation, 7 steps on generate_mesh(2), equals the
    benchmark's reference of `jw_moist_wsm6_camrad` in u, w, theta_m,
    rho_zz, scalars and rainnc at 1e-10."""

import json
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from mpas_tpu_torch.__main__ import radiation_namelist
from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics.model import (build_model, radiation_interval,
                                           radiation_rings)
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.mesh.loader import load_mesh
from mpas_tpu_torch.probes import seeded_condensate

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, inputs  # noqa: E402
from benchmark.references import (  # noqa: E402
    jw_moist_wsm6_camrad as ref_camrad)
from benchmark.references.plain_camrad import PlainRadiation  # noqa: E402

RAD = dict(config_radt_lw_scheme="cam_lw", config_radt_sw_scheme="cam_sw",
           config_radtlw_interval=1800.0, config_radtsw_interval=1800.0)
MOIST = dict(config_moisture=True, config_microphysics="wsm6",
             config_pbl="ysu_lite")
KW = dict(config_ztop=30000.0, dtype="float64", config_dt=300.0)
REL = 1e-10


def model(level=2, levels=6, radiation=RAD, **changes):
    nl = Namelist(**KW, config_nvertlevels=levels, **MOIST, **radiation)
    return build_model(nl.replace(**changes), generate_mesh(levels=level),
                       device="cpu")


def ring_steps(m, n):
    """The steps of m's next n on which the radiation ran."""
    rang = []
    for _ in range(n):
        calls = m.radiation_calls
        m.step(1)
        if m.radiation_calls > calls:
            rang.append(m.step_count - 1)
    return rang


@pytest.mark.parametrize("dt,interval,steps,expected", [
    (300.0, 1800.0, 13, [0, 6, 12]),
    (720.0, 1800.0, 11, [0, 3, 5, 8, 10]),
    (300.0, 300.0, 4, [0, 1, 2, 3]),
    (720.0, 300.0, 3, [0, 1, 2]),
    (1e-1 * 3, 0.9, 7, [0, 3, 6]),
])
def test_the_alarm(dt, interval, steps, expected):
    assert [n for n in range(steps)
            if radiation_rings(n, dt, interval)] == expected


@pytest.mark.parametrize("dt,n", [(275.956983, 5), (113.611186, 3)])
def test_the_alarm_of_radt_steps(dt, n):
    """The CLI's `--radt-steps n` rings every n steps from step 0 at a dt
    that is not round (the CLI's default dt, 4 dx in km, is not), where n *
    dt multiplied in floats lies above n dt."""
    nl = radiation_namelist(Namelist(config_dt=dt), n)
    interval = radiation_interval(nl)
    assert Fraction(interval) > n * Fraction(dt)
    assert [k for k in range(12 * n) if radiation_rings(k, dt, interval)] \
        == list(range(0, 12 * n, n))


@pytest.mark.parametrize("dt,steps", [(300.0, 13), (720.0, 11)])
def test_the_reference_keeps_the_same_alarm(dt, steps, tmp_path):
    """The benchmark's reference, which counts its rings as MPAS's alarm
    does, radiates on the steps the port's alarm rings on."""
    namelist = dict(KW, config_nvertlevels=4, config_dt=dt, **MOIST, **RAD)
    ref = ref_camrad.build(namelist, inputs.grid_file(2, tmp_path),
                           torch.device("cpu"), torch.float64)
    rang, tendency = [], ref.radiation.tendency

    def counted(state, julian):
        rang.append(ref.step_count)
        assert julian == ref.step_count * dt / 86400.0
        return tendency(state, julian)

    ref.radiation.tendency = counted
    ref.step(steps)
    assert rang == [n for n in range(steps)
                    if radiation_rings(n, dt, 1800.0)]


def test_heating_holds_between_rings():
    m = model(config_radtlw_interval=600.0, config_radtsw_interval=600.0)
    assert m.radiation_calls == 0 and "physics_init" in m.setup_seconds
    held = m.state.rt_diabatic_tend.clone()
    assert not held.any()
    for n in range(5):
        m.step(1)
        rt = m.state.rt_diabatic_tend
        assert torch.equal(rt, held) == (n % 2 == 1), n
        held = rt.clone()
    assert m.radiation_calls == 3 and m.radiation_diags is not None
    assert float(held.abs().max()) > 0.0


def rad_spans(m, n):
    """(name, start, end) of the `rad.*` host events of n steps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.step(n)
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("rad.")),
                  key=lambda e: e[1:])


def test_radiation_off_makes_no_call():
    off = model(radiation={})
    assert off.radiation_interval is None and off._radiation_fn is None
    assert "physics_init" not in off.setup_seconds
    assert rad_spans(off, 2) == []
    assert off.radiation_calls == 0
    assert not off.state.rt_diabatic_tend.any()


def test_the_spans_tile_each_call():
    m = model()
    found = rad_spans(m, 2)                      # step 0 rings, step 1 not
    assert {n for n, _, _ in found} == {"rad.columns", "rad.sw", "rad.lw",
                                        "rad.couple"}
    assert sum(n == "rad.sw" for n, _, _ in found) == 1
    for (_, _, end), (_, start, _) in zip(found, found[1:]):
        assert end <= start                      # top level, disjoint


@pytest.mark.parametrize("changes,key", [
    (dict(config_radt_sw_scheme="off"), "config_radt_sw_scheme"),
    (dict(config_radt_lw_scheme="off"), "config_radt_lw_scheme"),
    (dict(config_radt_lw_scheme="rrtmg_lw"), "config_radt_lw_scheme"),
    (dict(config_radt_sw_scheme="rrtmg_sw"), "config_radt_sw_scheme"),
    (dict(config_radtsw_interval=3600.0), "config_radtsw_interval"),
    (dict(config_radtlw_interval=0.0, config_radtsw_interval=0.0),
     "config_radtlw_interval"),
])
def test_mismatched_keys_are_refused(changes, key):
    nl = Namelist(**RAD).replace(**changes)
    with pytest.raises(ValueError, match=key):
        radiation_interval(nl)
    with pytest.raises(ValueError, match=key):
        build_model(nl.replace(config_nvertlevels=4),
                    generate_mesh(levels=2), device="cpu")


def test_a_dry_run_may_radiate():
    assert radiation_interval(Namelist()) is None
    assert radiation_interval(Namelist(**RAD)) == 1800.0
    m = build_model(Namelist(**KW, config_nvertlevels=4, **RAD),
                    generate_mesh(levels=2), device="cpu")
    m.step(1)
    assert m.radiation_calls == 1 and m.state.scalars is None
    assert float(m.state.rt_diabatic_tend.abs().max()) > 0.0


def test_the_sharded_runner_refuses_a_radiating_model():
    """The sharded step has no radiation alarm: sharding a model whose
    namelist turns the radiation on is refused, not run without it."""
    from mpas_tpu_torch.parallel.sharded import shard_model
    with pytest.raises(ValueError, match="config_radt_lw_scheme"):
        shard_model(model(levels=4), 2)


def test_a_rebuilt_model_rings_on_the_same_steps():
    """A model rebuilt at step 4 and given the state there (what
    io.history.load_restart does) rings where the straight run rings, and
    ends bit-equal to it."""
    changes = dict(config_dt=720.0)
    straight = model(**changes)
    assert ring_steps(straight, 11) == [0, 3, 5, 8, 10]
    first = model(**changes)
    assert ring_steps(first, 4) == [0, 3]
    resumed = model(**changes)
    resumed.state, resumed.step_count = first.state, first.step_count
    assert ring_steps(resumed, 7) == [5, 8, 10]
    for name in ("u", "w", "theta_m", "rho_zz", "scalars", "rt_diabatic_tend"):
        assert torch.equal(getattr(straight.state, name),
                           getattr(resumed.state, name)), name


@pytest.fixture(scope="module", params=[8, 26], ids=["L8", "L26"])
def level3(request):
    """name -> a generate_mesh(3) model at the level count: WSM6 with
    condensate seeded, WSM6 as initialized (no condensate), and dry."""
    mesh = generate_mesh(levels=3)
    done = {}

    def get(name):
        if name not in done:
            moist = {} if name == "dry" else MOIST
            nl = Namelist(**KW, config_nvertlevels=request.param, **moist,
                          **RAD)
            m = build_model(nl, mesh, device="cpu")
            if name == "seeded":
                m.state = seeded_condensate(m.state, seed=5)
            vg = m.vgrid
            done[name] = (m, PlainRadiation(
                m.mesh.latCell, m.mesh.lonCell, (vg.cf1, vg.cf2, vg.cf3),
                m.static.pressure_base))
        return done[name]

    return get


@pytest.mark.parametrize("julian", [0.0, 0.5], ids=["noon_180E", "noon_0E"])
@pytest.mark.parametrize("name", ["seeded", "none", "dry"])
def test_step_radiation_matches_the_plain_reference(level3, name, julian):
    m, plain = level3(name)
    m.step_count = round(julian * 86400.0 / m.namelist.config_dt)
    assert m.julian() == julian
    rthraten, diags = m.radiate()
    got = m.state.rt_diabatic_tend
    want = plain.tendency(m.state, julian)
    assert torch.equal(got, rthraten.T)
    scale = float(want.abs().max())
    assert scale > 0.0
    assert float((got - want).abs().max()) <= REL * scale
    # day and night both present, and clouds where condensate was seeded
    day_share = (diags["fsnt"] > 0).double().mean()
    assert 0.2 < float(day_share) < 0.8
    assert (float(diags["cldfra"].max()) == 1.0) == (name == "seeded")


def test_seven_steps_match_the_benchmark_reference(tmp_path):
    """The benchmark configuration's namelist (float64, 6 levels) on the
    grid file of generate_mesh(2): the port's build_model against the
    reference module of `jw_moist_wsm6_camrad`, after 7 steps of 300 s
    (the radiation at steps 0 and 6), each field within 1e-10 of its
    largest magnitude."""
    config = json.loads((ROOT / "benchmark" / "configs"
                         / "jw_moist_wsm6_camrad.json").read_text())
    namelist = dict(config["namelist"], dtype="float64", config_nvertlevels=6,
                    config_ztop=30000.0, config_dt=300.0)
    grid = inputs.grid_file(2, tmp_path)
    port = build_model(Namelist(**namelist), load_mesh(str(grid)),
                       device="cpu")
    ref = ref_camrad.build(namelist, grid, torch.device("cpu"), torch.float64)
    cond = np.random.default_rng(3).random(port.state.scalars[1:].shape)
    cond = 2e-4 * cond * (cond > 0.4)
    port.state = check.with_inputs(port.state, cond)
    ref.state = check.with_inputs(ref.state, cond)
    port.step(7)
    ref.step(7)
    assert port.radiation_calls == 2
    p, r = check.fields(port.state), check.fields(ref.state)
    assert sorted(p) == sorted(r) == sorted(check.FIELDS)
    for k in r:
        scale = float(r[k].abs().max())
        assert float((p[k] - r[k]).abs().max()) <= REL * scale, k
    assert float(ref.state.rt_diabatic_tend.abs().max()) > 0.0
