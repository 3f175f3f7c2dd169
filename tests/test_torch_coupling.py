"""Model.apply_physics against mpas_tpu's, float64 on the CPU, on
generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels.

The JAX model's state is carried across with `from_jax_numpy` into a port
Model on the same containers. Two configurations: JW + Kessler as it
starts, and JW + WSM6 with condensate seeded across the freezing level
(`probes.seeded_condensate`, the helper chip_smoke.py's
agreement_radiation uses), so the cloud optics and WSM6's ice paths run.
The radiation call at julian 80.25 (half the planet in daylight) gives
rt_diabatic_tend and the diagnostics at 1e-12 of each one's largest
magnitude; 2 steps after it give every state field at 1e-10."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.physics import driver as JD

from mpas_tpu_torch import constants
from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.core.state import State
from mpas_tpu_torch.core.vertical import make_vertical_grid
from mpas_tpu_torch.dynamics import srk3
from mpas_tpu_torch.dynamics.model import Model
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.physics import driver as TD
from mpas_tpu_torch.probes import CONDENSATE, seeded_condensate

from test_torch_cellform import KW, carry
from test_torch_ops import assert_close

STEP_RTOL = 1e-10
JULIAN = 80.25
CONFIGS = {"kessler": dict(config_moisture=True, config_microphysics="kessler"),
           "wsm6_seeded": dict(config_moisture=True,
                               config_microphysics="wsm6")}


def port_model(m, state=None):
    """A port Model on the containers carried across from the JAX model `m`
    (and, optionally, a JAX state), with the port's own mesh and vertical
    grid (equal to the reference's, tests/test_torch_copies.py)."""
    tm, tv, tst, ts = carry(m, state)
    nl = Namelist(**m.namelist.to_dict())
    return Model(namelist=nl, mesh=generate_mesh(levels=3, lloyd_iterations=2),
                 vgrid=make_vertical_grid(nl.config_nvertlevels, nl.config_ztop,
                                          nl.config_vertical_stretch),
                 mesh_arrays=tm, vert=tv, static=tst, state=ts,
                 step_fn=srk3.make_step_fn(tst, tm, tv, nl),
                 step_count=m.step_count)


@pytest.fixture(scope="module")
def coupled():
    """name -> (JAX diags, port diags, JAX model, port model) after
    apply_physics, built when first asked for."""
    done = {}

    def get(name):
        if name not in done:
            m = j_build(namelist=JNamelist(**KW, **CONFIGS[name]),
                        mesh=j_generate(levels=3, lloyd_iterations=2))
            pm = port_model(m)
            if name.endswith("_seeded"):
                pm.state = seeded_condensate(pm.state, seed=3)
                m.state = m.state.replace(
                    scalars=jnp.asarray(pm.state.scalars.numpy()))
            jd = m.apply_physics(JD.physics_init(), julian=JULIAN)
            td = pm.apply_physics(TD.physics_init(), julian=JULIAN)
            done[name] = (jd, td, m, pm)
        return done[name]

    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_physics_matches(coupled, name):
    jd, td, m, pm = coupled(name)
    assert set(jd) == set(td)
    assert_close(jd, td)
    rt = pm.state.rt_diabatic_tend
    assert rt.shape == pm.state.theta_m.shape and rt.is_contiguous()
    assert float(rt.abs().max()) > 0.0
    assert_close(np.asarray(m.state.rt_diabatic_tend), rt)
    # clouds where there is condensate, and only the seeded run has it
    assert (td["cldfra"].max() == 1.0) == name.endswith("_seeded")


@pytest.fixture(scope="module")
def two_steps(coupled):
    done = {}

    def get(name):
        if name not in done:
            _, _, m, pm = coupled(name)
            done[name] = (m.step_fn(m.step_fn(m.state)), pm.step_fn(
                pm.step_fn(pm.state)))
        return done[name]

    return get


FIELDS = [f.name for f in dataclasses.fields(State)]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_steps_after_radiation_match(two_steps, name, field):
    jstate, tstate = two_steps(name)
    a, b = getattr(jstate, field), getattr(tstate, field)
    if a is None:
        assert b is None
        return
    assert bool(torch.isfinite(b).all())
    assert_close(np.asarray(a), b, rtol=STEP_RTOL)


def test_julian_defaults_to_model_time(coupled):
    """Without a julian the call takes the model's time in days, as
    mpas_tpu's does; the radiation closure is built once and kept."""
    _, _, m, pm = coupled("kessler")
    fn = pm._radiation_fn
    pm.step_count = 30
    d_default = pm.apply_physics(TD.physics_init())
    d_given = pm.apply_physics(TD.physics_init(),
                               julian=30 * pm.namelist.config_dt / 86400.0)
    assert pm._radiation_fn is fn
    for k in d_default:
        assert np.array_equal(d_default[k], d_given[k]), k


def test_seeded_condensate():
    """Each species lies where its phase can live, a share of the points
    is left clear, the same seed gives the same state, and nothing else of
    the state is touched."""
    m = j_build(namelist=JNamelist(**KW, config_moisture=True,
                                   config_microphysics="wsm6"),
                mesh=j_generate(levels=2, lloyd_iterations=0))
    _, _, _, ts = carry(m)
    seeded = seeded_condensate(ts, seed=1)
    s = seeded.scalars
    t = (ts.theta_m / (1.0 + constants.rvord * ts.scalars[0]) * ts.exner).numpy()
    assert torch.equal(s[0], ts.scalars[0])
    assert float(ts.scalars[1:].abs().max()) == 0.0        # the JW start
    for i, (name, q, phase) in enumerate(CONDENSATE, start=1):
        x = s[i].numpy()
        home = (t > 268.0) if phase == "liquid" else (t > 220.0) & (t < 273.15)
        assert x.max() <= 1.5 * q and (x[~home] == 0.0).all(), name
        share = (x[home] > 0).mean()
        assert 0.55 < share < 0.85, (name, share)
    both = ((s[1].numpy() > 0) & (s[3].numpy() > 0)).any()
    assert both                              # liquid and ice in one place
    assert torch.equal(seeded_condensate(ts, seed=1).scalars, s)
    assert not torch.equal(seeded_condensate(ts, seed=2).scalars, s)
    assert seeded.theta_m is ts.theta_m
