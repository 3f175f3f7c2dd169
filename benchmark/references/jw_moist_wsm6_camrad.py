"""The reference of `jw_moist_wsm6_camrad`: the frozen dycore of
`benchmark/reference/` (JW moist, WSM6, the PBL) with the plain CAM-slot
radiation of `plain_camrad.py` on MPAS's radiation alarm.

`build(namelist, grid, device, dtype)` takes the four radiation keys off
the namelist, builds the frozen dycore from the rest and wraps its
`step_fn`: at the start of each step on which the alarm rings, the
radiation of the state goes into `rt_diabatic_tend`, which the dycore's
tendencies and recovery consume and which holds until the next ring. The
alarm rings at time 0, then on the first step whose start has reached the
next ring time, one interval after the last. The step count is the
model's own, so the first call sees the seeded condensate the harness puts
into the state before the first step, and the harness's rounding of the
controls wraps the radiation too. Nothing of the program is imported.
"""

from __future__ import annotations

from benchmark.reference.config import Namelist
from benchmark.reference.dynamics.model import build_model
from benchmark.reference.mesh.loader import load_mesh
from benchmark.references.plain_camrad import PlainRadiation

# the radiation keys and the one value of each scheme this reference carries
SCHEMES = {"config_radt_lw_scheme": "cam_lw",
           "config_radt_sw_scheme": "cam_sw"}
INTERVALS = ("config_radtlw_interval", "config_radtsw_interval")


def radiation_interval(namelist: dict) -> float:
    """The one radiation interval [s] of the namelist's keys; a scheme
    this reference does not carry, or two intervals, raise ValueError."""
    for key, scheme in SCHEMES.items():
        if namelist.get(key, "off") != scheme:
            raise ValueError(f"{key} = {namelist.get(key, 'off')!r}: this "
                             f"reference carries {scheme!r} only")
    lw, sw = (float(namelist[k]) for k in INTERVALS)
    if lw != sw or not lw > 0:
        raise ValueError(f"{INTERVALS[0]} = {lw}, {INTERVALS[1]} = {sw}: "
                         f"this reference takes one positive interval")
    return lw


def build(namelist: dict, grid, device, dtype):
    interval = radiation_interval(namelist)
    dycore_keys = {k: v for k, v in namelist.items()
                   if k not in SCHEMES and k not in INTERVALS}
    model = build_model(Namelist(**dycore_keys), load_mesh(str(grid)),
                        device, dtype)
    vg = model.vgrid
    radiation = PlainRadiation(model.mesh.latCell, model.mesh.lonCell,
                               (vg.cf1, vg.cf2, vg.cf3),
                               model.static.pressure_base)
    dycore = model.step_fn
    dt = model.namelist.config_dt
    alarm = {"rings": 0}      # rings so far; the next at rings * interval

    def step_fn(state):
        start = model.step_count * dt
        if start >= alarm["rings"] * interval:
            alarm["rings"] = int(start // interval) + 1
            state = state.replace(rt_diabatic_tend=radiation.tendency(
                state, start / 86400.0))
        return dycore(state)

    model.step_fn = step_fn
    model.radiation = radiation
    return model
