"""Top-level model assembly and run loop.

The port of `mpas_tpu.dynamics.model`: host-side setup (mesh, coefficient
builders, the initial condition of `config_init_case`, all numpy) followed
by the SRK3 step on one device.
There is no default grid file: a mesh is passed in, or the icosahedral
level-6 mesh (x1.40962) is generated.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Namelist
from ..core import state as core_state
from ..core.vertical import VerticalGrid, make_vertical_grid
from ..init import jw as jw_init
from ..init import mountain_wave as mw_init
from ..init import squall as sq_init
from ..mesh import coefficients as mcoef
from ..mesh.generator import generate_mesh
from ..mesh.loader import Mesh
from ..mesh.orient import orient_edges
from ..mesh.renumber import renumber_mesh
from ..ops import diagnostics as diag_ops
from ..physics import kessler, wsm6
from ..physics.driver import (host_diagnostics, make_radiation_fn,
                              physics_init)
from ..tracing import span
from . import graph as step_graph
from . import srk3

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# config_init_case -> (stage name in Model.setup_seconds, init function);
# any other case is the JW baroclinic wave, as in mpas_tpu
_INIT_CASES = {21: ("init_mountain_wave", mw_init.init_mountain_wave),
               22: ("init_squall", sq_init.init_squall)}
_INIT_DEFAULT = ("init_jw", jw_init.init_jw)
# the radiation schemes the step runs (physics/driver.py's CAM-slot chain),
# by namelist key
RADIATION_SCHEMES = {"config_radt_lw_scheme": "cam_lw",
                     "config_radt_sw_scheme": "cam_sw"}


def radiation_interval(nl: Namelist) -> Optional[float]:
    """The radiation interval [s] of the namelist, None with radiation off.
    The driver solves SW and LW in one call, so the two schemes are on or
    off together, at one interval; anything else raises ValueError naming
    its key."""
    on = {}
    for key, scheme in RADIATION_SCHEMES.items():
        value = getattr(nl, key)
        if value not in ("off", scheme):
            raise ValueError(f"{key} = {value!r}: the port runs 'off' or "
                             f"{scheme!r}")
        on[key] = value != "off"
    if not any(on.values()):
        return None
    for key, value in on.items():
        if not value:
            raise ValueError(f"{key} = 'off' with the other scheme on: the "
                             f"driver solves SW and LW in one call")
    lw, sw = nl.config_radtlw_interval, nl.config_radtsw_interval
    if lw != sw:
        raise ValueError(f"config_radtsw_interval = {sw} differs from "
                         f"config_radtlw_interval = {lw}: the driver solves "
                         f"SW and LW in one call")
    if not lw > 0:
        raise ValueError(f"config_radtlw_interval = {lw}: an interval is "
                         f"positive")
    return float(lw)


def radiation_rings(step: int, dt: float, interval: float) -> bool:
    """MPAS's radiation alarm at the start of step `step`: it rings at time
    0 and then on the first step whose start has reached the next ring
    time, one interval after the last; so step n rings when n is 0 or when
    a multiple of `interval` lies in (t - dt, t], t = n dt. Exact in
    rationals, and a function of the step count alone, so a restart
    resumes on the same alarm. An interval within float rounding of a
    whole number of steps (n * dt multiplied in floats, as the CLI's
    `--radt-steps` does) is that number of steps."""
    if step == 0:
        return True
    steps = Fraction(interval) / Fraction(dt)         # the interval in steps
    whole = round(steps)
    if whole >= 1 and abs(steps - whole) <= whole * Fraction(1, 2 ** 48):
        steps = Fraction(whole)
    return step // steps != (step - 1) // steps


@dataclass
class Model:
    namelist: Namelist
    mesh: Mesh                       # host-side mesh
    vgrid: VerticalGrid              # host-side vertical grid
    mesh_arrays: core_state.MeshArrays
    vert: core_state.VerticalArrays
    static: core_state.StaticState
    state: core_state.State
    step_fn: Callable = None
    step_count: int = 0
    init_fields: dict = field(default_factory=dict)  # host-side init extras
    setup_seconds: dict = field(default_factory=dict)  # build_model by stage
    # the radiation over its device tables: built by build_model when the
    # namelist turns radiation on, else at the first apply_physics
    _radiation_fn: Optional[Callable] = field(default=None, repr=False)
    # the step's radiation interval [s] (config_radtlw_interval), None off
    radiation_interval: Optional[float] = None
    radiation_calls: int = 0         # radiation calls, in the step or not
    # the last call's diagnostics, on the device (nothing copied)
    radiation_diags: Optional[dict] = field(default=None, repr=False)
    # on the card: the step's CUDA graph (dynamics/graph.py), how often a
    # step was captured and replayed, and the step function and state
    # signature of the last eager step, which the next step captures
    graph_captures: int = 0
    graph_replays: int = 0
    _graph: Optional[step_graph.StepGraph] = field(default=None, repr=False)
    _graph_warm: Optional[tuple] = field(default=None, repr=False)

    @property
    def dtype(self):
        return self.state.theta_m.dtype

    @property
    def device(self):
        return self.state.theta_m.device

    def step(self, n: int = 1):
        """n steps; with radiation on (`radiation_interval`), each step on
        which MPAS's radiation alarm rings first runs the radiation into
        rt_diabatic_tend, which the step consumes and which holds until
        the next ring. The radiation runs eagerly.

        On the card the step after the first is captured as one CUDA graph
        and every later step replays it (dynamics/graph.py): the tensors of
        `model.state` are then the graph's buffers, which the next step
        overwrites, so a caller that keeps a state across steps clones it.
        A state the caller assigns is copied into the buffers. On the CPU
        every step runs `step_fn` eagerly."""
        for _ in range(n):
            if self.radiation_interval is not None and radiation_rings(
                    self.step_count, self.namelist.config_dt,
                    self.radiation_interval):
                self.radiate()
            if step_graph.engages(self.state):
                step_graph.advance(self)
            else:
                self.state = self.step_fn(self.state)
            self.step_count += 1
        return self.state

    def julian(self) -> float:
        """Model time in days from MPAS's idealized start
        0000-01-01_00:00:00."""
        return self.step_count * self.namelist.config_dt / 86400.0

    def radiate(self, julian: float | None = None):
        """Run the radiation driver on the current state and couple the
        radiative heating into the dycore via rt_diabatic_tend (the
        physics_driver -> atm_do_timestep coupling, atm_core.rg:64-68),
        which the step consumes; returns (rthraten [C, K], diagnostics), on
        the device. `julian` defaults to the model time in days; the time
        factors come from the radiation's `time_factors(julian)`, so the
        call copies nothing from the host and never waits for the device.

        The columnar radiation keeps the CAM [cols, pver] convention: the
        level-major fields go in as transposed views, which the solver
        reads level-major again without a copy."""
        tp = self._radiation_fn.time_factors(
            self.julian() if julian is None else julian)
        s = self.state
        with span("rad.columns"):
            pressure = self.static.pressure_base + s.pressure_p   # [K, C]
            vg = self.vgrid
            sp = (vg.cf1 * pressure[0] + vg.cf2 * pressure[1]
                  + vg.cf3 * pressure[2])
            qv = s.scalars[0].T if s.scalars is not None else None
            qc = (s.scalars[1].T if s.scalars is not None
                  and s.scalars.shape[0] > 1 else None)
        rthraten, diags = self._radiation_fn(
            self.mesh_arrays.latCell, self.mesh_arrays.lonCell,
            s.theta_m.T, s.exner.T, pressure.T, sp, qv, qc, tp)
        with span("rad.couple"):
            self.state = s.replace(
                rt_diabatic_tend=rthraten.T.contiguous().to(self.dtype))
        self.radiation_calls += 1
        self.radiation_diags = diags
        return rthraten, diags

    def apply_physics(self, phys, julian: float | None = None):
        """`radiate` for a caller's own loop: the radiation built from
        `phys` unless the model has one, then the diagnostics copied to the
        host as numpy arrays ([C, K] or [C]), which waits for the device.
        `julian` defaults to the model time in days."""
        if self._radiation_fn is None:
            self._radiation_fn = make_radiation_fn(phys, self.dtype,
                                                   self.device)
        return host_diagnostics(*self.radiate(julian))

    def summarize(self):
        return {k: float(v) for k, v in
                srk3.summarize_timestep(self.state, self.mesh_arrays).items()}


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def build_model(namelist: Optional[Namelist] = None,
                mesh: Optional[Mesh] = None, device="cuda",
                dtype=None) -> Model:
    """Build all static coefficients, apply the initial condition of
    `config_init_case` (2 JW baroclinic wave, 21 Schar mountain wave, 22
    Weisman-Klemp storm), derive the coupled state and close the step
    function over them. Microphysics brings its species (scalars[0] = qv),
    turns scalar transport on and, with `config_kessler_nfall` = 0, sizes
    the sedimentation substeps from the step and the thinnest layer. `mesh`
    defaults to `generate_mesh(levels=6)` (x1.40962). As in mpas_tpu,
    `config_renumber_mesh` renumbers the mesh (RCM, mesh/renumber.py) and
    then `config_orient_edges` aligns its edges to their owner cells
    (mesh/orient.py) unless the mesh given is aligned already; the model's
    `mesh` is the mesh it runs on. With `config_radt_lw_scheme` "cam_lw"
    and `config_radt_sw_scheme` "cam_sw" the radiation's host tables
    (`physics_init`) and device tables are built once here
    (`setup_seconds["physics_init"]`) and `Model.step` runs it on MPAS's
    alarm every `config_radtlw_interval` seconds; a mismatch of the four
    keys raises ValueError naming the key."""
    nl = namelist or Namelist()
    interval = radiation_interval(nl)
    dev = resolve_device(device)
    dtype = dtype or _DTYPES[nl.dtype]

    seconds, t0 = {}, time.perf_counter()

    def lap(stage):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        seconds[stage], t0 = t1 - t0, t1

    if mesh is None:
        mesh = generate_mesh(levels=6, sphere_radius=nl.config_sphere_radius)
        lap("generate_mesh")
    if nl.config_renumber_mesh:
        mesh, _ = renumber_mesh(mesh)
        lap("renumber_mesh")
    if nl.config_orient_edges and not mesh.edges_owner_aligned:
        mesh, _ = orient_edges(mesh)
        lap("orient_edges")
    mesh.validate()
    vg = make_vertical_grid(nl.config_nvertlevels, nl.config_ztop,
                            nl.config_vertical_stretch)

    # acoustic CFL guard: cs * dts / dx with dts = dt / number_of_sub_steps
    cfl = 340.0 * (nl.config_dt / nl.config_number_of_sub_steps) / mesh.dcEdge.min()
    if cfl > 0.72:
        warnings.warn(
            f"acoustic CFL {cfl:.2f} > 0.72 (dt={nl.config_dt}, min dx="
            f"{mesh.dcEdge.min()/1e3:.0f} km): reduce config_dt (~6 s/km) or "
            f"raise config_number_of_sub_steps", stacklevel=2)
    lap("validate")

    deriv_two = mcoef.compute_deriv_two(mesh)
    lap("deriv_two")
    marr = core_state.mesh_arrays_from_mesh(mesh, nl, dtype, dev,
                                            deriv_two=deriv_two)
    vert = core_state.vertical_arrays_from_grid(vg, dtype, dev)
    lap("mesh_arrays")

    init_stage, init_fn = _INIT_CASES.get(nl.config_init_case, _INIT_DEFAULT)
    static_np, init_np = init_fn(mesh, vg, nl, deriv_two)
    lap(init_stage)
    # host init builds element-major [N, K] arrays; flip to the level-major
    # layout here (zb/zb3 become slot-major [M, K+1, C])
    fT = lambda a: core_state.to_float(np.asarray(a).T, dtype, dev)
    fz = lambda a: core_state.to_float(np.moveaxis(np.asarray(a), 0, 2),
                                       dtype, dev)
    static = core_state.StaticState(
        **{k: (fz(v) if k in ("zb_cell", "zb3_cell") else fT(v))
           for k, v in static_np.items()})

    C, E, V, K = mesh.nCells, mesh.nEdges, mesh.nVertices, vg.nVertLevels
    mp = nl.config_microphysics
    use_mp = mp in srk3.MICROPHYSICS_SPECIES
    n_scalars = (srk3.MICROPHYSICS_SPECIES.get(mp, 0)
                 or (1 if nl.config_moisture else 0))
    if use_mp and not nl.config_scalar_advection:
        # microphysics requires transported moisture species
        nl = nl.replace(config_scalar_advection=True)
    if use_mp and nl.config_kessler_nfall == 0:
        # one substep count serves every species that sediments, so it is
        # sized against the largest of their fall-speed caps
        dz_min = float(np.min(static_np["zgrid"][:, 1:]
                              - static_np["zgrid"][:, :-1]))
        max_vt = (kessler.MAX_VT if mp == "kessler"
                  else wsm6.max_fall_speed(full=(mp == "wsm6")))
        nl = nl.replace(config_kessler_nfall=kessler.fall_substeps(
            nl.config_dt, dz_min, max_vt))
    state = core_state.zero_state(C, E, V, K, dtype, dev, n_scalars=n_scalars)
    state = state.replace(
        u=fT(init_np["u"]), w=fT(init_np["w"]), theta_m=fT(init_np["theta_m"]),
        rho_zz=fT(init_np["rho"]),           # physical rho; coupled below
        v=fT(init_np["v"]), pressure_p=fT(init_np["pressure_p"]),
        exner=fT(init_np["exner"]))
    if n_scalars and nl.config_moisture:
        state.scalars[0] = fT(init_np["qv"])
    if use_mp:
        state = state.replace(rainnc=torch.zeros(C, dtype=dtype, device=dev))

    # atm_core_init sequence: coupled diagnostics, solve diagnostics,
    # reconstruction
    state = diag_ops.init_coupled_diagnostics(state, static, marr, vert)
    diags = diag_ops.compute_solve_diagnostics(
        state, marr, hollingsworth=nl.config_hollingsworth,
        reconstruct_v=True, cell_form=nl.config_cell_form_ops,
        apvm_upwinding=nl.config_apvm_upwinding,
        dt=nl.config_dt / nl.config_dynamics_split_steps)
    state = state.replace(**diags)
    zonal, meridional = diag_ops.reconstruct_velocity(state.u, marr)
    state = state.replace(uReconstructZonal=zonal, uReconstructMeridional=meridional)

    step_fn = srk3.make_step_fn(static, marr, vert, nl)
    lap("state")
    model = Model(namelist=nl, mesh=mesh, vgrid=vg, mesh_arrays=marr,
                  vert=vert, static=static, state=state, step_fn=step_fn,
                  init_fields=init_np, setup_seconds=seconds,
                  radiation_interval=interval)
    if interval is not None:
        model._radiation_fn = make_radiation_fn(physics_init(), dtype, dev)
        lap("physics_init")
    return model
