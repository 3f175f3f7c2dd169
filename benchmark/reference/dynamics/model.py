"""Model assembly: host-side setup (coefficient builders and the JW
initial condition, all numpy) followed by the SRK3 step on one device."""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Namelist
from ..core import state as core_state
from ..core.vertical import VerticalGrid, make_vertical_grid
from ..init import jw as jw_init
from ..mesh import coefficients as mcoef
from ..mesh.loader import Mesh
from ..ops import diagnostics as diag_ops
from ..physics import kessler, wsm6
from . import srk3


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

    @property
    def dtype(self):
        return self.state.theta_m.dtype

    @property
    def device(self):
        return self.state.theta_m.device

    def step(self, n: int = 1):
        for _ in range(n):
            self.state = self.step_fn(self.state)
            self.step_count += 1
        return self.state


# what the reference carries: the options of the benchmark's
# configurations; any other value is refused rather than run differently
SUPPORTED = {
    "config_init_case": (1, 2),
    "config_microphysics": ("off", "wsm6"),
    "config_pbl": ("off", "ysu_lite"),
    "config_cell_form_ops": (False,),
    "config_orient_edges": (False,),
    "config_renumber_mesh": (False,),
    "config_hollingsworth": (False,),
    "config_apvm_upwinding": (0.0,),
    "config_apply_lbcs": (False,),
    "config_reconstruct_method": ("lsq",),
}


def check_supported(nl: Namelist):
    for name, values in SUPPORTED.items():
        if getattr(nl, name) not in values:
            raise ValueError(f"the reference runs {name} in {values} only, "
                             f"not {getattr(nl, name)!r}")


def build_model(namelist: Namelist, mesh: Mesh, device, dtype) -> Model:
    """Build all static coefficients, apply the JW baroclinic-wave initial
    condition, derive the coupled state and close the step function over
    them. Microphysics brings its species (scalars[0] = qv), turns scalar
    transport on and, with `config_kessler_nfall` = 0, sizes the
    sedimentation substeps from the step and the thinnest layer."""
    nl = namelist
    check_supported(nl)
    dev = torch.device(device)

    seconds, t0 = {}, time.perf_counter()

    def lap(stage):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        seconds[stage], t0 = t1 - t0, t1

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

    static_np, init_np = jw_init.init_jw(mesh, vg, nl, deriv_two)
    lap("init_jw")
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
        nl = nl.replace(config_kessler_nfall=kessler.fall_substeps(
            nl.config_dt, dz_min, wsm6.max_fall_speed(full=True)))
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
    diags = diag_ops.compute_solve_diagnostics(state, marr, reconstruct_v=True)
    state = state.replace(**diags)
    zonal, meridional = diag_ops.reconstruct_velocity(state.u, marr)
    state = state.replace(uReconstructZonal=zonal, uReconstructMeridional=meridional)

    step_fn = srk3.make_step_fn(static, marr, vert, nl)
    lap("state")
    return Model(namelist=nl, mesh=mesh, vgrid=vg, mesh_arrays=marr, vert=vert,
                 static=static, state=state, step_fn=step_fn,
                 init_fields=init_np, setup_seconds=seconds)
