"""The 3rd-order Runge-Kutta split-explicit time integrator.

The port of `mpas_tpu.dynamics.srk3` (atm_srk3 / atm_timestep), dry and on
one device: the RK loop (3 stages) and the acoustic loop run as Python loops
that launch the step's kernels eagerly on the tensors' device.

Differences from the Regent reference, as in mpas_tpu:
  - atm_recover_large_step_variables runs every RK stage;
  - the final rho_zz is rediagnosed as rho_p + rho_base after the
    dynamics-split bookkeeping restores the old density.
The scalar-transport, microphysics and PBL tail of mpas_tpu's step is not
ported yet: a namelist that enables it raises.
"""

from __future__ import annotations

import torch

from ..ops import acoustic as ac_ops
from ..ops import diagnostics as diag_ops
from ..ops import recover as rk_ops
from ..ops import tendencies as tend_ops


def rk_substep_counts(number_of_sub_steps: int):
    """Acoustic substeps per RK stage."""
    n = number_of_sub_steps
    return [max(1, n // 2), max(1, n // 2), n]


def check_namelist(nl) -> None:
    """Raise for the options this port does not implement yet."""
    unported = {
        "config_cell_form_ops": getattr(nl, "config_cell_form_ops", False),
        "config_apvm_upwinding": getattr(nl, "config_apvm_upwinding", 0.0) != 0.0,
        "config_hollingsworth": getattr(nl, "config_hollingsworth", False),
        "config_moisture": nl.config_moisture,
        "config_scalar_advection": nl.config_scalar_advection,
        "config_microphysics": nl.config_microphysics != "off",
        "config_pbl": getattr(nl, "config_pbl", "off") != "off",
    }
    on = sorted(k for k, v in unported.items() if v)
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


def atm_srk3(state, static, mesh, vert, nl, dt: float, halo=None):
    """Advance one full dynamics timestep (possibly several dynamics
    substeps). Returns the new state. `halo` must be None: the
    domain-decomposed step is not ported yet."""
    if halo is not None:
        raise NotImplementedError("halo exchange is not ported yet")
    check_namelist(nl)
    dynamics_split = nl.config_dynamics_split_steps
    dt_dynamics = dt / dynamics_split
    n_sub = nl.config_number_of_sub_steps

    rk_timestep = [dt_dynamics / 3.0, dt_dynamics / 2.0, dt_dynamics]
    rk_sub_timestep = [dt_dynamics / 3.0, dt_dynamics / n_sub, dt_dynamics / n_sub]
    number_sub_steps = rk_substep_counts(n_sub)

    save = rk_ops.rk_integration_setup(state)
    state = rk_ops.compute_moist_coefficients(state, mesh)

    ruAvg_split = torch.zeros_like(state.ruAvg)
    wwAvg_split = torch.zeros_like(state.wwAvg)

    for dynamics_substep in range(1, dynamics_split + 1):
        coefs = None
        tend = None

        for rk_step in range(3):
            # diagnostics of the current stage state; the tangential
            # velocity comes from compute_dyn_tend's Coriolis reduce
            diags = diag_ops.compute_solve_diagnostics(
                state, mesh, reconstruct_v=False, cell_form=False)
            state = state.replace(**diags)
            if rk_step == 0:
                zonal, meridional = diag_ops.reconstruct_velocity(state.u, mesh)
                state = state.replace(uReconstructZonal=zonal,
                                      uReconstructMeridional=meridional)

            if rk_step in (0, 1):
                coefs = ac_ops.compute_vert_imp_coefs(state, static, vert, nl,
                                                      rk_sub_timestep[rk_step])

            ns = number_sub_steps[rk_step]
            tend = tend_ops.compute_dyn_tend(state, save, static, mesh, vert,
                                             nl, rk_step, dt, prev=tend)
            if rk_step == 0:
                state = state.replace(v=tend.v)
            tend = rk_ops.set_smlstep_pert_variables(tend, static, mesh, vert,
                                                     nl=nl)
            ac = ac_ops.AcousticState(
                ru_p=torch.zeros_like(state.u),
                rho_pp=torch.zeros_like(state.rho_p),
                rtheta_pp=torch.zeros_like(state.rtheta_p),
                rtheta_pp_old=torch.zeros_like(state.rtheta_p),
                rw_p=torch.zeros_like(state.rw))
            ruAvg = torch.zeros_like(state.ruAvg)
            wwAvg = torch.zeros_like(state.wwAvg)
            # each substep's divergence damping is folded into the NEXT
            # substep's pressure-gradient gather; the final substep is
            # damped standalone below
            for small_step in range(ns):
                ac, ruAvg, wwAvg = ac_ops.advance_acoustic_step(
                    ac, ruAvg, wwAvg, tend, coefs, state, save, static, mesh,
                    vert, nl, rk_sub_timestep[rk_step], small_step,
                    damp_previous=nl.config_divergence_damping)
            if nl.config_divergence_damping:
                ac = ac_ops.divergence_damping_3d(ac, state, mesh, nl,
                                                  rk_sub_timestep[rk_step],
                                                  static=static)

            state = rk_ops.recover_large_step_variables(
                state, ac, ruAvg, wwAvg, save, static, mesh, vert, nl,
                ns, rk_step, rk_timestep[rk_step])

        state, save, ruAvg_split, wwAvg_split = rk_ops.rk_dynamics_substep_finish(
            state, save, dynamics_substep, dynamics_split,
            ruAvg_split, wwAvg_split)

    # rediagnose the new density (the split bookkeeping restored the old
    # one for scalar transport, which is not ported yet)
    return state.replace(rho_zz=state.rho_p + static.rho_base)


def summarize_timestep(state, mesh):
    """Global min/max/NaN diagnostics as a dict of 0-d tensors."""
    wsp = torch.sqrt(state.u ** 2 + state.v ** 2)
    return dict(
        w_min=torch.min(state.w), w_max=torch.max(state.w),
        u_min=torch.min(state.u), u_max=torch.max(state.u),
        wsp_max=torch.max(wsp),
        theta_min=torch.min(state.theta_m), theta_max=torch.max(state.theta_m),
        nan_detected=torch.logical_or(torch.isnan(state.w).any(),
                                      torch.isnan(state.u).any()),
    )


def make_step_fn(static, mesh, vert, nl, dt=None):
    """Returns step(state) -> state closing over the static data."""
    dt = nl.config_dt if dt is None else dt

    def step(state):
        return atm_srk3(state, static, mesh, vert, nl, dt)

    return step
