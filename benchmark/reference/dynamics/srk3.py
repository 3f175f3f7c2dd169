"""The 3rd-order Runge-Kutta split-explicit time integrator.

The port of `mpas_tpu.dynamics.srk3` (atm_srk3 / atm_timestep) on one
device: the RK loop (3 stages) and the acoustic loop run as Python loops
that launch the step's kernels eagerly on the tensors' device, followed by
the moist tail (monotonic scalar transport, microphysics, PBL) where the
namelist turns it on.

Differences from the Regent reference, as in mpas_tpu:
  - atm_recover_large_step_variables runs every RK stage;
  - the final rho_zz is rediagnosed as rho_p + rho_base after the
    dynamics-split bookkeeping restores the old density for scalar
    transport.
"""

from __future__ import annotations

import torch

from ..ops import acoustic as ac_ops
from ..ops import diagnostics as diag_ops
from ..ops import recover as rk_ops
from ..ops import scalars as scalar_ops
from ..ops import tendencies as tend_ops
from ..physics import pbl, wsm6

# species a microphysics scheme needs in state.scalars
MICROPHYSICS_SPECIES = {"wsm6": 6}


def rk_substep_counts(number_of_sub_steps: int):
    """Acoustic substeps per RK stage."""
    n = number_of_sub_steps
    return [max(1, n // 2), max(1, n // 2), n]


def atm_srk3(state, static, mesh, vert, nl, dt: float):
    """Advance one full dynamics timestep (possibly several dynamics
    substeps) on one device. Returns the new state."""
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

    # the tangential velocity comes from compute_dyn_tend's Coriolis reduce
    # (the same sum, one edgesOnEdge reduction saved per step)
    for dynamics_substep in range(1, dynamics_split + 1):
        coefs = None
        tend = None

        for rk_step in range(3):
            # diagnostics of the current stage state
            diags = diag_ops.compute_solve_diagnostics(state, mesh,
                                                       reconstruct_v=False)
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
            tend = rk_ops.set_smlstep_pert_variables(tend, static, mesh, vert)
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

    # scalar transport on (rho_zz_old, ruAvg, wwAvg), monotonic FCT per
    # MPAS: rho_zz holds the OLD (pre-step) density here, the split
    # bookkeeping restored it for exactly this flux-form update.
    rho_zz_old = state.rho_zz
    # rediagnose the new density BEFORE microphysics: the column schemes
    # couple rtheta_p = rho_zz*theta_m - rtheta_base from the equation of
    # state, and the old density there would be a spurious heating every
    # step
    state = state.replace(rho_zz=state.rho_p + static.rho_base)
    if state.scalars is not None and nl.config_scalar_advection:
        scal_new, _ = scalar_ops.advance_scalars_mono(
            state.scalars, rho_zz_old, state.ruAvg, state.wwAvg, mesh, vert,
            nl, dt)
        state = state.replace(scalars=scal_new)

    # microphysics closes the moisture loop, where the state carries the
    # species the scheme needs
    if (nl.config_microphysics == "wsm6" and state.scalars is not None
            and state.scalars.shape[0] >= MICROPHYSICS_SPECIES["wsm6"]):
        state = wsm6.apply_wsm6(state, static, vert, nl, dt, full=True)

    # surface layer + PBL vertical mixing
    if getattr(nl, "config_pbl", "off") == "ysu_lite":
        state = pbl.apply_pbl(state, static, vert, mesh, nl, dt)
    return state


def make_step_fn(static, mesh, vert, nl, dt=None):
    """Returns step(state) -> state closing over the static data."""
    dt = nl.config_dt if dt is None else dt

    def step(state):
        return atm_srk3(state, static, mesh, vert, nl, dt)

    return step
