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
from ..physics import kessler, pbl, wsm6
from ..tracing import span

# species a microphysics scheme needs in state.scalars
MICROPHYSICS_SPECIES = {"kessler": 3, "wsm6lite": 5, "wsm6": 6}


def rk_substep_counts(number_of_sub_steps: int):
    """Acoustic substeps per RK stage."""
    n = number_of_sub_steps
    return [max(1, n // 2), max(1, n // 2), n]


def atm_srk3(state, static, mesh, vert, nl, dt: float, halo=None):
    """Advance one full dynamics timestep (possibly several dynamics
    substeps). Returns the new state.

    `halo` (optional) is a parallel.halo.HaloExchange bound to a domain
    decomposition: prognostic halos are refreshed at the top of each RK
    stage, the tendencies once per stage (or, where the halo is too shallow
    for the stage's substeps, the acoustic perturbations once per substep),
    and all stencil computation proceeds redundantly over the 3-ring halo
    so owned outputs are exact. Diagnostics are recomputed at stage start
    from the freshly exchanged state, so no diagnostic field is exchanged.
    """
    dynamics_split = nl.config_dynamics_split_steps
    dt_dynamics = dt / dynamics_split
    n_sub = nl.config_number_of_sub_steps

    rk_timestep = [dt_dynamics / 3.0, dt_dynamics / 2.0, dt_dynamics]
    rk_sub_timestep = [dt_dynamics / 3.0, dt_dynamics / n_sub, dt_dynamics / n_sub]
    number_sub_steps = rk_substep_counts(n_sub)

    # the top-level spans (tracing.span) tile the step: every op of it runs
    # inside exactly one, and no span encloses another
    with span("srk3.setup"):
        if halo is not None:
            state = halo.refresh_state(state, scalars=True)
        save = rk_ops.rk_integration_setup(state)
        state = rk_ops.compute_moist_coefficients(state, mesh)

        ruAvg_split = torch.zeros_like(state.ruAvg)
        wwAvg_split = torch.zeros_like(state.wwAvg)

    # In stencil form (apvm off) the tangential velocity comes from
    # compute_dyn_tend's Coriolis reduce (the same sum, one edgesOnEdge
    # reduction saved per step); otherwise solve_diagnostics reconstructs it
    # on the first RK stage.
    cell_form = getattr(nl, "config_cell_form_ops", False)
    apvm = getattr(nl, "config_apvm_upwinding", 0.0)
    v_from_tend = (not cell_form) and apvm == 0.0

    for dynamics_substep in range(1, dynamics_split + 1):
        coefs = None
        tend = None

        for rk_step in range(3):
            with span("srk3.diagnostics"):
                if halo is not None and (rk_step > 0 or dynamics_substep > 1):
                    # stage-top full refresh (the step-top refresh covers the
                    # first stage of the first dynamics substep); later
                    # dynamics substeps restart from a recover output whose
                    # outer halo rings are stale under the tendency exchange
                    # below
                    state = halo.refresh_state(state)

                # diagnostics of the current stage state
                diags = diag_ops.compute_solve_diagnostics(
                    state, mesh,
                    hollingsworth=getattr(nl, "config_hollingsworth", False),
                    reconstruct_v=(rk_step == 0 and not v_from_tend),
                    cell_form=cell_form, apvm_upwinding=apvm, dt=dt_dynamics)
                state = state.replace(**diags)
                if rk_step == 0:
                    zonal, meridional = diag_ops.reconstruct_velocity(
                        state.u, mesh)
                    state = state.replace(uReconstructZonal=zonal,
                                          uReconstructMeridional=meridional)

            if rk_step in (0, 1):
                with span("srk3.vert_imp_coefs"):
                    coefs = ac_ops.compute_vert_imp_coefs(
                        state, static, vert, nl, rk_sub_timestep[rk_step])

            ns = number_sub_steps[rk_step]
            # with an n-ring halo, exchanging the TENDENCIES once per stage
            # makes every acoustic substep (and the recovery after them)
            # local compute: each substep consumes one ring of validity and
            # recovery one more, so owned outputs stay exact while
            # ns + 1 <= n_rings
            exchange_tend = halo is not None and ns + 1 <= halo.n_rings
            with span("srk3.dyn_tend"):
                tend = tend_ops.compute_dyn_tend(state, save, static, mesh,
                                                 vert, nl, rk_step, dt,
                                                 prev=tend)
                if rk_step == 0 and v_from_tend and tend.v is not None:
                    state = state.replace(v=tend.v)
                if exchange_tend:
                    tend = halo.refresh_tend(tend)
                tend = rk_ops.set_smlstep_pert_variables(tend, static, mesh,
                                                         vert, nl=nl)
            with span("srk3.acoustic"):
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
                        ac, ruAvg, wwAvg, tend, coefs, state, save, static,
                        mesh, vert, nl, rk_sub_timestep[rk_step], small_step,
                        damp_previous=nl.config_divergence_damping)
                    if halo is not None and not exchange_tend:
                        # the halo is too shallow for redundant substep
                        # compute: refresh the perturbations every substep
                        ac = halo.refresh_acoustic(ac)
                if nl.config_divergence_damping:
                    ac = ac_ops.divergence_damping_3d(
                        ac, state, mesh, nl, rk_sub_timestep[rk_step],
                        static=static)

            with span("srk3.recover"):
                state = rk_ops.recover_large_step_variables(
                    state, ac, ruAvg, wwAvg, save, static, mesh, vert, nl,
                    ns, rk_step, rk_timestep[rk_step])

        with span("srk3.split_finish"):
            state, save, ruAvg_split, wwAvg_split = (
                rk_ops.rk_dynamics_substep_finish(
                    state, save, dynamics_substep, dynamics_split,
                    ruAvg_split, wwAvg_split))
            if dynamics_substep == dynamics_split:
                # scalar transport on (rho_zz_old, ruAvg, wwAvg), monotonic
                # FCT per MPAS: rho_zz holds the OLD (pre-step) density
                # here, the split bookkeeping restored it for exactly this
                # flux-form update. Rediagnose the new density BEFORE
                # microphysics: the column schemes couple rtheta_p =
                # rho_zz*theta_m - rtheta_base from the equation of state,
                # and the old density there would be a spurious heating
                # every step. The dry step rediagnoses too, so this sits in
                # the last split's span, not in a moist one.
                rho_zz_old = state.rho_zz
                state = state.replace(rho_zz=state.rho_p + static.rho_base)

    if state.scalars is not None and nl.config_scalar_advection:
        with span("moist.transport"):
            ruAvg, wwAvg, rho_old, scal = (state.ruAvg, state.wwAvg,
                                           rho_zz_old, state.scalars)
            if halo is not None:
                ruAvg = halo.edge(ruAvg)
                nS, Ks, Cs = scal.shape              # species-major [nS, K, C]
                wwAvg, rho_old, scal_flat = halo.cell(
                    wwAvg, rho_old, scal.reshape(nS * Ks, Cs))
                scal = scal_flat.reshape(nS, Ks, Cs)
            scal_new, _ = scalar_ops.advance_scalars_mono(
                scal, rho_old, ruAvg, wwAvg, mesh, vert, nl, dt)
            state = state.replace(scalars=scal_new)

    # microphysics closes the moisture loop, where the state carries the
    # species the scheme needs
    mp = nl.config_microphysics
    if (mp in MICROPHYSICS_SPECIES and state.scalars is not None
            and state.scalars.shape[0] >= MICROPHYSICS_SPECIES[mp]):
        with span("moist.microphysics"):
            if mp == "kessler":
                state = kessler.apply_kessler(state, static, vert, nl, dt)
            else:
                state = wsm6.apply_wsm6(state, static, vert, nl, dt,
                                        full=(mp == "wsm6"))

    # surface layer + PBL vertical mixing
    if getattr(nl, "config_pbl", "off") == "ysu_lite":
        with span("moist.pbl"):
            state = pbl.apply_pbl(state, static, vert, mesh, nl, dt)
    return state


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
