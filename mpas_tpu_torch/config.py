"""Run configuration ("namelist") for the PyTorch dycore.

A copy of `mpas_tpu.config` with every `config_*` name and default, so a
namelist means the same in both packages. Mirrors the MPAS
namelist.atmosphere `config_*` names (the Regent reference hardcodes these as
Lua constants, constants.rg:40-104): a frozen dataclass constructible from
dicts / JSON / simple "name = value" files.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class Namelist:
    # --- time integration (Registry.xml nhyd_model defaults) ---
    config_dt: float = 720.0
    config_number_of_sub_steps: int = 2
    config_dynamics_split_steps: int = 1      # MPAS default 3; reference uses 1
    config_epssm: float = 0.1                 # off-centering, acoustic solve
    config_smdiv: float = 0.1                 # divergence damping coefficient
    config_time_integration_order: int = 3    # SRK3

    # --- advection ---
    # APVM upwinding of pv_edge (Ringler et al. JCP 2010; MPAS default 0.5).
    # The reference never applies it (rk_timestep.rg:453); our validation
    # baselines were established at 0.0 to match — set 0.5 for MPAS fidelity.
    config_apvm_upwinding: float = 0.0
    config_theta_adv_order: int = 3
    config_w_adv_order: int = 3
    config_u_vadv_order: int = 3
    config_coef_3rd_order: float = 0.25

    # --- mixing / dissipation ---
    config_horiz_mixing: str = "2d_smagorinsky"   # or "2d_fixed"
    config_len_disp: float = 120000.0
    config_smagorinsky_coef: float = 0.125
    config_visc4_2dsmag: float = 0.05
    config_del4u_div_factor: float = 10.0
    config_h_mom_eddy_visc2: float = 0.0
    config_h_mom_eddy_visc4: float = 0.0
    config_v_mom_eddy_visc2: float = 0.0
    config_h_theta_eddy_visc2: float = 0.0
    config_h_theta_eddy_visc4: float = 0.0
    config_v_theta_eddy_visc2: float = 0.0
    config_mix_full: bool = False
    config_mpas_cam_coef: float = 0.0
    config_h_ScaleWithMesh: bool = False
    # Hollingsworth-instability KE correction (Gassmann QJRMS 2013 blend of
    # cell and vertex kinetic energy; dynamics_tasks.rg:392-418 carries the
    # construction but the reference never enables it)
    config_hollingsworth: bool = False

    # --- damping layers ---
    config_zd: float = 22000.0                # w-damping layer base height [m]
    config_xnutr: float = 0.2                 # w-damping coefficient
    config_rayleigh_damp_u: bool = False
    config_number_rayleigh_damp_u_levels: int = 6
    config_rayleigh_damp_u_timescale_days: float = 5.0

    # --- moisture / scalars ---
    config_moisture: bool = False
    config_scalar_advection: bool = False
    config_microphysics: str = "off"  # "off" | "kessler" | "wsm6lite" | "wsm6"
    # surface-layer + boundary-layer column physics (physics/pbl.py):
    # the reference's empty sfclayer/PBL driver slots (atmphys_driver.rg)
    config_pbl: str = "off"                   # "off" | "ysu_lite"
    config_sst: float = 0.0                   # skin temperature [K]; 0 = skin
                                              # follows the lowest-level theta
                                              # (no surface heat/moisture flux)
    config_roughness: float = 0.01            # z0 [m]
    config_kessler_nfall: int = 0             # 0 = auto from dt & min layer depth

    # --- radiation (Registry.xml's names; the port's own keys) ---
    # "cam_lw" / "cam_sw" run physics/driver.py's CAM-slot chain inside
    # Model.step on MPAS's alarm; the driver solves both in one call, so
    # both are on or both "off", at one interval
    config_radt_lw_scheme: str = "off"        # "off" | "cam_lw"
    config_radt_sw_scheme: str = "off"        # "off" | "cam_sw"
    config_radtlw_interval: float = 1800.0    # seconds ('00:30:00')
    config_radtsw_interval: float = 1800.0    # seconds ('00:30:00')

    # --- diagnostics/printing (constants.rg:67-69) ---
    config_print_detailed_minmax_vel: bool = False
    config_print_global_minmax_vel: bool = False
    config_print_global_minmax_sca: bool = False

    # --- regional / specified zone (global runs: masks all zero) ---
    config_apply_lbcs: bool = False
    nRelaxZone: int = 5

    # --- distributed halo exchange ---
    config_halo_exchange: str = "ppermute"    # "ppermute" | "all_to_all"

    # --- vertical grid (init_atm_cases.rg:165-167) ---
    config_nvertlevels: int = 26
    config_ztop: float = 30000.0
    config_vertical_stretch: float = 1.5

    # --- initial condition ---
    # 1/2 = JW baroclinic wave (2 adds the Gaussian u perturbation);
    # 21 = Schar mountain wave on a reduced-radius planet (DCMIP 2-x style;
    #      set config_sphere_radius = 6371229/X and config_coriolis=False)
    config_init_case: int = 2
    config_jw_u_perturbation: float = 1.0

    # --- planet (small-planet DCMIP experiments scale the radius) ---
    config_sphere_radius: float = 6371229.0
    config_coriolis: bool = True              # zero fEdge/fVertex when False

    # --- Weisman-Klemp storm case (config_init_case == 22; init/squall.py;
    #     bubble center reuses config_mtn_lat_center/config_mtn_lon_center) ---
    config_sq_theta0: float = 300.0           # surface potential temp [K]
    config_sq_qv0: float = 0.014              # boundary-layer qv cap [kg/kg]
    config_sq_shear_u: float = 12.0           # shear-layer wind speed [m/s]
    config_sq_shear_depth: float = 2500.0     # tanh shear depth z_s [m]
    config_sq_bubble_dtheta: float = 3.0      # bubble amplitude [K]
    config_sq_bubble_radius: float = 10000.0  # bubble horizontal radius [m]
    config_sq_bubble_height: float = 1500.0   # bubble center height [m]
    config_sq_bubble_depth: float = 1500.0    # bubble vertical radius [m]

    # --- mountain-wave case (config_init_case == 21) ---
    config_mtn_t0: float = 300.0              # isothermal temperature [K]
    config_mtn_u0: float = 20.0               # zonal wind at the equator [m/s]
    config_mtn_h0: float = 250.0              # peak height [m]
    config_mtn_halfwidth: float = 5000.0      # Gaussian envelope d [m]
    config_mtn_wavelength: float = 4000.0     # cos^2 ridge wavelength xi [m]
    config_mtn_lat_center: float = 0.0        # [rad]
    config_mtn_lon_center: float = 3.14159265358979  # [rad]

    # --- run control ---
    config_run_duration_steps: int = 10
    config_output_interval_steps: int = 10

    # --- numerics ---
    dtype: str = "float32"                    # state dtype on device
    index_dtype: str = "int32"

    # --- optional physics/numerics toggles (MPAS #ifdef CURVATURE etc.) ---
    config_curvature: bool = True             # spherical curvature terms
    # cell-form advection/Thuburn operators (per-cell directional Hessians +
    # tangential matrices with flat slot gathers) instead of per-edge stencil
    # gathers — identical arithmetic.  Under the level-major layout the cell
    # form's [K, M*C]-wide slot-pair reads are the expensive gather shape,
    # so the per-edge stencil form is the default.
    config_cell_form_ops: bool = False
    # RCM locality renumbering of the mesh at model build (mesh/renumber.py):
    # a pure relabeling (trajectories are the original with permuted columns,
    # tests/test_renumber.py) that compresses every stencil's per-block index
    # spans ~50x, enabling the windowed gather-reduce kernels and improving
    # XLA gather locality.  Off by default so checked-in golden trajectories
    # keep their original column order.
    config_renumber_mesh: bool = False
    # trade XLA optimization effort for cold-compile time
    # (exec_time_optimization_effort = -1; tools/compile_study.py)
    config_fast_compile: bool = False
    # ownership-aligned edge numbering (mesh/orient.py): 3-bounded edge
    # orientation + slot-major renumbering so owner-side pair reads and
    # owned-edge reductions need no gather; opt-in (changes the edge id
    # space, so artifacts/checkpoints are not interchangeable with the
    # unaligned numbering)
    config_orient_edges: bool = False
    # kept for namelist compatibility with mpas_tpu and not read here: the
    # port has one acoustic path (ops/acoustic_column.py, a CUDA kernel on
    # the card and its plain version on the CPU)
    config_use_pallas_acoustic: Any = "auto"
    config_divergence_damping: bool = True    # 3-D divergence damping
    # cell-center velocity reconstruction coefficients: "lsq" (tangent-plane
    # least squares, round-1/2 default) or "rbf" (inverse-multiquadric
    # radial basis functions — the method MPAS/the reference precompute,
    # dynamics_tasks.rg:1921-1929); compared field-for-field in
    # tests/test_reconstruct.py
    config_reconstruct_method: str = "lsq"
    config_smagorinsky: bool = True           # horizontal Smagorinsky/del4 mixing

    def replace(self, **kw) -> "Namelist":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Namelist":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_file(cls, path: str) -> "Namelist":
        """Load from a JSON file or a simple 'name = value' namelist file."""
        text = open(path).read()
        try:
            return cls.from_dict(json.loads(text))
        except json.JSONDecodeError:
            pass
        d = {}
        for line in text.splitlines():
            line = line.split("#")[0].split("!")[0].strip()
            if not line or "=" not in line:
                continue
            k, v = (s.strip() for s in line.split("=", 1))
            v = v.strip("'\"")
            if v.lower() in ("true", ".true."):
                v = True
            elif v.lower() in ("false", ".false."):
                v = False
            else:
                try:
                    v = int(v)
                except ValueError:
                    try:
                        v = float(v)
                    except ValueError:
                        pass
            d[k] = v
        return cls.from_dict(d)


# The reference run configuration (constants.rg:12-26,60,99): x1.2562 mesh,
# 5 levels, dt=720s, 10 steps, 16 partitions.
REFERENCE_NAMELIST = Namelist(
    config_nvertlevels=5,
    config_ztop=45000.0,
    config_dt=720.0,
    config_run_duration_steps=10,
)
