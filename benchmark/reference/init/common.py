"""Shared initial-condition machinery: terrain-following grid, omega metric
terms, initial rw/w diagnosis and tangential winds.

Factored from the JW init (vertical_init/init_atm_cases.rg:155-263, 616-723)
so additional idealized cases (mountain wave, etc.) build the identical
discrete metrics; init/jw.py and init/mountain_wave.py both call these.
All host-side numpy float64.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..core.vertical import VerticalGrid
from ..mesh.loader import Mesh


def terrain_grid(mesh: Mesh, vg: VerticalGrid, hx: np.ndarray):
    """Terrain-following zgrid [C, K+1] and metric zz [C, K] from surface
    height hx [C] (init_atm_cases.rg:155-255)."""
    zt = vg.ztop
    zgrid = ((1.0 - vg.ah)[None, :] * (vg.sh[None, :] * (zt - hx[:, None]) + hx[:, None])
             + (vg.ah * vg.sh * zt)[None, :])                       # [C, K+1]
    zz = (vg.zw[1:] - vg.zw[:-1])[None, :] / (zgrid[:, 1:] - zgrid[:, :-1])
    return zgrid, zz


def edge_slope(mesh: Mesh, zgrid: np.ndarray):
    """Edge slope zxu [E, K] at mass levels (init_atm_cases.rg:257-263)."""
    zg1 = zgrid[mesh.cellsOnEdge[:, 0]]
    zg2 = zgrid[mesh.cellsOnEdge[:, 1]]
    return (0.5 * ((zg2[:, :-1] - zg1[:, :-1]) + (zg2[:, 1:] - zg1[:, 1:]))
            / mesh.dcEdge[:, None])


def damping_profile(mesh: Mesh, vg: VerticalGrid, nl, zgrid: np.ndarray):
    """w-damping (gravity-wave absorbing layer) profile dss [C, K]
    (atm_compute_damping_coefs, dynamics_tasks.rg:274-300)."""
    K = vg.nVertLevels
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])
    zt_cell = zgrid[:, K][:, None]
    return np.where(
        zmid > nl.config_zd,
        nl.config_xnutr * np.sin(0.5 * np.pi * (zmid - nl.config_zd)
                                 / np.maximum(zt_cell - nl.config_zd, 1.0)) ** 2
        / (mesh.meshDensity[:, None] ** 0.25),
        0.0)


def omega_metrics(mesh: Mesh, nl, deriv_two: np.ndarray, zgrid: np.ndarray):
    """Sloping-coordinate metric terms zb/zb3 [E, K+1, 2] with the 3rd-order
    z_edge branch via deriv_two (init_atm_cases.rg:616-665)."""
    c1 = mesh.cellsOnEdge[:, 0]
    c2 = mesh.cellsOnEdge[:, 1]
    third_order = nl.config_theta_adv_order in (3, 4)
    zgc1, zgc2 = zgrid[c1], zgrid[c2]                               # [E, K+1]
    z_edge = 0.5 * (zgc1 + zgc2)
    z_edge3 = np.zeros_like(z_edge)
    if third_order:
        zg_n1 = zgrid[mesh.cellsOnCell[c1]]                         # [E, M, K+1]
        zg_n2 = zgrid[mesh.cellsOnCell[c2]]
        m1 = mesh.edgesOnCell_mask[c1][:, :, None]
        m2 = mesh.edgesOnCell_mask[c2][:, :, None]
        d2_1 = (deriv_two[:, 0, 0][:, None] * zgc1
                + np.einsum("em,emk->ek", deriv_two[:, 0, 1:] * m1[..., 0], zg_n1))
        d2_2 = (deriv_two[:, 1, 0][:, None] * zgc2
                + np.einsum("em,emk->ek", deriv_two[:, 1, 1:] * m2[..., 0], zg_n2))
        z_edge = z_edge - (mesh.dcEdge ** 2)[:, None] * (d2_1 + d2_2) / 12.0
        if nl.config_theta_adv_order == 3:
            z_edge3 = -(mesh.dcEdge ** 2)[:, None] * (d2_1 - d2_2) / 12.0

    dv_area1 = (mesh.dvEdge / mesh.areaCell[c1])[:, None]
    dv_area2 = (mesh.dvEdge / mesh.areaCell[c2])[:, None]
    zb = np.stack([(z_edge - zgc1) * dv_area1,
                   (z_edge - zgc2) * dv_area2], axis=-1)            # [E, K+1, 2]
    zb3 = np.stack([z_edge3 * dv_area1, z_edge3 * dv_area2], axis=-1)
    return zb, zb3


def zb_cell_tables(mesh: Mesh, nl, zb: np.ndarray, zb3: np.ndarray):
    """Cell-local zb/zb3 slot tables [C, M, K+1] with the 3rd-order coupling
    folded in (atm_compute_signs + atm_couple_coef_3rd_order)."""
    C = mesh.nCells
    eoc = mesh.edgesOnCell
    first = (mesh.cellsOnEdge[eoc, 0] == np.arange(C, dtype=np.int32)[:, None])
    side = np.where(first, 0, 1)[..., None]                         # [C, M, 1]
    zb_cell = np.take_along_axis(zb[eoc], side[:, :, None, :], axis=3)[..., 0]
    zb3_cell = np.take_along_axis(zb3[eoc], side[:, :, None, :], axis=3)[..., 0]
    zb_cell = zb_cell * mesh.edgesOnCell_mask[:, :, None]
    zb3_cell = zb3_cell * mesh.edgesOnCell_mask[:, :, None] * nl.config_coef_3rd_order
    return zb_cell, zb3_cell


def initial_rw_w(mesh: Mesh, vg: VerticalGrid, nl, zz, rho_zz_coupled, ru,
                 zb, zb3):
    """Initial rw and diagnosed w from the edge fluxes through the sloping
    coordinate (init_atm_cases.rg:668-704)."""
    C, E, K = mesh.nCells, mesh.nEdges, vg.nVertLevels
    c1 = mesh.cellsOnEdge[:, 0]
    c2 = mesh.cellsOnEdge[:, 1]
    third_order = nl.config_theta_adv_order in (3, 4)

    flux_i = np.zeros((E, K + 1))
    flux_i[:, 1:K] = vg.fzm[1:K] * ru[:, 1:] + vg.fzp[1:K] * ru[:, :-1]
    zz_i = np.zeros((C, K + 1))
    zz_i[:, 1:K] = vg.fzm[1:K] * zz[:, 1:] + vg.fzp[1:K] * zz[:, :-1]
    rho_i = np.zeros((C, K + 1))
    rho_i[:, 1:K] = (vg.fzm[1:K] * rho_zz_coupled[:, 1:]
                     + vg.fzp[1:K] * rho_zz_coupled[:, :-1])

    coef3 = nl.config_coef_3rd_order if third_order else 0.0
    s = np.sign(flux_i)
    rw = np.zeros((C, K + 1))
    contrib2 = zz_i[c2] * (zb[:, :, 1] + s * coef3 * zb3[:, :, 1]) * flux_i
    contrib1 = zz_i[c1] * (zb[:, :, 0] + s * coef3 * zb3[:, :, 0]) * flux_i
    np.add.at(rw, c2, contrib2)
    np.add.at(rw, c1, -contrib1)

    w = np.zeros((C, K + 1))
    w[:, 1:K] = rw[:, 1:K] / rho_i[:, 1:K]
    return rw, w


def tangential_v(mesh: Mesh, u: np.ndarray):
    """Tangential winds from the Thuburn weights
    (init_atm_cases.rg:710-723)."""
    u_eoe = u[mesh.edgesOnEdge]                                     # [E, W2, K]
    return np.einsum("ew,ewk->ek", mesh.weightsOnEdge * mesh.edgesOnEdge_mask,
                     u_eoe)
