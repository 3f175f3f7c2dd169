"""What surrounds the redesigned Kernels 1 and 4 of mpas_tpu_torch, on the
CPU (tests/test_torch_gpu.py holds the kernels themselves on the card):

  - Kernel 1's plain version against mpas_tpu's Pallas kernel in interpret
    mode on `probes.acoustic_inputs` (float64, 1e-12 relative, the limit of
    tests/test_pallas.py) at K = 2, 3, 8, 41 and a column count that is no
    multiple of 32, with the tendency arguments given and None;
  - `column_tile`, `level_lanes` and `tile_plan`: the tile a launch is made
    with, from K and the element size alone;
  - which form of Kernel 4 `take_columns` picks: the direct form for every
    index vector that `stencils.take_packed` and `edge_pair*` gather through
    in a step (generate_mesh(levels=4), default and ownership-aligned
    numbering, float32 and float64), the row-read form for random indices;
  - the build digest covers every file under csrc/.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.ops import acoustic as JA
from mpas_tpu.ops import pallas_acoustic as JP

from mpas_tpu_torch import cuda_build, probes
from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.ops import acoustic_column as K1
from mpas_tpu_torch.ops import gather_reduce as K2
from mpas_tpu_torch.ops import stencils
from mpas_tpu_torch.ops import take_columns as K4

RTOL = 1e-12
COLUMNS = 37          # no multiple of 32, of 16 or of 8


def rel_err(ref, out):
    ref, out = np.asarray(ref), np.asarray(out)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


# ---- Kernel 1: the plain version on synthetic inputs ----

@pytest.mark.parametrize("tendencies", [True, False])
@pytest.mark.parametrize("K", [2, 3, 8, 41])
def test_acoustic_column_plain_matches_pallas_on_synthetic_inputs(K, tendencies):
    inp = probes.acoustic_inputs(K, COLUMNS, seed=K)
    out = K1.acoustic_column_update_plain(
        *probes.acoustic_args(inp, "cpu", torch.float64, tendencies))
    f = {k: jnp.asarray(v) for k, v in inp["fields"].items()}
    if not tendencies:       # the Pallas kernel has no None: zeros
        f["tend_rho"] = jnp.zeros_like(f["tend_rho"])
        f["tend_rt"] = jnp.zeros_like(f["tend_rt"])
    coefs = JA.ImplicitCoefs(**{k: jnp.asarray(v)
                                for k, v in inp["coefs"].items()})
    ref = JP.acoustic_column_update(
        f["rs0"], f["ts0"], f["ac_rho_pp"], f["ac_rtheta_pp"], f["ac_rw_p"],
        f["wwAvg"], f["tend_rho"], f["tend_rt"], f["tend_w"], coefs, f["zz"],
        f["dss_i"], f["zz_rho_i"], f["w"], f["dw_save"], 240.0, 0.1,
        interpret=True)
    for name, r, o in zip(("rho_pp", "rtheta_pp", "rw_p", "wwAvg"), ref, out):
        assert o.shape == r.shape, name
        assert float(o.abs().max()) > 0.0, name
        assert rel_err(r, o.numpy()) < RTOL, name


@pytest.mark.parametrize("K", [1, 2, 41])
def test_acoustic_inputs_are_well_conditioned(K):
    inp = probes.acoustic_inputs(K, 5, seed=3)
    again = probes.acoustic_inputs(K, 5, seed=3)
    for group in ("fields", "coefs"):
        for name, a in inp[group].items():
            assert np.array_equal(a, again[group][name]), name
            assert np.isfinite(a).all(), name
            if a.shape == (K + 1, 5):      # interface fields vanish outside
                assert not a[0].any() and not a[K].any(), name
    alpha, gamma = inp["coefs"]["alpha_tri"], inp["coefs"]["gamma_tri"]
    assert (alpha[1:K] > 0.5).all() and (alpha[1:K] < 1.0).all()
    assert (np.abs(gamma[1:K]) < 0.5).all()
    assert inp["coefs"]["cofrz"].shape == (K,)


@pytest.mark.parametrize("tendencies", [True, False])
def test_acoustic_column_plain_takes_one_level(tendencies):
    """K = 1 has no interior interface: rw_p is zero, wwAvg is copied and
    rho_pp / rtheta_pp are rs / ts."""
    inp = probes.acoustic_inputs(1, 4, seed=1)
    a = probes.acoustic_args(inp, "cpu", torch.float64, tendencies)
    rho_pp, rtheta_pp, rw_p, wwAvg = K1.acoustic_column_update_plain(*a)
    assert rho_pp.shape == rtheta_pp.shape == (1, 4)
    assert not bool(rw_p.any()) and torch.equal(wwAvg, a[5])
    f = inp["fields"]
    rs = f["ac_rho_pp"] + f["rs0"] + (240.0 * f["tend_rho"] if tendencies
                                      else 0.0)
    assert rel_err(rs, rho_pp.numpy()) < RTOL


# ---- Kernel 1: the tile of a launch ----

@pytest.mark.parametrize("K,itemsize,tile", [
    (1, 4, 32), (8, 4, 32), (26, 4, 32), (41, 4, 16), (64, 4, 16),
    (100, 4, 8), (1, 8, 16), (26, 8, 16), (41, 8, 8), (64, 8, 8),
    (402, 8, 4), (806, 4, 4)])
def test_column_tile_is_the_widest_that_fits(K, itemsize, tile):
    assert K1.column_tile(K, itemsize) == tile
    assert tile * itemsize <= K1.LINE_BYTES
    assert K1.tile_bytes(K, tile, itemsize) <= K1.SMEM_LIMIT
    room = K1.SMEM_PER_SM // K1.RESIDENT_CTAS - K1.SMEM_RESERVED
    wider = [t for t in K1.TILE_WIDTHS
             if t > tile and t * itemsize <= K1.LINE_BYTES]
    if K1.tile_bytes(K, tile, itemsize) <= room:
        # the widest that leaves room for RESIDENT_CTAS CTAs an SM
        assert all(K1.tile_bytes(K, t, itemsize) > room for t in wider)
    else:
        # none leaves that room: the widest whose planes fit one CTA
        assert K1.tile_bytes(K, K1.TILE_WIDTHS[-1], itemsize) > room
        assert all(K1.tile_bytes(K, t, itemsize) > K1.SMEM_LIMIT
                   for t in wider)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_column_tile_names_its_error_beyond_the_most_levels(itemsize):
    most = K1.max_levels(itemsize)
    assert K1.column_tile(most, itemsize) == K1.TILE_WIDTHS[-1]
    with pytest.raises(K1.ColumnTileError, match=f"K = {most + 1} levels"):
        K1.column_tile(most + 1, itemsize)
    with pytest.raises(K1.ColumnTileError):
        K1.column_tile(0, itemsize)
    assert issubclass(K1.ColumnTileError, ValueError)


@pytest.mark.parametrize("K,tile,lanes", [
    (41, 16, 21), (41, 32, 11), (41, 8, 42), (64, 16, 22), (55, 16, 19),
    (26, 32, 9), (1, 32, 2), (5, 4, 6), (402, 4, 81)])
def test_level_lanes_split_the_levels_evenly(K, tile, lanes):
    assert K1.level_lanes(K, tile) == lanes
    assert tile * lanes <= max(K1.THREADS, tile)
    passes = -(-(K + 1) // lanes)
    assert passes == -(-(K + 1) // max(1, K1.THREADS // tile))
    assert passes * lanes - (K + 1) < passes     # no pass nearly empty


def test_tile_plan_passes_the_bytes_of_its_tile():
    assert K1.tile_plan(41, 4) == (16, 21, 18 * 42 * 16 * 4)
    assert K1.tile_plan(41, 8) == (8, 42, 18 * 42 * 8 * 8)
    assert K1.tile_plan(41, 4, tile=32, lanes=8) == (32, 8, 18 * 42 * 32 * 4)
    assert K1.tile_plan(41, 4, tile=32)[1] == K1.level_lanes(41, 32)


# ---- Kernel 4: which form runs ----

@pytest.fixture(scope="module", params=[False, True],
                ids=["default", "aligned"])
def step_gathers(request):
    """Every (table rows, index vector) that `stencils.gather` sees in one
    step on the level-4 mesh, and the mesh arrays."""
    nl = Namelist(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
                  config_jw_u_perturbation=1.0,
                  config_orient_edges=request.param)
    model = build_model(nl, generate_mesh(levels=4), device="cpu")
    seen = {}
    real = stencils.gather

    def gather(f, idx):
        seen.setdefault((f.shape[0], idx.data_ptr(), idx.stride(0)), (f, idx))
        return real(f, idx)

    stencils.gather = gather
    try:
        model.step(1)
    finally:
        stencils.gather = real
    return model.mesh_arrays, list(seen.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_gather_of_the_step_takes_the_direct_form(step_gathers, dtype):
    mesh, gathers = step_gathers
    coe = mesh.cellsOnEdge
    known = {(coe[:, j].data_ptr(), coe.stride(0)) for j in range(2)}
    assert len(gathers) >= 3
    assert {(idx.data_ptr(), idx.stride(0)) for _, idx in gathers} <= known
    if not mesh.owner_aligned:
        assert {(idx.data_ptr(), idx.stride(0)) for _, idx in gathers} == known
    for f, idx in gathers:
        tbl = f.to(dtype)
        assert K4.index_gain(tbl, idx) < 0.75 * K4.ROW_FORM_MIN_GAIN
        assert not K4.uses_row_form(tbl, idx)
        assert torch.equal(K4.take_columns(tbl, idx),
                           torch.index_select(tbl, 1, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_random_indices_take_the_row_read_form(dtype):
    inp = probes.gather_probe_inputs(K=83, C=2562, R=7680, M=1, seed=4)
    tbl = torch.from_numpy(inp["tbl"]).to(dtype)
    idx = torch.from_numpy(inp["idx"])
    assert K4.index_gain(tbl, idx) > K4.ROW_FORM_MIN_GAIN
    assert K4.uses_row_form(tbl, idx)
    # strided views of an index table count by what they name
    pair = torch.stack([idx, idx], dim=1)
    assert K4.uses_row_form(tbl, pair[:, 1])
    # a table with less than a sector's worth of levels stays direct
    short = tbl[:K2.SECTOR_BYTES // tbl.element_size() - 1]
    assert not K4.uses_row_form(short, idx)
    assert K4.uses_row_form(tbl[:K2.SECTOR_BYTES // tbl.element_size()], idx)


def test_index_gain_is_the_gain_of_a_one_slot_table():
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 5000, 640, dtype=np.int32))
    tbl = torch.zeros((16, 5000))
    sectors = K2.scatter_sectors(idx.numpy()[:, None], 4)
    assert K4.index_gain(tbl, idx) == K2.row_form_gain(sectors, 4, 5000, 640, 1)
    # adjacent columns: 4 sectors a warp
    assert K4.index_gain(tbl, torch.arange(640, dtype=torch.int32)) == \
        K2.row_form_gain(4.0, 4, 5000, 640, 1)


def test_named_forms_of_take_columns_refuse_cpu_tensors():
    """Only `take_columns` takes the plain version, and only for tensors on
    the CPU; the two forms are kernels."""
    tbl = torch.zeros((9, 5))
    idx = torch.zeros(3, dtype=torch.int32)
    K4.launches = K4.row_form_launches = 0
    for form in (K4.take_columns_direct, K4.take_columns_rows):
        with pytest.raises(ValueError, match="unsupported device"):
            form(tbl, idx)
    assert torch.equal(K4.take_columns(tbl, idx), tbl[:, [0, 0, 0]])
    assert K4.launches == 0 and K4.row_form_launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        K4.take_columns(tbl.to("meta"), idx.to("meta"))


# ---- the build digest ----

def test_digest_covers_every_file_under_csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    base = cuda_build._digest(copy)
    assert base == cuda_build._digest()
    assert {p.name for p in copy.iterdir()} >= {
        "row_read.cuh", *(name for name, _, _ in cuda_build.SOURCES)}
    header = copy / "row_read.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = cuda_build._digest(copy)
    assert edited != base
    (copy / "new_header.cuh").write_text("// new\n")
    added = cuda_build._digest(copy)
    assert added not in (base, edited)
    (copy / "new_header.cuh").rename(copy / "renamed.cuh")
    assert cuda_build._digest(copy) not in (base, edited, added)
    assert cuda_build._digest() == base
