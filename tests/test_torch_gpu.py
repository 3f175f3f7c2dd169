"""mpas_tpu_torch's CUDA kernels against their plain versions on the card,
and short runs on the card against the same runs on the CPU (the default
and the ownership-aligned edge numbering). Every test here needs a CUDA
device and skips without one. The file imports no JAX, so
on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Setup: generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels,
float64 on the CPU, moved to the card in the dtype under test (also one
moist and one cell-form step, and Kernel 2 at the call shapes they add);
Kernel 1 also on probes.acoustic_inputs at synthetic shapes; Kernels 3 and
4 on renumber_mesh(generate_mesh(levels=4)) (2562 cells). The radiation
call on a state with seeded condensate, and the CLI (a short run with
radiation, history and a checkpoint, and an exact restart from it), on the
card; the stacked 4-shard step (its halo refresh through Kernel 4) and a
regional run with its LBC stream, on the card against the CPU."""

import numpy as np
import pytest
import torch

from mpas_tpu_torch import probes
from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.mesh.renumber import renumber_mesh
from mpas_tpu_torch.ops import acoustic as TA
from mpas_tpu_torch.ops import acoustic_column as K1
from mpas_tpu_torch.ops import gather_reduce as K2
from mpas_tpu_torch.ops import recover as TR
from mpas_tpu_torch.ops import take_columns as K4
from mpas_tpu_torch.ops import windowed as K3

KW = dict(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
          config_jw_u_perturbation=1.0)
DTS = 240.0


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cpu_model():
    return build_model(Namelist(**KW),
                       generate_mesh(levels=3, lloyd_iterations=2),
                       device="cpu")


@pytest.fixture(scope="module")
def rmesh():
    return renumber_mesh(generate_mesh(levels=4))[0]


def rel_err(ref, out):
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-12)])
def test_acoustic_column_kernel_matches_plain(cuda, cpu_model, dtype, rtol):
    m = cpu_model
    state = TR.compute_moist_coefficients(m.state, m.mesh_arrays)
    coefs = TA.compute_vert_imp_coefs(state, m.static, m.vert, m.namelist, DTS)
    K, C = state.theta_m.shape
    rng = np.random.default_rng(7)

    def r(k, s, iface=False):
        a = rng.normal(0.0, s, (k, C))
        if iface:
            a[0] = a[-1] = 0.0
        return torch.from_numpy(a).to(cuda, dtype)

    dev = lambda t: t.to(cuda, dtype)
    coefs = TA.ImplicitCoefs(**{k: dev(v) for k, v in vars(coefs).items()})
    args = (r(K, 1e-4), r(K, 1e-2), r(K, 1e-4), r(K, 1e-2),
            r(K + 1, 1e-3, True), r(K + 1, 1e-3, True), None, None,
            r(K + 1, 1e-5, True), coefs, dev(m.static.zz),
            r(K + 1, 1e-6, True).abs(), r(K + 1, 1.0, True).abs(),
            r(K + 1, 1e-2, True), r(K + 1, 1e-3, True), DTS, 0.1)
    K1.launches = 0
    out = K1.acoustic_column_update(*args)
    ref = K1.acoustic_column_update_plain(*args)
    torch.cuda.synchronize()
    assert K1.launches == 1
    for o, p in zip(out, ref):
        assert bool(torch.isfinite(o).all())
        assert rel_err(p, o) < rtol


def _hold_acoustic(cuda, K, C, dtype, tendencies, tile=None, lanes=None):
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    args = probes.acoustic_args(probes.acoustic_inputs(K, C, seed=K + C),
                                cuda, dtype, tendencies)
    K1.launches = 0
    out = K1.acoustic_column_update(*args, tile=tile, lanes=lanes)
    ref = K1.acoustic_column_update_plain(*args)
    torch.cuda.synchronize()
    assert K1.launches == 1
    for o, p in zip(out, ref):
        assert o.shape == p.shape and bool(torch.isfinite(o).all())
        assert float((o - p).abs().max()) <= rtol * float(p.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("tendencies", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 31, 33, 1000])
@pytest.mark.parametrize("K", [1, 2, 3, 41, 64])
def test_acoustic_column_kernel_at_synthetic_shapes(cuda, K, C, dtype,
                                                    tendencies):
    """Down to one level and one column, column counts on either side of a
    tile, with tend_rho/tend_rt given and None."""
    _hold_acoustic(cuda, K, C, dtype, tendencies)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile,lanes", [(4, 64), (8, 3), (16, 16), (32, 1),
                                        (32, 16), (32, 32)])
def test_acoustic_column_kernel_takes_any_tile(cuda, dtype, tile, lanes):
    _hold_acoustic(cuda, 41, 1000, dtype, False, tile, lanes)
    _hold_acoustic(cuda, 5, 33, dtype, True, tile, lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_acoustic_column_kernel_at_the_most_levels(cuda, dtype):
    size = torch.empty((), dtype=dtype).element_size()
    most = K1.max_levels(size)
    _hold_acoustic(cuda, most, 33, dtype, True)
    assert K1.resident_ctas(most, dtype) == 1
    assert K1.resident_ctas(41, dtype) >= 2
    args = probes.acoustic_args(probes.acoustic_inputs(most + 1, 3), cuda,
                                dtype)
    with pytest.raises(K1.ColumnTileError):
        K1.acoustic_column_update(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_gather_reduce_kernel_matches_plain(cuda, cpu_model, dtype, S):
    mesh = cpu_model.mesh_arrays
    idx = mesh.advCellsForEdge.to(cuda)[:, 2:]              # strided rows
    rng = np.random.default_rng(S)
    tbl = torch.from_numpy(rng.normal(size=(19, mesh.nCells))).to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(S,) + tuple(idx.shape))
                         ).to(cuda, dtype)
    K2.launches = 0
    out = K2.gather_reduce(tbl, idx, w)
    ref = K2.gather_reduce_plain(tbl, idx, w)
    mag = K2.gather_reduce_plain(tbl.abs(), idx, w.abs())
    torch.cuda.synchronize()
    assert K2.launches == 1
    eps = torch.finfo(dtype).eps
    assert bool(((out - ref).abs() <= 4 * (idx.shape[1] + 1) * eps * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["direct", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("Kt,M,S", [(19, 8, 2), (41, 3, 1), (83, 10, 1),
                                    (97, 6, 3), (7, 7, 4), (200, 35, 1)])
def test_gather_reduce_forms_match_plain(cuda, form, dtype, Kt, M, S):
    """Each form by name at ragged shapes: R not a multiple of the CTA's
    rows, Kt not a multiple of the level chunk, strided idx rows, slot
    counts with and without a compile-time kernel, M above a warp."""
    R, N = 1000 + M, 642
    rng = np.random.default_rng(Kt + M)
    idx = torch.from_numpy(rng.integers(0, N, (R, M + 2), dtype=np.int32)
                           ).to(cuda)[:, 2:]               # strided rows
    tbl = torch.from_numpy(rng.normal(size=(Kt, N))).to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(S, R, M))).to(cuda, dtype)
    fn = K2.gather_reduce_direct if form == "direct" else K2.gather_reduce_rows
    K2.launches = K2.row_form_launches = 0
    out = fn(tbl, idx, w)
    ref = K2.gather_reduce_plain(tbl, idx, w)
    mag = K2.gather_reduce_plain(tbl.abs(), idx, w.abs())
    torch.cuda.synchronize()
    assert (K2.launches, K2.row_form_launches) == \
        ((1, 0) if form == "direct" else (2, 2))
    eps = torch.finfo(dtype).eps
    assert bool(((out - ref).abs() <= 4 * (M + 1) * eps * mag).all())


@pytest.mark.gpu
def test_gather_reduce_picks_its_form_from_the_index_table(cuda, cpu_model):
    mesh = cpu_model.mesh_arrays
    rng = np.random.default_rng(5)
    tbl = torch.from_numpy(rng.normal(size=(41, mesh.nEdges))).to(
        cuda, torch.float32)
    eoe = mesh.edgesOnEdge.to(cuda)
    rand = torch.from_numpy(rng.integers(0, mesh.nEdges, tuple(eoe.shape),
                                         dtype=np.int32)).to(cuda)
    w = torch.from_numpy(rng.normal(size=(1,) + tuple(eoe.shape))).to(
        cuda, torch.float32)
    for idx, row_launches in ((eoe, 0), (rand, 2)):
        K2.launches = K2.row_form_launches = 0
        out = K2.gather_reduce(tbl, idx, w)
        torch.cuda.synchronize()
        assert K2.row_form_launches == row_launches
        assert K2.launches == max(1, row_launches)
        ref = K2.gather_reduce_plain(tbl, idx, w)
        mag = K2.gather_reduce_plain(tbl.abs(), idx, w.abs())
        eps = torch.finfo(torch.float32).eps
        assert bool(((out - ref).abs()
                     <= 4 * (idx.shape[1] + 1) * eps * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("table,K,S", [("edgesOnCell", 41, 1),
                                       ("edgesOnEdge", 82, 2),
                                       ("cellsOnEdge", 5, 4)])
def test_windowed_reduce_kernel_on_an_unrenumbered_mesh(cuda, table, K, S):
    """Any numbering is legal: a block that names many columns has a long
    list, and the table is only as wide as the index range."""
    mesh = generate_mesh(levels=4)
    idx = np.asarray(getattr(mesh, table), np.int32)
    plan = K3.plan_windows(idx)
    rng = np.random.default_rng(K)
    N = int(idx.max()) + 1
    assert N < plan.min_table_width or table == "cellsOnEdge"
    tbl = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((S,) + idx.shape, np.float32))
    wT = torch.stack([K3.pad_weights(plan, x, cuda) for x in w])
    K3.launches = 0
    out = K3.windowed_gather_reduce(plan, tbl, wT)
    ref = K3.windowed_reduce_plain(plan, tbl, wT)
    mag = K3.windowed_reduce_plain(plan, tbl.abs(), wT.abs())
    torch.cuda.synchronize()
    assert K3.launches == 1 and out.shape == (S, K, idx.shape[0])
    eps = torch.finfo(torch.float32).eps
    assert bool(((out - ref).abs() <= 4 * (plan.M + 1) * eps * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("table,K,S", [("edgesOnCell", 48, 1),
                                       ("edgesOnCell", 168, 3),
                                       ("cellsOnEdge", 19, 2),
                                       ("edgesOnEdge", 7, 4)])
def test_windowed_reduce_kernel_matches_plain(cuda, rmesh, table, K, S):
    idx = np.asarray(getattr(rmesh, table), np.int32)
    plan = K3.plan_windows(idx)
    rng = np.random.default_rng(K)
    N = int(idx.max()) + 1
    tbl = torch.from_numpy(rng.standard_normal(
        (K, max(N, plan.min_table_width)), np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((S,) + idx.shape, np.float32))
    wT = torch.stack([K3.pad_weights(plan, x, cuda) for x in w])
    K3.launches = 0
    out = K3.windowed_gather_reduce(plan, tbl, wT)
    ref = K3.windowed_reduce_plain(plan, tbl, wT)
    mag = K3.windowed_reduce_plain(plan, tbl.abs(), wT.abs())
    torch.cuda.synchronize()
    assert K3.launches == 1 and out.shape == (S, K, idx.shape[0])
    eps = torch.finfo(torch.float32).eps
    assert bool(((out - ref).abs() <= 4 * (plan.M + 1) * eps * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_take_columns_kernel_matches_plain(cuda, rmesh, dtype):
    idx = torch.from_numpy(np.asarray(rmesh.cellsOnEdge[:, 1], np.int32)).to(cuda)
    rng = np.random.default_rng(11)
    tbl = torch.from_numpy(rng.normal(size=(83, rmesh.nCells))).to(cuda, dtype)
    K4.launches = 0
    out = K4.take_columns(tbl, idx)
    torch.cuda.synchronize()
    assert K4.launches == 1
    assert torch.equal(out, K4.take_columns_plain(tbl, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["direct", "rows"])
@pytest.mark.parametrize("indices", ["mesh", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [33, 1030])
@pytest.mark.parametrize("K", [3, 41, 83])
def test_take_columns_forms_match_index_select(cuda, rmesh, K, R, dtype,
                                               indices, form):
    """Each form by name, bit for bit: R no multiple of a tile's 32 rows, K
    under a sector, not a multiple of one, and over one pass; mesh indices
    are a strided column of cellsOnEdge."""
    rng = np.random.default_rng(K + R)
    N = rmesh.nCells
    if indices == "mesh":
        idx = torch.from_numpy(np.asarray(rmesh.cellsOnEdge, np.int32)
                               ).to(cuda)[:R, 1]
        assert idx.stride(0) == 2
    else:
        idx = torch.from_numpy(rng.integers(0, N, R, dtype=np.int32)).to(cuda)
    tbl = torch.from_numpy(rng.normal(size=(K, N))).to(cuda, dtype)
    fn = K4.take_columns_direct if form == "direct" else K4.take_columns_rows
    K4.launches = K4.row_form_launches = 0
    out = fn(tbl, idx)
    torch.cuda.synchronize()
    assert (K4.launches, K4.row_form_launches) == \
        ((1, 0) if form == "direct" else (2, 2))
    assert torch.equal(out, torch.index_select(tbl, 1, idx))


@pytest.mark.gpu
def test_take_columns_picks_its_form_from_the_index_vector(cuda, rmesh):
    inp = probes.gather_probe_inputs(K=83, C=rmesh.nCells, R=rmesh.nEdges,
                                     M=1, seed=6)
    tbl = torch.from_numpy(inp["tbl"]).to(cuda)
    coe = torch.from_numpy(np.asarray(rmesh.cellsOnEdge, np.int32)).to(cuda)
    for idx, row_launches in ((coe[:, 0], 0),
                              (torch.from_numpy(inp["idx"]).to(cuda), 2),
                              ):
        for t, rl in ((tbl, row_launches), (tbl[:7].contiguous(), 0)):
            K4.launches = K4.row_form_launches = 0
            out = K4.take_columns(t, idx)
            torch.cuda.synchronize()
            assert K4.row_form_launches == rl
            assert K4.launches == max(1, rl)
            assert torch.equal(out, K4.take_columns_plain(t, idx))


@pytest.mark.gpu
def test_wrappers_reject_bad_arguments(cuda):
    tbl = torch.zeros((3, 10), device=cuda)
    idx = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        K2.gather_reduce(tbl, idx, torch.zeros((1, 4, 2), device=cuda))
    with pytest.raises(ValueError):
        K2.gather_reduce(tbl, idx.int(), torch.zeros((5, 4, 2), device=cuda))
    with pytest.raises(ValueError):
        K2.gather_reduce(tbl.t(), idx.int(), torch.zeros((1, 4, 2), device=cuda))
    with pytest.raises(TypeError):
        K4.take_columns(tbl, idx[:, 0])
    with pytest.raises(ValueError):
        K4.take_columns(tbl.t(), idx[:, 0].int())
    for form in (K4.take_columns_direct, K4.take_columns_rows):
        with pytest.raises(TypeError):
            form(tbl, idx[:, 0])
        with pytest.raises(TypeError):
            form(tbl.half(), idx[:, 0].int())
        with pytest.raises(ValueError):
            form(tbl.t(), idx[:, 0].int())
        with pytest.raises(ValueError):
            form(tbl, idx[:0, 0].int())
        with pytest.raises(ValueError):
            form(tbl, idx[:, 0].int().cpu())
    col = probes.acoustic_args(probes.acoustic_inputs(3, 10), cuda,
                               torch.float32)
    with pytest.raises(ValueError, match="shape"):
        K1.acoustic_column_update(col[0][:, :9].contiguous(), *col[1:])
    with pytest.raises(TypeError):
        K1.acoustic_column_update(col[0].double(), *col[1:])
    with pytest.raises(ValueError, match="contiguous"):
        K1.acoustic_column_update(col[0].t().contiguous().t(), *col[1:])
    for tile, lanes in ((64, 32), (0, 4), (32, 0)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            K1.acoustic_column_update(*col, tile=tile, lanes=lanes)
    plan = K3.plan_windows(np.zeros((4, 2), np.int32))
    wT = torch.zeros((1, 2, plan.Rp), device=cuda)
    with pytest.raises(TypeError):
        K3.windowed_gather_reduce(plan, tbl.double(), wT)
    with pytest.raises(ValueError):
        K3.windowed_gather_reduce(plan, tbl, torch.zeros((5, 2, plan.Rp),
                                                         device=cuda))


@pytest.mark.gpu
def test_two_steps_on_the_card_match_the_cpu(cuda, cpu_model):
    gpu = build_model(Namelist(**KW), cpu_model.mesh, device="cuda")
    cpu = build_model(Namelist(**KW), cpu_model.mesh, device="cpu")
    K1.launches = K2.launches = K2.row_form_launches = 0
    gpu.step(2)
    cpu.step(2)
    assert K1.launches == 8 and K2.launches == 54
    assert K2.row_form_launches == 0
    for n in ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p"):
        assert rel_err(getattr(cpu.state, n), getattr(gpu.state, n).cpu()) < 1e-9


@pytest.mark.gpu
def test_two_aligned_steps_on_the_card_match_the_cpu(cuda, cpu_model):
    nl = Namelist(**KW, config_orient_edges=True)
    gpu = build_model(nl, cpu_model.mesh, device="cuda")
    cpu = build_model(nl, cpu_model.mesh, device="cpu")
    assert gpu.mesh_arrays.owner_aligned
    K1.launches = K2.launches = 0
    gpu.step(2)
    cpu.step(2)
    assert K1.launches == 8 and K2.launches > 0
    for n in ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p"):
        assert rel_err(getattr(cpu.state, n), getattr(gpu.state, n).cpu()) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("table,n_from,Kt,S", [
    ("advCellsForEdge", "nCells", 246, 2),      # 6 species x 41 levels folded
    ("edgesOnCell", "nEdges", 246, 1),          # their flux divergence
    ("verticesOnCell", "nVertices", 41, 1)])    # Hollingsworth / APVM sums
def test_gather_reduce_kernel_at_the_moist_call_shapes(cuda, cpu_model, dtype,
                                                       table, n_from, Kt, S):
    """The call shapes the moist and cell-form steps add: the species folded
    into the level axis, and the vertex -> cell reduction."""
    mesh = cpu_model.mesh_arrays
    idx = getattr(mesh, table).to(cuda)
    rng = np.random.default_rng(Kt + S)
    tbl = torch.from_numpy(rng.normal(size=(Kt, getattr(mesh, n_from)))
                           ).to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(S,) + tuple(idx.shape))
                         ).to(cuda, dtype)
    K2.launches = 0
    out = K2.gather_reduce(tbl, idx, w)
    ref = K2.gather_reduce_plain(tbl, idx, w)
    mag = K2.gather_reduce_plain(tbl.abs(), idx, w.abs())
    torch.cuda.synchronize()
    assert K2.launches == 1
    eps = torch.finfo(dtype).eps
    assert bool(((out - ref).abs() <= 4 * (idx.shape[1] + 1) * eps * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("changes", [
    dict(config_moisture=True, config_microphysics="wsm6",
         config_pbl="ysu_lite"),
    dict(config_cell_form_ops=True, config_hollingsworth=True,
         config_apvm_upwinding=0.5)], ids=["moist", "cell_form"])
def test_one_moist_step_on_the_card_matches_the_cpu(cuda, cpu_model, changes):
    nl = Namelist(**KW, **changes)
    gpu = build_model(nl, cpu_model.mesh, device="cuda")
    cpu = build_model(nl, cpu_model.mesh, device="cpu")
    K1.launches = K2.launches = 0
    gpu.step(1)
    cpu.step(1)
    assert K1.launches == 4 and K2.launches > 27
    names = ["u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p"]
    if cpu.state.scalars is not None:
        names += ["scalars", "rainnc"]
    for n in names:
        assert rel_err(getattr(cpu.state, n), getattr(gpu.state, n).cpu()) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_radiation_on_the_card_matches_the_cpu(cuda, cpu_model, dtype):
    """Model.apply_physics on a JW + WSM6 state with condensate seeded
    across the freezing level: float64 within 1e-9 of the CPU, float32
    within 1e-3 (its heating rates, then one step each)."""
    from mpas_tpu_torch.physics.driver import physics_init
    nl = Namelist(**dict(KW, dtype=dtype), config_moisture=True,
                  config_microphysics="wsm6", config_pbl="ysu_lite")
    cpu = build_model(nl.replace(dtype="float64"), cpu_model.mesh,
                      device="cpu")
    gpu = build_model(nl, cpu_model.mesh, device="cuda")
    cpu.state = probes.seeded_condensate(cpu.state, seed=0)
    gpu.state = gpu.state.replace(scalars=cpu.state.scalars.to(
        cuda, gpu.dtype))
    phys = physics_init()
    d_cpu = cpu.apply_physics(phys, julian=80.25)
    d_gpu = gpu.apply_physics(phys, julian=80.25)
    tol = 1e-9 if dtype == "float64" else 1e-3
    assert d_cpu["cldfra"].max() == 1.0
    for k in ("rthraten", "qrs", "qrl", "olr", "fsns", "cldfra"):
        assert rel_err(torch.from_numpy(d_cpu[k]).double(),
                       torch.from_numpy(d_gpu[k]).double()) < tol, k
    K1.launches = K2.launches = 0
    gpu.step(1)
    cpu.step(1)
    assert K1.launches == 4 and K2.launches > 27
    assert rel_err(cpu.state.theta_m, gpu.state.theta_m.cpu().double()) < tol


@pytest.mark.gpu
def test_cli_on_the_card(cuda, tmp_path, monkeypatch):
    """`python -m mpas_tpu_torch`'s main on the card: radiation, a history
    and a checkpoint; 2 steps + restart + 2 steps give the history of 4
    straight steps bit for bit."""
    from mpas_tpu_torch import __main__ as cli
    from mpas_tpu_torch.mesh.netcdf_io import read_netcdf
    monkeypatch.setenv("HOME", str(tmp_path))
    flags = ["--grid", "generate:3", "--levels", "8", "--dtype", "float64",
             "--physics", "--radt-steps", "2", "--output-full-3d", "--quiet",
             "--device", "cuda"]
    path = lambda n: str(tmp_path / n)
    K1.launches = 0
    assert cli.main(flags + ["--steps", "4", "--output", path("a.nc"),
                             "--checkpoint-path", path("a.npz")]) == 0
    assert K1.launches == 16
    assert cli.main(flags + ["--steps", "2", "--checkpoint-every", "2",
                             "--output", path("b.nc"), "--checkpoint-path",
                             path("b.npz")]) == 0
    assert cli.main(flags + ["--steps", "2", "--restart", path("b.npz"),
                             "--output", path("c.nc"), "--checkpoint-path",
                             path("c.npz")]) == 0
    a, c = read_netcdf(path("a.nc")), read_netcdf(path("c.nc"))
    for k in ("u", "w", "theta", "pressure_p", "surface_pressure"):
        assert np.array_equal(a[k], c[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ppermute", "all_to_all"])
def test_stacked_sharded_step_on_the_card_matches_the_cpu(cuda, cpu_model,
                                                          mode):
    """4 shards side by side on the card: the halo refresh goes through
    Kernel 4, bit-equal to its plain version on the exchange's own source
    vectors; 2 steps match the same stacked steps on the CPU and the
    single-device step on owned entries."""
    from mpas_tpu_torch.parallel import halo
    from mpas_tpu_torch.parallel.sharded import shard_model
    nl = Namelist(**KW, config_halo_exchange=mode)
    gpu = shard_model(build_model(nl, cpu_model.mesh, device="cuda"), 4)
    cpu = shard_model(build_model(nl, cpu_model.mesh, device="cpu"), 4)
    for tbl in (gpu.tables.cell, gpu.tables.edge):
        x = torch.randn(41, tbl.source.shape[0], device=cuda,
                        dtype=torch.float64)
        assert torch.equal(K4.take_columns(x, tbl.source),
                           K4.take_columns_plain(x, tbl.source))
    K1.launches = K4.launches = halo.exchanges = 0
    gpu.step(2)
    torch.cuda.synchronize()
    assert K1.launches == 8 and K4.launches >= halo.exchanges == 24
    cpu.step(2)
    single = build_model(nl, cpu_model.mesh, device="cpu")
    single.step(2)
    g = gpu.gather_state(cpu_model.mesh)
    c = cpu.gather_state(cpu_model.mesh)
    for n in ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p"):
        assert rel_err(torch.from_numpy(c[n]), torch.from_numpy(g[n])) < 1e-9
        assert rel_err(getattr(single.state, n),
                       torch.from_numpy(g[n])) < 1e-9, n


@pytest.mark.gpu
def test_regional_steps_on_the_card_match_the_cpu(cuda):
    """A regional run (NH cap, 5 relaxation rings) driven by a stream from
    2 global steps: 2 RegionalDriver steps on the card and on the CPU."""
    from mpas_tpu_torch.io import lbc
    from mpas_tpu_torch.mesh.coefficients import mark_regional_zones
    mesh = generate_mesh(levels=3, lloyd_iterations=2)
    mesh = mark_regional_zones(mesh, mesh.latCell > 0.15, n_relax=5)
    nl = Namelist(**KW)
    drive = build_model(nl, mesh, device="cpu")
    cells, edges = lbc.zone_indices(mesh)
    snaps = [lbc.extract_lbc(drive.state, cells, edges)]
    drive.step(2)
    snaps.append(lbc.extract_lbc(drive.state, cells, edges))
    stream = lbc.build_stream([0.0, 2 * nl.config_dt], cells, edges, snaps)
    nl = nl.replace(config_apply_lbcs=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = build_model(nl, mesh, device=dev)
        lbc.RegionalDriver(m, stream).step(2)
        runs[dev] = m.state
    for n in ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p"):
        assert rel_err(getattr(runs["cpu"], n),
                       getattr(runs["cuda"], n).cpu()) < 1e-9, n
