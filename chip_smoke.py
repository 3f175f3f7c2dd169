#!/usr/bin/env python3
"""Smoke run of mpas_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths, a dry Jablonowski-Williamson baroclinic-wave
run and the same wave run moist (scalar transport, WSM6 microphysics, the
PBL), through `build_model` and `Model.step` at full width (the x1.40962
mesh, 41 levels, float32, dt=300 s), and holds every CUDA kernel of those
paths against its plain PyTorch version on the inputs the paths give it.
Phases, each printing one JSON line:

  1. nvidia-smi: the card's name and power limit;
  2. build: compile csrc/*.cu (one nvcc per object, in parallel), with each
     kernel's registers, static shared memory and spills from ptxas -v;
  3. acoustic_column: Kernel 1 against its plain version on the inputs of
     the step's first call, in float32 and (inputs widened) float64, with
     its tile (columns, level lanes, shared-memory bytes, CTAs an SM) and
     other tiles timed in turns; acoustic_column_shapes: the kernel against
     its plain version at small synthetic shapes (probes.acoustic_inputs),
     down to one level and one column and up to the most levels a tile
     holds, with and without the tendency arguments;
  4. gather_reduce: Kernel 2 against its plain version at every distinct
     call shape of one step: the form the wrapper picks, and both forms by
     name, in float32 and (inputs widened) float64; its times on a busy
     device, with a cold L2 and launched onto an idle device; gather_forms:
     both forms in turns on the edgesOnEdge reduction;
  5. main path: 10 full-width steps with the launch counters set to 0
     first; no NaN, sane extrema, each kernel launched;
  6. profile: PROFILE_STEPS more steps traced with torch.profiler, for
     launches per step, the device-busy share and device time by kernel;
  6b. sharded: the same model decomposed into SHARDS shards side by side on
     the card (parallel/sharded.py's stacked back end): Kernel 4 bit-equal
     to its plain version on the halo exchange's own source vectors, with
     its times; SHARDED_STEPS counted steps (launches of Kernels 1, 2 and 4,
     exchanges and halo bytes a step beside
     partition.exchange_bytes_per_step, S*L/N of each entity), steps timed
     in turns with the single-device step, a traced window, and
     sharded_summarize against host_summarize_oracle;
  6c. regional: the mesh marked with the NH cap's zones, a global driving
     run of REGIONAL_STEPS steps with an LBC snapshot every LBC_EVERY, then
     io/lbc.RegionalDriver steps in turns with the global run replayed:
     ms and launches a step of each, the specified zone against the stream
     at each step's start, the interior within REGIONAL_BOUND of the
     global run;
  7. main_path_orient: the same run with config_orient_edges=True (the JAX
     bench's setting) on the same mesh, with Kernel 2 checked at the shapes
     the aligned step adds (gather_reduce_orient, gather_forms), 10 counted
     steps and PROFILE_STEPS traced ones;
  7b. main_path_moist: the moist path at the same width, JW with
     config_moisture, config_microphysics="wsm6" and config_pbl="ysu_lite"
     on the default numbering: Kernel 2 at the call shapes the moist step
     adds (gather_reduce_moist), 10 counted steps (launches of Kernels 1 and
     2, the sedimentation substeps, each species' range, rainnc), and
     profile_moist: PROFILE_STEPS traced steps and the step's three moist
     parts (scalar transport, microphysics, PBL) traced one by one, the dry
     part being what is left;
  7c. radiation: on the same model, Model.apply_physics (the CAM-style SW/LW
     radiation, radiation every RADT_STEPS steps as the CLI's default) once
     to warm up, then one call timed (CUDA events and the host clock, peak
     memory) and one traced (launches, kernel device time); the heating
     rates, OLR and cloud fraction; then RADIATION_STEPS steps with the
     heating applied;
  8. agreement: 2 steps on the card and on the CPU at x1.2562, float64,
     port against port: dry JW on the default numbering and (agreement_
     orient) with config_renumber_mesh and config_orient_edges; JW with
     WSM6 and the PBL (agreement_moist, scalars and rainnc compared too);
     dry JW in cell form with the Hollingsworth correction and APVM
     upwinding (agreement_cellform); the mountain wave (agreement_mountain)
     and the squall line with WSM6 (agreement_squall) on a reduced planet;
     agreement_radiation: JW + WSM6 + PBL with condensate seeded across the
     freezing level (probes.seeded_condensate), one radiation call and 2
     steps, rt_diabatic_tend, every diagnostic and every state field;
     agreement_regional: 2 RegionalDriver steps on the card and the CPU;
     agreement_sharded: 2 stacked 4-shard steps on the card against the CPU
     and against the single-device step on the card (owned entries);
  8b. squall: 60 float32 steps of the squall line on the card (2562 cells,
     16 levels): a convective updraft, condensate, no negative rain;
  8c. cli: `python -m mpas_tpu_torch`'s main in this process on the card: a
     full-width moist run with radiation, history and checkpoints (its own
     ms/step, the files' sizes, launches of Kernels 1 and 2), and a restart
     leg at x1.2562, float64: 4 straight steps against 2 + restart + 2,
     whose final histories must be bit-equal; and the same with --shards
     SHARDS: its history within AGREE_REL of the single-device leg's, its
     checkpoint in the SHARDS-shard layout, its restart bit-equal;
  9. windowed_study: Kernel 3 (windowed gather-reduce) against its plain
     version, Kernel 2 and the index_select loop on the RCM-renumbered
     x1.40962 mesh at Kst = 48 and 168 levels (probes.windowed_study), and
     windowed_step_table: Kernel 3 beside Kernel 2 on the step's own
     edgesOnEdge reduction (82 levels) on the default and aligned numbering;
 10. gather_probe: Kernel 4 (column gather, the probe's A and B) and
     Kernel 2 (its C, both forms) at K=83, C=40962, R=122880, M=10
     (probes.gather_probe); take_forms: both forms of Kernel 4 and
     `index_select` in turns at the probe's random indices and at
     cellsOnEdge[:, 0] with a share of random entries;
 11. take_columns_step: Kernel 4 beside `index_select` at every distinct
     gather of `stencils.take_packed` and `edge_pair*` in one step, on both
     numberings: whether Kernel 4 behind `take_packed` would pay.

Every timed phase carries the card's SM clock, its maximum, temperature and
power draw read before and after it (`smi_before`, `smi_after`). Then a
`kernels` line (each kernel's launches on every path that runs it: Kernels
1 and 2 also `launches_sharded` and `launches_regional`, Kernel 4
`launches_sharded` and `exchange`, its check and times on the halo
exchange), the nvidia-smi line, and last the `ok` line. Any failed
check raises, so the script exits non-zero; without a CUDA device it exits
non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,    # non-tensor-core float32, data sheet
              "float64": 34e12}    # non-tensor-core float64, data sheet
# floating-point operations per column and level of the acoustic column
# kernel, counted from csrc/acoustic_column.cu (rs/ts and the right-hand side
# ~37, the two sweeps 4, damping, wwAvg and recovery ~23)
ACOUSTIC_FLOPS_PER_POINT = 64
MAIN_STEPS = 10
ORIENT_STEPS = 5      # the aligned numbering's counted steps
SQUALL_STEPS = 60
DRY_K2_PER_STEP = 27  # Kernel 2 launches of a dry default-numbering step
PROFILE_STEPS = 3
PROFILE_TOP = 15
K1_F32_REL = 1e-4     # float32 kernel vs plain, relative to max |plain|
K1_F64_REL = 1e-12    # float64 bound of tests/test_pallas.py
AGREE_REL = 1e-9      # float64 card vs CPU after 2 steps, per field
# Kernel 1 at synthetic shapes: levels x columns, and (tile columns, level
# lanes) forced on one ragged shape beside the wrapper's own choice
K1_SHAPE_LEVELS = (1, 2, 3, 41, 64)
K1_SHAPE_COLUMNS = (1, 31, 33, 1000)
K1_FORCED_TILES = ((4, 64), (8, 3), (16, 16), (32, 1), (32, 16))
# tiles timed in turns beside the wrapper's choice at the step's shape
K1_TIMED_TILES = ((32, 8), (32, 14), (16, 14), (16, 21), (8, 21), (8, 42))
TAKE_MIXED_FRACTIONS = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
RADIATION_JULIAN = 80.25   # equinox, 06 UTC: half the planet in daylight
RADT_STEPS = 5             # the CLI's default --radt-steps
RADIATION_STEPS = 2        # steps taken with the heating applied
CLI_STEPS = 10
SHARDS = 4                 # the stacked back end's shards on the one card
SHARDED_STEPS = 10
TURN_PAIRS = 6             # steps of each of two runs timed in turns
REGIONAL_STEPS = 12
LBC_EVERY = 3              # steps between the driving run's LBC snapshots
REGIONAL_BOUND = 0.2       # interior |du|, |dtheta_m|: tests/test_lbc.py
ZONE_REL = 1e-5            # specified zone against the stream, float32
SUMMARY_REL = 1e-6         # device summarize against the host oracle, f32
# the namelist of the CLI's runs: the moist path of main_path_moist
CLI_NAMELIST = {"config_moisture": True, "config_microphysics": "wsm6",
                "config_pbl": "ysu_lite", "config_jw_u_perturbation": 1.0}


def emit(obj):
    print(json.dumps(obj), flush=True)


def busy_us(events):
    """Length of the union of the events' [start, end) device intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace(fn, torch):
    """Run fn() under torch.profiler: the device's kernel events and the
    traced wall time in microseconds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("profile: the trace holds no device activity")
    return kernels, wall_us


def profile_steps(model, n, torch):
    """Trace `n` steps: launches per step, the device-busy share (union of
    the kernels' device intervals over the traced wall time), and device
    time per step by kernel name, largest first."""
    kernels, wall_us = trace(lambda: model.step(n), torch)
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    device_us = sum(v[1] for v in by_name.values())
    by_kind = lambda *keys: sum(us for k, (_, us) in by_name.items()
                                if any(x in k for x in keys)) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:PROFILE_TOP]
    return dict(
        traced_steps=n, traced_wall_ms=wall_us / 1e3,
        device_busy_share=busy_us(kernels) / wall_us,
        kernel_device_ms_per_step=device_us / 1e3 / n,
        launches_per_step=len(kernels) / n,
        # index_select and torch.gather: one kernel in recent PyTorch builds
        gather_ms_per_step=by_kind("scatter_gather", "indexSelect"),
        cat_ms_per_step=by_kind("CatArray"),
        top_kernels=[{"name": k[:90], "launches_per_step": c / n,
                      "ms_per_step": us / 1e3 / n,
                      "share_of_kernel_time": us / device_us}
                     for k, (c, us) in top])


def profile_moist_parts(model, whole, torch):
    """The moist step's four-way split. Scalar transport, microphysics and
    the PBL are pure functions of the state, so each is traced on its own
    on the model's current state (once to warm up, once traced): launches,
    kernel device time, traced wall time. The dry part is what is left of
    `whole` (profile_steps of the same model)."""
    from mpas_tpu_torch.ops import scalars
    from mpas_tpu_torch.physics import pbl, wsm6
    m, s, nl = model, model.state, model.namelist
    dt = nl.config_dt
    parts = {
        "scalar_transport": lambda: scalars.advance_scalars_mono(
            s.scalars, s.rho_zz, s.ruAvg, s.wwAvg, m.mesh_arrays, m.vert, nl,
            dt),
        "microphysics": lambda: wsm6.apply_wsm6(
            s, m.static, m.vert, nl, dt,
            full=(nl.config_microphysics == "wsm6")),
        "pbl": lambda: pbl.apply_pbl(s, m.static, m.vert, m.mesh_arrays, nl,
                                     dt),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        kernels, wall_us = trace(fn, torch)
        out[name] = dict(
            launches=len(kernels), wall_ms=wall_us / 1e3,
            kernel_device_ms=sum(e.time_range.end - e.time_range.start
                                 for e in kernels) / 1e3)
    step_wall = whole["traced_wall_ms"] / whole["traced_steps"]
    out["dry"] = dict(
        launches=whole["launches_per_step"]
        - sum(p["launches"] for p in out.values()),
        wall_ms=step_wall - sum(p["wall_ms"] for p in out.values()),
        kernel_device_ms=whole["kernel_device_ms_per_step"]
        - sum(p["kernel_device_ms"] for p in out.values()))
    for p in out.values():
        p["share_of_launches"] = p["launches"] / whole["launches_per_step"]
        p["share_of_wall"] = p["wall_ms"] / step_wall
    return out


SPECIES = ("qv", "qc", "qr", "qi", "qs", "qg")


def check_moisture(state, what):
    """Range of each species and of rainnc, and the mean water a cell holds;
    fails on a non-finite value, a species below -1e-7 or negative rain."""
    if not (bool(state.scalars.isfinite().all())
            and bool(state.rainnc.isfinite().all())):
        raise RuntimeError(f"{what}: non-finite species or rainnc")
    out = {name: [float(q.min()), float(q.max())]
           for name, q in zip(SPECIES, state.scalars)}
    out["rainnc"] = [float(state.rainnc.min()), float(state.rainnc.max())]
    out["total_water_mean"] = float(state.scalars.sum(dim=0).mean())
    if float(state.scalars.min()) < -1e-7:
        raise RuntimeError(f"{what}: a species went negative: {out}")
    if out["rainnc"][0] < 0.0:
        raise RuntimeError(f"{what}: negative accumulated rain: {out}")
    return out


def smi_clocks():
    """SM clock, its maximum, temperature and power draw, as nvidia-smi
    prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


def timed(fn):
    """fn()'s result (a dict) with the clocks read before and after it."""
    before = smi_clocks()
    res = fn()
    return dict(res, smi_before=before, smi_after=smi_clocks())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nb, flops, dtype_name):
    t_bytes = nb / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def record_step(model):
    """Run one step with both wrappers and `stencils.gather` wrapped,
    keeping the arguments of the first acoustic column call, of the first
    gather-reduce call of each shape (Kt, N, R, M, S) and of the first
    gather of each (Kt, N, R, index vector), and the number of calls of
    each."""
    from mpas_tpu_torch.ops import acoustic, stencils
    k1_args, k2_calls, gathers = [], {}, {}
    k1_orig, k2_orig = acoustic.acoustic_column_update, stencils.gather_reduce
    gather_orig = stencils.gather

    def k1(*args):
        if not k1_args:
            k1_args.append(args)
        return k1_orig(*args)

    def k2(tbl, idx, w):
        key = (tbl.shape[0], tbl.shape[1], idx.shape[0], idx.shape[1],
               w.shape[0])
        hit = k2_calls.setdefault(key, {"calls": 0, "args": (tbl, idx, w)})
        hit["calls"] += 1
        return k2_orig(tbl, idx, w)

    def gather(f, idx):
        key = (f.shape[0], f.shape[1], idx.shape[0], idx.data_ptr(),
               idx.stride(0))
        hit = gathers.setdefault(key, {"calls": 0, "args": (f, idx)})
        hit["calls"] += 1
        return gather_orig(f, idx)

    acoustic.acoustic_column_update, stencils.gather_reduce = k1, k2
    stencils.gather = gather
    try:
        model.step(1)
    finally:
        acoustic.acoustic_column_update, stencils.gather_reduce = k1_orig, k2_orig
        stencils.gather = gather_orig
    return k1_args[0], k2_calls, gathers


def check_acoustic(args, torch):
    from mpas_tpu_torch.ops import acoustic_column as ac
    from mpas_tpu_torch.probes import cuda_ms
    from mpas_tpu_torch.ops.acoustic import ImplicitCoefs

    def widen(a):
        if isinstance(a, ImplicitCoefs):
            return ImplicitCoefs(**{k: v.double() for k, v in vars(a).items()})
        return a.double() if torch.is_tensor(a) else a

    res = {}
    for name, a in (("float32", args), ("float64", tuple(widen(x) for x in args))):
        out_k = ac.acoustic_column_update(*a)
        out_p = ac.acoustic_column_update_plain(*a)
        torch.cuda.synchronize()
        err, rel = 0.0, 0.0
        for k, p in zip(out_k, out_p):
            e = float((k - p).abs().max())
            err = max(err, e)
            rel = max(rel, e / max(float(p.abs().max()), 1e-30))
        limit = K1_F32_REL if name == "float32" else K1_F64_REL
        if not all(bool(torch.isfinite(o).all()) for o in out_k):
            raise RuntimeError(f"acoustic_column {name}: non-finite output")
        if not rel <= limit:
            raise RuntimeError(f"acoustic_column {name}: rel err {rel} > {limit}")
        rs0 = a[0]
        K, C = rs0.shape
        ins = [x for x in a[:9] if torch.is_tensor(x)]
        coefs = a[9]
        ins += [coefs.cofrz, coefs.cofwz, coefs.coftz, coefs.cofwr,
                coefs.cofwt, coefs.a_tri, coefs.alpha_tri, coefs.gamma_tri]
        ins += [x for x in a[10:15]]
        nb = nbytes(*ins) + nbytes(*out_k)
        b_ms, b_by = bound(nb, ACOUSTIC_FLOPS_PER_POINT * K * C, name)
        k1 = lambda: ac.acoustic_column_update(*a)
        ms = cuda_ms(k1)
        plain_ms = cuda_ms(lambda: ac.acoustic_column_update_plain(*a), reps=20)
        tile, lanes, smem = ac.tile_plan(K, rs0.element_size())
        # what the card takes to move as many bytes with a plain copy (half
        # read, half written): the bound is the data sheet's rate, this is
        # the rate a copy reaches
        half = torch.empty(nb // 2, dtype=torch.uint8, device=rs0.device)
        dest = torch.empty_like(half)
        copy_ms = cuda_ms(lambda: dest.copy_(half))
        del half, dest
        # other tiles beside the wrapper's, in turns (there and back)
        tiles = {}
        for t, l in K1_TIMED_TILES + K1_TIMED_TILES[::-1]:
            out_t = ac.acoustic_column_update(*a, tile=t, lanes=l)
            if not all(torch.equal(x, y) for x, y in zip(out_t, out_k)):
                raise RuntimeError(f"acoustic_column {name}: tile {t}x{l} "
                                   "differs from the wrapper's tile")
            tiles.setdefault(f"{t}x{l}", []).append(cuda_ms(
                lambda: ac.acoustic_column_update(*a, tile=t, lanes=l)))
        res[name] = dict(K=K, C=C, max_abs_err=err, max_rel_err=rel,
                         limit_rel=limit, ms=ms, plain_ms=plain_ms,
                         ms_cold_l2=cuda_ms(k1, cold_l2=True),
                         ms_after_idle=cuda_ms(k1, after_idle=True),
                         bytes=nb, bound_ms=b_ms, bound_by=b_by,
                         copy_same_bytes_ms=copy_ms, tile_columns=tile, level_lanes=lanes,
                         smem_bytes=smem,
                         ctas_per_sm=ac.resident_ctas(K, rs0.dtype),
                         tiles_ms={k: sum(v) / len(v)
                                   for k, v in tiles.items()},
                         tiles_ctas_per_sm={
                             f"{t}x{l}": ac.resident_ctas(K, rs0.dtype, t, l)
                             for t, l in K1_TIMED_TILES})
    return res


def check_acoustic_shapes(torch):
    """Kernel 1 against its plain version at synthetic shapes: every K of
    K1_SHAPE_LEVELS x every C of K1_SHAPE_COLUMNS, float32 and float64,
    with tend_rho/tend_rt given and None; the forced tiles of
    K1_FORCED_TILES on a ragged shape; and the most levels a tile holds in
    float64. Raises where an output is not finite or over its limit."""
    from mpas_tpu_torch import probes
    from mpas_tpu_torch.ops import acoustic_column as ac
    worst = {"float32": (0.0, None), "float64": (0.0, None)}
    cases = 0

    def hold(K, C, dtype, tend, tile=None, lanes=None):
        nonlocal cases
        name = str(dtype).replace("torch.", "")
        a = probes.acoustic_args(probes.acoustic_inputs(K, C, seed=K + C),
                                 "cuda", dtype, tend)
        out_k = ac.acoustic_column_update(*a, tile=tile, lanes=lanes)
        out_p = ac.acoustic_column_update_plain(*a)
        torch.cuda.synchronize()
        limit = K1_F32_REL if dtype == torch.float32 else K1_F64_REL
        what = dict(K=K, C=C, dtype=name, tendencies=tend,
                    tile=ac.tile_plan(K, a[0].element_size(), tile, lanes))
        for k, p in zip(out_k, out_p):
            if k.shape != p.shape or not bool(torch.isfinite(k).all()):
                raise RuntimeError(f"acoustic_column_shapes {what}: shape or "
                                   "non-finite output")
            rel = float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)
            if not rel <= limit:
                raise RuntimeError(f"acoustic_column_shapes {what}: rel err "
                                   f"{rel} > {limit}")
            if rel > worst[name][0]:
                worst[name] = (rel, what)
        cases += 1

    for dtype in (torch.float32, torch.float64):
        for K in K1_SHAPE_LEVELS:
            for C in K1_SHAPE_COLUMNS:
                for tend in (True, False):
                    hold(K, C, dtype, tend)
        for tile, lanes in K1_FORCED_TILES:
            hold(41, 1000, dtype, False, tile, lanes)
            hold(5, 33, dtype, True, tile, lanes)
    k_max = ac.max_levels(8)
    hold(k_max, 33, torch.float64, True)
    hold(ac.max_levels(4), 33, torch.float32, False)
    try:
        ac.tile_plan(k_max + 1, 8)
    except ac.ColumnTileError:
        pass
    else:
        raise RuntimeError("acoustic_column_shapes: no error beyond the "
                           "most levels a tile holds")
    return dict(cases=cases, levels=list(K1_SHAPE_LEVELS),
                columns=list(K1_SHAPE_COLUMNS),
                forced_tiles=[list(t) for t in K1_FORCED_TILES],
                max_levels_float64=k_max, max_levels_float32=ac.max_levels(4),
                limit_rel={"float32": K1_F32_REL, "float64": K1_F64_REL},
                worst_rel={k: v[0] for k, v in worst.items()},
                worst_case={k: v[1] for k, v in worst.items()})


def index_vector_names(mesh_arrays):
    """{(address, stride): name} of the index vectors `take_packed` and
    `edge_pair*` gather through."""
    names = {}
    for table in ("cellsOnEdge", "verticesOnEdge"):
        t = getattr(mesh_arrays, table)
        for j in range(t.shape[1]):
            names[(t[:, j].data_ptr(), t.stride(0))] = f"{table}[:, {j}]"
    return names


def check_take_columns_step(gathers, names, numbering, torch):
    """Kernel 4 (the form it picks) beside `torch.index_select` at every
    distinct gather of one step, in turns: exact equality, times, bound,
    calls per step, and whether Kernel 4 would pay there (`gate`)."""
    from mpas_tpu_torch.ops import take_columns as tc
    from mpas_tpu_torch.probes import cuda_ms
    rows = []
    for (Kt, N, R, ptr, stride), hit in gathers.items():
        tbl, idx = hit["args"]
        tbl = tbl.contiguous()
        ref = torch.index_select(tbl, 1, idx)
        out = tc.take_columns(tbl, idx)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise RuntimeError(f"take_columns_step {numbering} "
                               f"{(Kt, N, R)}: differs from index_select")
        k4 = lambda: tc.take_columns(tbl, idx)
        lib = lambda: torch.index_select(tbl, 1, idx)
        ms, lib_ms = [], []
        for fn, ts in ((k4, ms), (lib, lib_ms), (lib, lib_ms), (k4, ms)):
            ts.append(cuda_ms(fn))
        ms, lib_ms = sum(ms) / 2, sum(lib_ms) / 2
        nb = nbytes(tbl, ref) + R * 4
        b_ms, b_by = bound(nb, 0, str(tbl.dtype).replace("torch.", ""))
        rows.append(dict(
            numbering=numbering, Kt=Kt, N=N, R=R,
            index=names.get((ptr, stride), "other"), idx_stride=stride,
            calls_per_step=hit["calls"], gain=tc.index_gain(tbl, idx),
            form="rows" if tc.uses_row_form(tbl, idx) else "direct",
            exact=True, ms=ms, library_ms=lib_ms, ms_over_library=ms / lib_ms,
            bytes=nb, bound_ms=b_ms, bound_by=b_by,
            gate="open" if ms < lib_ms else "shut"))
    return rows


def emit_take_columns_step(gathers, names, numbering, torch):
    rows = check_take_columns_step(gathers, names, numbering, torch)
    for row in rows:
        emit({"phase": "take_columns_step", **row})
    if any(r["form"] != "direct" for r in rows):
        raise RuntimeError(f"take_columns_step {numbering}: an index vector "
                           "of the step left the direct form")
    calls = sum(r["calls_per_step"] for r in rows)
    emit({"phase": "take_columns_step_sum", "numbering": numbering,
          "gathers_per_step": calls, "distinct": len(rows),
          "kernel4_ms_per_step": sum(r["ms"] * r["calls_per_step"]
                                     for r in rows),
          "index_select_ms_per_step": sum(r["library_ms"] * r["calls_per_step"]
                                          for r in rows),
          "open": sum(r["gate"] == "open" for r in rows),
          "shut": sum(r["gate"] == "shut" for r in rows)})
    return rows


def emit_take_forms(mesh, torch):
    """Both forms of Kernel 4 and `index_select` in turns on the probe's
    table: at its random indices (float32, and the table widened to
    float64), and at cellsOnEdge[:, 0] of the full-width mesh with a share
    of random entries: the measurements that
    `take_columns.ROW_FORM_MIN_GAIN` rests on. Returns {case: row}."""
    import numpy as np
    from mpas_tpu_torch import probes
    inp = probes.gather_probe_inputs()
    tbl = torch.from_numpy(inp["tbl"]).cuda()
    coe0 = torch.from_numpy(np.ascontiguousarray(
        np.asarray(mesh.cellsOnEdge)[:, 0], np.int32)).cuda()
    cases = {"random": torch.from_numpy(inp["idx"]).cuda()}
    for f in TAKE_MIXED_FRACTIONS:
        cases[f"cellsOnEdge0_random_fraction_{f}"] = (
            probes.mixed_index_table(coe0, f, tbl.shape[1]) if f else coe0)
    rows = {}
    for what, idx in list(cases.items()) + [("random_float64",
                                             cases["random"])]:
        res = probes.take_forms(
            tbl.double() if what == "random_float64" else tbl, idx)
        emit({"phase": "take_forms", "case": what,
              "shape": [tbl.shape[0], tbl.shape[1], idx.shape[0]], **res})
        if not (res["direct_exact"] and res["rows_exact"]):
            raise RuntimeError(f"take_forms {what}: a form of Kernel 4 "
                               "differs from index_select")
        rows[what] = res
    return rows


def check_gather_reduce(calls, torch):
    """One row per call shape: the form `gather_reduce` picks and both forms
    by name against the plain version, float32 and float64, and the times."""
    from mpas_tpu_torch.ops import gather_reduce as gr
    from mpas_tpu_torch.probes import (csr_same_layout, csr_weights, cuda_ms,
                                       roundoff_ratio)
    forms = {"picked": gr.gather_reduce, "direct": gr.gather_reduce_direct,
             "rows": gr.gather_reduce_rows}
    rows = []
    for (Kt, N, R, M, S), hit in calls.items():
        tbl, idx, w = hit["args"]
        ratios = {}
        for name, (t, ww) in (("f32", (tbl, w)),
                              ("f64", (tbl.double(), w.double()))):
            out_p = gr.gather_reduce_plain(t, idx, ww)
            mag = gr.gather_reduce_plain(t.abs(), idx, ww.abs())
            for form, fn in forms.items():
                out_k = fn(t, idx, ww)
                torch.cuda.synchronize()
                ratios[f"{form}_{name}"] = roundoff_ratio(out_k, out_p, mag, M)
                if (not bool(torch.isfinite(out_k).all())
                        or not ratios[f"{form}_{name}"] <= 1.0):
                    raise RuntimeError(
                        f"gather_reduce {(Kt, N, R, M, S)} {form} {name}: "
                        "error over its round-off bound")
        out_p = gr.gather_reduce_plain(tbl, idx, w)
        err = float((gr.gather_reduce(tbl, idx, w) - out_p).abs().max())
        # the same function as one PyTorch call: a CSR sparse product of the
        # [S*R, N] weight matrix with the table's transpose
        W = csr_weights(idx, w, N)
        tblT = tbl.t().contiguous()
        lib_out = csr_same_layout(W, tbl, S, R)
        lib_err = float((lib_out - out_p).abs().max()
                        / out_p.abs().max().clamp_min(1e-30))
        nb = nbytes(tbl, w, out_p) + R * M * 4
        b_ms, b_by = bound(nb, 2 * S * Kt * R * M, "float32")
        sectors = gr.index_scatter(idx, tbl.element_size())
        k2 = lambda: gr.gather_reduce(tbl, idx, w)
        rows.append(dict(
            Kt=Kt, N=N, R=R, M=M, S=S, calls_per_step=hit["calls"],
            idx_row_stride=idx.stride(0), sectors=sectors,
            gain=gr.row_form_gain(sectors, tbl.element_size(), N, R, M),
            form="rows" if gr.uses_row_form(tbl, idx) else "direct",
            max_abs_err=err, max_err_over_bound=max(ratios.values()),
            err_over_bound=ratios,
            max_abs_out=float(out_p.abs().max()), library_max_rel_err=lib_err,
            ms=cuda_ms(k2), ms_cold_l2=cuda_ms(k2, cold_l2=True),
            ms_after_idle=cuda_ms(k2, after_idle=True),
            plain_ms=cuda_ms(lambda: gr.gather_reduce_plain(tbl, idx, w)),
            library_ms=cuda_ms(lambda: torch.sparse.mm(W, tblT)),
            library_same_layout_ms=cuda_ms(
                lambda: csr_same_layout(W, tbl, S, R)),
            bytes=nb, bound_ms=b_ms, bound_by=b_by))
    return rows


MIXED_FRACTIONS = (0.2, 0.3)   # random entries mixed into edgesOnEdge


def emit_gather_forms(calls, numbering):
    """Both forms of Kernel 2 in turns on the step's edgesOnEdge reduction
    (the widest table of the step: M = 10 slots, 2 x 41 levels), on the
    call whose index table has the largest `row_form_gain`, and, on the
    default numbering, on edgesOnEdge with a share of random entries: the
    measurements that `gather_reduce.ROW_FORM_MIN_GAIN` rests on. Returns
    the edgesOnEdge row."""
    from mpas_tpu_torch.ops import gather_reduce as gr
    from mpas_tpu_torch.probes import gather_forms, mixed_index_table

    def gain(key):
        tbl, idx, _ = calls[key]["args"]
        size = tbl.element_size()
        return gr.row_form_gain(gr.index_scatter(idx, size), size,
                                tbl.shape[1], *idx.shape)

    widest = max(calls, key=lambda k: k[0] * k[2] * k[3])
    scattered = max(calls, key=gain)
    cases = [("widest", widest, calls[widest]["args"]),
             ("largest_gain", scattered, calls[scattered]["args"])]
    if numbering == "default":
        tbl, idx, w = calls[widest]["args"]
        cases += [(f"random_fraction_{f}", widest,
                   (tbl, mixed_index_table(idx, f, tbl.shape[1]), w))
                  for f in MIXED_FRACTIONS]
    rows = {}
    for what, key, args in cases:
        res = gather_forms(*args)
        for form in ("direct", "rows"):
            if not res[f"{form}_err_over_bound"] <= 1.0:
                raise RuntimeError(f"gather_forms {numbering} {what} {form}: "
                                   "error over its round-off bound")
        emit({"phase": "gather_forms", "numbering": numbering, "case": what,
              "shape": list(key), **res})
        rows[what] = res
    return rows["widest"]


def check_summary(summ, what):
    """No NaN and sane extrema after a full-width run."""
    if summ["nan_detected"] or not all(map(lambda v: v == v, summ.values())):
        raise RuntimeError(f"{what}: NaN in the full-width run: {summ}")
    if not (abs(summ["u_min"]) < 100 and abs(summ["u_max"]) < 100
            and abs(summ["w_min"]) < 5 and abs(summ["w_max"]) < 5
            and 150 < summ["theta_min"] and summ["theta_max"] < 2000):
        raise RuntimeError(f"{what}: extrema out of range: {summ}")


def counted_steps(model, torch, steps=MAIN_STEPS, k2_more_than=0):
    """`steps` steps with the launch counters of Kernels 1 and 2 set to 0
    first: the step times, the host CPU time the process spent per step
    (more host work moves it, a busy host's other tenants do not), the
    launches, the peak memory and the summary. Fails if either kernel never
    launched, or Kernel 2 no more than `k2_more_than` times a step."""
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    from mpas_tpu_torch.probes import step_ms
    acoustic_column.launches = gather_reduce.launches = 0
    gather_reduce.row_form_launches = 0
    torch.cuda.reset_peak_memory_stats()
    cpu0 = time.process_time()
    times = step_ms(model, steps)
    cpu_ms = (time.process_time() - cpu0) * 1e3 / steps
    launches = {"acoustic_column": acoustic_column.launches,
                "gather_reduce": gather_reduce.launches}
    if any(v <= 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")
    if not launches["gather_reduce"] > k2_more_than * steps:
        raise RuntimeError(f"gather_reduce launched {launches} times in "
                           f"{steps} steps, no more than {k2_more_than} a step")
    return dict(steps=steps, ms_per_step_median=statistics.median(times),
                ms_per_step=times, host_cpu_ms_per_step=cpu_ms,
                launches=launches,
                gather_reduce_row_form_launches=gather_reduce.row_form_launches,
                gather_sectors=model.mesh_arrays.gather_sectors,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                summary=model.summarize())


def agreement(nl, mesh, what, torch):
    """2 float64 steps on the card and on the CPU: max relative difference
    per field (scalars and rainnc too, where the run has them), which must
    stay within AGREE_REL."""
    from mpas_tpu_torch.dynamics.model import build_model
    gpu = build_model(nl, mesh, device="cuda")
    cpu = build_model(nl, mesh, device="cpu")
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    acoustic_column.launches = gather_reduce.launches = 0
    gpu.step(2)
    cpu.step(2)
    launches = {"acoustic_column": acoustic_column.launches,
                "gather_reduce": gather_reduce.launches}
    agree = {}
    fields = ["u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p"]
    if cpu.state.scalars is not None:
        fields.append("scalars")
    if cpu.state.rainnc is not None:
        fields.append("rainnc")
    for n in fields:
        a = getattr(gpu.state, n).cpu()
        b = getattr(cpu.state, n)
        agree[n] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
    nl = gpu.namelist
    emit({"phase": what, "cells": mesh.nCells, "edges": gpu.mesh.nEdges,
          "levels": nl.config_nvertlevels, "dtype": nl.dtype, "steps": 2,
          "init_case": nl.config_init_case,
          "orient_edges": nl.config_orient_edges,
          "renumber_mesh": nl.config_renumber_mesh,
          "cell_form_ops": nl.config_cell_form_ops,
          "microphysics": nl.config_microphysics, "pbl": nl.config_pbl,
          "nfall": nl.config_kessler_nfall, "launches": launches,
          "summary_card": gpu.summarize(),
          "max_rel_err": agree, "limit_rel": AGREE_REL})
    bad = {k: v for k, v in agree.items() if not v <= AGREE_REL}
    if bad:
        raise RuntimeError(f"{what}: card and CPU disagree: {bad}")


def rel_err(a, b, torch):
    """max |a - b| / max |b| of two tensors or arrays (host copies)."""
    a = torch.as_tensor(a).cpu().double()
    b = torch.as_tensor(b).cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def radiation_call(model, phys, torch):
    """Model.apply_physics at full width: a warm-up call, one call timed
    with CUDA events and on the host clock (the call ends by copying its
    diagnostics to the host, so both span the device's work), with its peak
    memory over what the model held, and one traced call: device launches
    (kernels, and copies apart), kernel device time, busy share. Then the
    diagnostics of the timed call."""
    call = lambda: model.apply_physics(phys, julian=RADIATION_JULIAN)
    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    pd = call()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    event_ms = start.elapsed_time(end)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    events, traced_us = trace(call, torch)
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    rt = pd["rthraten"] * 86400.0
    out = dict(
        julian=RADIATION_JULIAN, wall_ms=wall_ms, event_ms=event_ms,
        launches=len(kernels), copies=len(copies),
        kernel_device_ms=sum(e.time_range.end - e.time_range.start
                             for e in kernels) / 1e3,
        traced_wall_ms=traced_us / 1e3,
        device_busy_share=busy_us(events) / traced_us,
        peak_mem_over_model_gb=peak_gb,
        rthraten_k_per_day=[float(rt.min()), float(rt.max())],
        qrs_max_k_per_day=float(pd["qrs"].max() * 86400.0),
        qrl_min_k_per_day=float(pd["qrl"].min() * 86400.0),
        olr_mean=float(pd["olr"].mean()), cldfra_max=float(pd["cldfra"].max()),
        daylit_share=float((pd["solin"] > 0).mean()))
    if not all(bool((v == v).all()) for v in pd.values()):
        raise RuntimeError(f"radiation: NaN in the diagnostics: {out}")
    if not (0.0 < abs(rt).max() < 200.0 and 150.0 < out["olr_mean"] < 350.0
            and 0.0 <= out["cldfra_max"] <= 1.0):
        raise RuntimeError(f"radiation: diagnostics out of range: {out}")
    return out


def agreement_radiation(nl, mesh, torch):
    """One radiation call and 2 float64 steps on the card and on the CPU
    from the same state, JW with condensate seeded across the freezing level
    (probes.seeded_condensate on the CPU model, its scalars copied to the
    card): rt_diabatic_tend, every diagnostic of the call and every state
    field after the steps within AGREE_REL."""
    from mpas_tpu_torch.dynamics.model import build_model
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    from mpas_tpu_torch.physics.driver import physics_init
    from mpas_tpu_torch.probes import seeded_condensate
    import dataclasses
    cpu = build_model(nl, mesh, device="cpu")
    gpu = build_model(nl, mesh, device="cuda")
    cpu.state = seeded_condensate(cpu.state, seed=0)
    gpu.state = gpu.state.replace(scalars=cpu.state.scalars.cuda())
    phys = physics_init()
    d_gpu = gpu.apply_physics(phys, julian=RADIATION_JULIAN)
    d_cpu = cpu.apply_physics(phys, julian=RADIATION_JULIAN)
    agree = {f"radiation.{k}": rel_err(d_gpu[k], d_cpu[k], torch)
             for k in d_cpu}
    agree["rt_diabatic_tend"] = rel_err(gpu.state.rt_diabatic_tend,
                                        cpu.state.rt_diabatic_tend, torch)
    acoustic_column.launches = gather_reduce.launches = 0
    gpu.step(2)
    cpu.step(2)
    launches = {"acoustic_column": acoustic_column.launches,
                "gather_reduce": gather_reduce.launches}
    for f in dataclasses.fields(cpu.state):
        b = getattr(cpu.state, f.name)
        if b is not None:
            agree[f.name] = rel_err(getattr(gpu.state, f.name), b, torch)
    emit({"phase": "agreement_radiation", "cells": mesh.nCells,
          "levels": nl.config_nvertlevels, "dtype": nl.dtype, "steps": 2,
          "microphysics": nl.config_microphysics, "pbl": nl.config_pbl,
          "launches": launches, "cldfra_max": float(d_cpu["cldfra"].max()),
          "condensate_max": float(cpu.state.scalars[1:].max()),
          "summary_card": gpu.summarize(), "max_rel_err": agree,
          "worst": max(agree.values()), "limit_rel": AGREE_REL})
    bad = {k: v for k, v in agree.items() if not v <= AGREE_REL}
    if bad:
        raise RuntimeError(f"agreement_radiation: card and CPU disagree: {bad}")
    if launches["acoustic_column"] <= 0 or launches["gather_reduce"] <= 0:
        raise RuntimeError(f"agreement_radiation: a kernel never launched: "
                           f"{launches}")


def turns(a, b, pairs):
    """Median ms of a.step(1) and of b.step(1), timed in turns (a b, b a,
    ...), with the launches of Kernels 1 and 2 a step of each."""
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    from mpas_tpu_torch.probes import step_ms
    ms = {id(a): [], id(b): []}
    launches = {id(a): 0, id(b): 0}
    for i in range(pairs):
        for m in ((a, b) if i % 2 == 0 else (b, a)):
            acoustic_column.launches = gather_reduce.launches = 0
            ms[id(m)] += step_ms(m, 1)
            launches[id(m)] += acoustic_column.launches + gather_reduce.launches
    return ([statistics.median(ms[id(m)]) for m in (a, b)],
            [launches[id(m)] / pairs for m in (a, b)])


def exchange_kernel4(sm, torch):
    """Kernel 4 on the stacked exchange's own source vectors, at the packed
    blocks of refresh_state (8 cell fields, 2 edge fields): bit-equal to
    its plain version, its time beside the bound, the plain version's and
    `index_select`'s."""
    from mpas_tpu_torch.ops import take_columns as tc
    from mpas_tpu_torch.probes import cuda_ms
    s = sm.state
    packs = {"cell": torch.cat([s.w, s.theta_m, s.rho_zz, s.rho_p,
                                s.rtheta_p, s.exner, s.pressure_p, s.rw]),
             "edge": torch.cat([s.u, s.ru])}
    rows = {}
    for ent, tbl in packs.items():
        src = getattr(sm.tables, ent).source
        out_k = tc.take_columns(tbl, src)
        out_p = tc.take_columns_plain(tbl, src)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):
            raise RuntimeError(f"sharded: Kernel 4 differs from its plain "
                               f"version on the {ent} exchange")
        nb = nbytes(tbl, out_p) + src.numel() * 4
        b_ms, b_by = bound(nb, 0, "float32")
        rows[ent] = dict(
            shape=[tbl.shape[0], tbl.shape[1], src.shape[0]], bit_equal=True,
            form="rows" if tc.uses_row_form(tbl, src) else "direct",
            halo_slots=getattr(sm.tables, ent).n_halo,
            ms=cuda_ms(lambda: tc.take_columns(tbl, src)),
            plain_ms=cuda_ms(lambda: tc.take_columns_plain(tbl, src)),
            library_ms=cuda_ms(lambda: torch.index_select(tbl, 1, src)),
            bytes=nb, bound_ms=b_ms, bound_by=b_by)
    return rows


def sharded_run(model, torch):
    """The stacked back end on the card: shard_model(model, SHARDS), Kernel
    4 on the exchange's vectors, SHARDED_STEPS counted steps (launches of
    Kernels 1, 2 and 4, exchanges, halo bytes), then steps timed in turns
    with the single-device model, a traced window, and summarize against
    its host oracle."""
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    from mpas_tpu_torch.ops import take_columns as tc
    from mpas_tpu_torch.parallel import halo, partition
    from mpas_tpu_torch.parallel.sharded import (host_summarize_oracle,
                                                 shard_model,
                                                 sharded_summarize)
    from mpas_tpu_torch.probes import step_ms
    t0 = time.perf_counter()
    sm = shard_model(model, SHARDS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p, nl = sm.partition, sm.namelist
    k4 = exchange_kernel4(sm, torch)
    acoustic_column.launches = gather_reduce.launches = tc.launches = 0
    halo.exchanges = halo.halo_bytes = 0
    torch.cuda.reset_peak_memory_stats()
    times = step_ms(sm, SHARDED_STEPS)
    launches = {"acoustic_column": acoustic_column.launches,
                "gather_reduce": gather_reduce.launches,
                "take_columns": tc.launches}
    exchanges, halo_bytes = halo.exchanges, halo.halo_bytes
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(v <= 0 for v in launches.values()):
        raise RuntimeError(f"sharded: a kernel never launched: {launches}")
    (single_ms, sharded_ms), (single_l, sharded_l) = turns(model, sm,
                                                           TURN_PAIRS)
    prof = profile_steps(sm, PROFILE_STEPS, torch)
    summ, oracle = sharded_summarize(sm), host_summarize_oracle(sm)
    check_summary(summ, "sharded")
    diff = {k: abs(summ[k] - oracle[k]) / max(abs(oracle[k]), 1e-30)
            for k in summ if k != "nan_detected"}
    if (summ["nan_detected"] != oracle["nan_detected"]
            or max(diff.values()) > SUMMARY_REL):
        raise RuntimeError(f"sharded: summarize {summ} != oracle {oracle}")
    acc = partition.exchange_bytes_per_step(p, nl, nl.config_nvertlevels,
                                            bytes_per_value=4)
    sizes = {"cell": model.mesh.nCells, "edge": model.mesh.nEdges,
             "vertex": model.mesh.nVertices}
    return dict(
        shards=SHARDS, mode=nl.config_halo_exchange, setup_s=setup_s,
        local={e: [int(getattr(p, f"{e}_l2g").shape[1]),
                   int((getattr(p, f"{e}_owned_mask") > 0).sum(1).max())]
               for e in sizes},
        halo_overhead_SL_over_N={
            e: SHARDS * getattr(p, f"{e}_l2g").shape[1] / n
            for e, n in sizes.items()},
        rounds={"cell": len(p.cell_x.rounds), "edge": len(p.edge_x.rounds)},
        steps=SHARDED_STEPS, ms_per_step=times,
        ms_per_step_median=statistics.median(times), peak_mem_gb=peak,
        launches=launches,
        launches_per_step={k: v / SHARDED_STEPS for k, v in launches.items()},
        exchanges_per_step=exchanges / SHARDED_STEPS,
        halo_bytes_per_step=halo_bytes / SHARDED_STEPS,
        exchange_bytes_per_step_estimate=acc["total_bytes_per_step"],
        exchange_accounting=acc, kernel4_exchange=k4,
        turns={"pairs": TURN_PAIRS, "single_ms_per_step_median": single_ms,
               "sharded_ms_per_step_median": sharded_ms,
               "sharded_over_single": sharded_ms / single_ms,
               "k1_k2_launches_per_step": {"single": single_l,
                                           "sharded": sharded_l}},
        profile=prof, summary=summ, oracle_max_rel_diff=max(diff.values()))


def regional_run(mesh, nl, torch):
    """A regional run at full width: the mesh marked with the NH cap's
    zones (latCell > 0.15, 5 relaxation rings), a global driving run of
    REGIONAL_STEPS steps with an LBC snapshot every LBC_EVERY, then
    RegionalDriver steps in turns with the global run replayed from the
    same state: ms and launches a step of each, the specified zone against
    the stream at each step's start, the interior against the global run."""
    import copy
    import dataclasses
    import numpy as np
    from mpas_tpu_torch.dynamics import srk3
    from mpas_tpu_torch.dynamics.model import build_model
    from mpas_tpu_torch.io import lbc
    from mpas_tpu_torch.mesh.coefficients import mark_regional_zones
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    from mpas_tpu_torch.probes import step_ms
    rmesh = mark_regional_zones(copy.copy(mesh), mesh.latCell > 0.15,
                                n_relax=5)
    t0 = time.perf_counter()
    glob = build_model(nl, rmesh, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    s0, dt = glob.state, nl.config_dt
    cells, edges = lbc.zone_indices(rmesh)
    times, snaps = [0.0], [lbc.extract_lbc(s0, cells, edges)]
    t0 = time.perf_counter()
    for i in range(REGIONAL_STEPS):
        glob.step(1)
        if (i + 1) % LBC_EVERY == 0:
            times.append((i + 1) * dt)
            snaps.append(lbc.extract_lbc(glob.state, cells, edges))
    driving_s = time.perf_counter() - t0
    stream = lbc.build_stream(times, cells, edges, snaps)
    final = glob.state
    nl_r = nl.replace(config_apply_lbcs=True)
    reg = dataclasses.replace(
        glob, namelist=nl_r, state=s0, step_count=0,
        step_fn=srk3.make_step_fn(glob.static, glob.mesh_arrays, glob.vert,
                                  nl_r))
    glob.state, glob.step_count = s0, 0
    drv = lbc.RegionalDriver(reg, stream)
    spec_c = rmesh.bdyMaskCell > nl.nRelaxZone
    spec_e = rmesh.bdyMaskEdge > nl.nRelaxZone
    zc = torch.from_numpy(np.searchsorted(stream.cells,
                                          np.where(spec_c)[0])).cuda()
    ze = torch.from_numpy(np.searchsorted(stream.edges,
                                          np.where(spec_e)[0])).cuda()
    sc = torch.from_numpy(np.where(spec_c)[0]).cuda()
    se = torch.from_numpy(np.where(spec_e)[0]).cuda()
    ms = {"regional": [], "global": []}
    launches = {k: {"acoustic_column": 0, "gather_reduce": 0} for k in ms}
    zone_err = 0.0
    for i in range(REGIONAL_STEPS):
        for name in (("regional", "global") if i % 2 == 0
                     else ("global", "regional")):
            m = drv if name == "regional" else glob
            f = lbc.interp_fields(stream, reg.step_count * dt, reg.dtype,
                                  reg.device)
            acoustic_column.launches = gather_reduce.launches = 0
            ms[name] += step_ms(m, 1)
            launches[name]["acoustic_column"] += acoustic_column.launches
            launches[name]["gather_reduce"] += gather_reduce.launches
            if name == "regional":
                for n, col, idx in (("theta_m", zc, sc), ("rho_zz", zc, sc),
                                    ("u", ze, se)):
                    ref = f[n].index_select(1, col)
                    got = getattr(reg.state, n).index_select(1, idx)
                    zone_err = max(zone_err, rel_err(got, ref, torch))
    if not zone_err <= ZONE_REL:
        raise RuntimeError(f"regional: the specified zone left the stream "
                           f"({zone_err} > {ZONE_REL})")
    int_c = torch.from_numpy(rmesh.bdyMaskCell == 0).cuda()
    int_e = torch.from_numpy(rmesh.bdyMaskEdge == 0).cuda()
    du = float((reg.state.u - final.u)[:, int_e].abs().max())
    dth = float((reg.state.theta_m - final.theta_m)[:, int_c].abs().max())
    summ = reg.summarize()
    check_summary(summ, "regional")
    if not (du < REGIONAL_BOUND and dth < REGIONAL_BOUND):
        raise RuntimeError(f"regional: interior off the global run: |du| "
                           f"{du}, |dtheta_m| {dth}")
    prof = {"regional": profile_steps(drv, 2, torch),
            "global": profile_steps(glob, 2, torch)}
    return dict(
        cells=rmesh.nCells, zone_cells=len(cells), zone_edges=len(edges),
        specified_cells=int(spec_c.sum()), interior_cells=int((rmesh.bdyMaskCell == 0).sum()),
        levels=nl.config_nvertlevels, dtype=nl.dtype, dt=dt,
        steps=REGIONAL_STEPS, lbc_every=LBC_EVERY, stream_times=len(times),
        setup_s=setup_s, driving_run_s=driving_s,
        ms_per_step_median={k: statistics.median(v) for k, v in ms.items()},
        ms_per_step=ms,
        launches=launches,
        launches_per_step={k: {x: n / REGIONAL_STEPS for x, n in v.items()}
                           for k, v in launches.items()},
        regional_over_global=(statistics.median(ms["regional"])
                              / statistics.median(ms["global"])),
        interior_max_abs_du=du, interior_max_abs_dtheta_m=dth,
        bound=REGIONAL_BOUND, zone_max_rel_err=zone_err, zone_limit=ZONE_REL,
        profile={k: {x: v[x] for x in ("launches_per_step",
                                       "kernel_device_ms_per_step",
                                       "device_busy_share",
                                       "traced_wall_ms")}
                 for k, v in prof.items()},
        summary=summ)


def agreement_regional(nl, mesh, torch):
    """A regional run at x1.2562, float64, driven by a stream from 2 CPU
    global steps: 2 RegionalDriver steps on the card and on the CPU, every
    prognostic within AGREE_REL."""
    import copy
    from mpas_tpu_torch.dynamics.model import build_model
    from mpas_tpu_torch.io import lbc
    from mpas_tpu_torch.mesh.coefficients import mark_regional_zones
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    rmesh = mark_regional_zones(copy.copy(mesh), mesh.latCell > 0.15,
                                n_relax=5)
    drive = build_model(nl, rmesh, device="cpu")
    cells, edges = lbc.zone_indices(rmesh)
    snaps = [lbc.extract_lbc(drive.state, cells, edges)]
    drive.step(2)
    snaps.append(lbc.extract_lbc(drive.state, cells, edges))
    stream = lbc.build_stream([0.0, 2 * nl.config_dt], cells, edges, snaps)
    nl_r = nl.replace(config_apply_lbcs=True)
    states = {}
    for dev in ("cuda", "cpu"):
        m = build_model(nl_r, rmesh, device=dev)
        acoustic_column.launches = gather_reduce.launches = 0
        lbc.RegionalDriver(m, stream).step(2)
        if dev == "cuda":
            launches = {"acoustic_column": acoustic_column.launches,
                        "gather_reduce": gather_reduce.launches}
        states[dev] = m.state
    names = ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p", "ru", "rw",
             "exner", "pressure_p")
    agree = {n: rel_err(getattr(states["cuda"], n), getattr(states["cpu"], n),
                        torch) for n in names}
    emit({"phase": "agreement_regional", "cells": rmesh.nCells,
          "zone_cells": len(cells), "levels": nl.config_nvertlevels,
          "dtype": nl.dtype, "steps": 2, "launches": launches,
          "max_rel_err": agree, "limit_rel": AGREE_REL})
    bad = {k: v for k, v in agree.items() if not v <= AGREE_REL}
    if bad or min(launches.values()) <= 0:
        raise RuntimeError(f"agreement_regional: card and CPU disagree: {bad}"
                           f" (launches {launches})")


def agreement_sharded(nl, mesh, torch):
    """The stacked back end at x1.2562, float64, SHARDS shards, 2 steps on
    the card and on the CPU (owned entries), and on the card against the
    single-device step on the card: every prognostic within AGREE_REL."""
    from mpas_tpu_torch.dynamics.model import build_model
    from mpas_tpu_torch.ops import take_columns as tc
    from mpas_tpu_torch.parallel import halo
    from mpas_tpu_torch.parallel.sharded import shard_model
    single = build_model(nl, mesh, device="cuda")
    gpu = shard_model(single, SHARDS)
    cpu = shard_model(build_model(nl, mesh, device="cpu"), SHARDS)
    tc.launches = halo.exchanges = 0
    gpu.step(2)
    launches, exchanges = tc.launches, halo.exchanges
    cpu.step(2)
    single.step(2)
    g, c = gpu.gather_state(mesh), cpu.gather_state(mesh)
    names = ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p", "ru", "rw",
             "exner", "pressure_p")
    agree = {n: rel_err(g[n], c[n], torch) for n in names}
    vs_single = {n: rel_err(g[n], getattr(single.state, n), torch)
                 for n in names}
    emit({"phase": "agreement_sharded", "cells": mesh.nCells,
          "shards": SHARDS, "levels": nl.config_nvertlevels,
          "dtype": nl.dtype, "steps": 2, "take_columns_launches": launches,
          "exchanges": exchanges, "max_rel_err": agree,
          "max_rel_err_vs_single_device": vs_single, "limit_rel": AGREE_REL})
    bad = {k: v for k, v in list(agree.items()) + [
        (f"single.{k}", v) for k, v in vs_single.items()]
        if not v <= AGREE_REL}
    if bad or launches <= 0:
        raise RuntimeError(f"agreement_sharded: disagree: {bad} (Kernel 4 "
                           f"launches {launches})")


def cli_runs(torch):
    """`python -m mpas_tpu_torch`'s main, in this process, on the card, in a
    temporary directory that also holds $HOME (where the CLI caches its
    generated meshes) for the duration: the full-width moist run with
    radiation, history and checkpoints, then the restart leg. Returns the
    phase's line; raises on a non-zero exit or a failed check."""
    import contextlib
    import io
    import re
    import tempfile
    import numpy as np
    from mpas_tpu_torch import __main__ as cli
    from mpas_tpu_torch.mesh.netcdf_io import read_netcdf
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    home = os.environ.get("HOME")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HOME"] = tmp
        try:
            cfg = os.path.join(tmp, "moist.json")
            with open(cfg, "w") as f:
                json.dump(CLI_NAMELIST, f)
            path = lambda name: os.path.join(tmp, name)

            def run(*flags):
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main([*flags, "--config", cfg, "--device", "cuda"])
                log = buf.getvalue()
                if rc != 0 or "NaN" in log:
                    raise RuntimeError(f"cli {flags}: exit {rc}\n{log}")
                return log, time.perf_counter() - t0

            acoustic_column.launches = gather_reduce.launches = 0
            log, seconds = run(
                "--grid", "generate:6", "--levels", "41", "--dt", "300",
                "--dtype", "float32", "--physics", "--radt-steps",
                str(RADT_STEPS), "--steps", str(CLI_STEPS),
                "--history-every", "5", "--checkpoint-every", "5",
                "--output", path("hist.nc"), "--checkpoint-path",
                path("ck.npz"))
            launches = {"acoustic_column": acoustic_column.launches,
                        "gather_reduce": gather_reduce.launches}
            if any(v <= 0 for v in launches.values()):
                raise RuntimeError(f"cli: a kernel never launched: {launches}")
            timing = re.search(r"(\d+) steps in ([\d.]+)s \(([\d.]+) ms/step",
                               log)
            parts = {k: float(v) for k, v in re.findall(
                r"(radiation|history|checkpoints) ([\d.]+)s", log)}
            hist = read_netcdf(path("hist.nc"))
            if hist["_dims"]["Time"] != 2 or not all(
                    bool((v == v).all()) for k, v in hist.items()
                    if k != "_dims"):
                raise RuntimeError(f"cli: history has {hist['_dims']} or NaN")
            full = dict(
                cells=hist["_dims"]["nCells"], levels=41, dtype="float32",
                steps=CLI_STEPS, radt_steps=RADT_STEPS,
                ms_per_step_logged=float(timing.group(3)),
                loop_seconds_logged=float(timing.group(2)),
                loop_parts_seconds_logged=parts,
                ms_per_step_without_parts=(float(timing.group(2))
                                           - sum(parts.values()))
                * 1e3 / CLI_STEPS,
                process_seconds=seconds, launches=launches,
                history_bytes=os.path.getsize(path("hist.nc")),
                history_dims=hist["_dims"],
                checkpoint_bytes=os.path.getsize(path("ck.npz")),
                log_tail=log.strip().splitlines()[-6:])

            # the restart leg: 4 straight steps against 2 + restart + 2
            leg = ["--grid", "generate:4", "--levels", "26", "--dtype",
                   "float64", "--physics", "--radt-steps", "2",
                   "--output-full-3d"]
            run(*leg, "--steps", "4", "--output", path("a.nc"),
                "--checkpoint-path", path("a.npz"))
            run(*leg, "--steps", "2", "--checkpoint-every", "2", "--output",
                path("b1.nc"), "--checkpoint-path", path("b.npz"))
            run(*leg, "--steps", "2", "--restart", path("b.npz"), "--output",
                path("b2.nc"), "--checkpoint-path", path("b2.npz"))
            a, b = read_netcdf(path("a.nc")), read_netcdf(path("b2.nc"))
            diff = {k: rel_err(b[k].astype("float64"), a[k].astype("float64"),
                               torch)
                    for k in a if k != "_dims"}
            unequal = sorted(k for k in a if k != "_dims"
                             and not (a[k] == b[k]).all())

            # the sharded leg: the same 4 steps with --shards SHARDS (the
            # stacked back end on the card) against the single-device leg,
            # and 2 + restart + 2 of it, which must be bit-equal
            shard = ["--shards", str(SHARDS)]
            run(*leg, *shard, "--steps", "4", "--output", path("s.nc"),
                "--checkpoint-path", path("s.npz"))
            run(*leg, *shard, "--steps", "2", "--checkpoint-every", "2",
                "--output", path("s1.nc"), "--checkpoint-path", path("sb.npz"))
            run(*leg, *shard, "--steps", "2", "--restart", path("sb.npz"),
                "--output", path("s2.nc"), "--checkpoint-path",
                path("sb2.npz"))
            sh, sh2 = read_netcdf(path("s.nc")), read_netcdf(path("s2.nc"))
            with np.load(path("sb.npz")) as ck:
                ck_shards = int(ck["__n_shards__"])
            vs_single = {k: rel_err(sh[k].astype("float64"),
                                    a[k].astype("float64"), torch)
                         for k in a if k != "_dims"}
            sharded_unequal = sorted(k for k in sh if k != "_dims"
                                     and not (sh[k] == sh2[k]).all())
        finally:
            if home is None:
                del os.environ["HOME"]
            else:
                os.environ["HOME"] = home
    restart = dict(cells=a["_dims"]["nCells"], levels=26, dtype="float64",
                   bit_equal=not unequal, unequal_fields=unequal,
                   max_rel_diff=max(diff.values()), limit_rel=AGREE_REL)
    if unequal and not restart["max_rel_diff"] <= AGREE_REL:
        raise RuntimeError(f"cli restart leg: resumed run differs: {diff}")
    sharded = dict(shards=SHARDS, cells=sh["_dims"]["nCells"], levels=26,
                   dtype="float64", checkpoint_shards=ck_shards,
                   max_rel_diff_vs_single_device=max(vs_single.values()),
                   limit_rel=AGREE_REL, restart_bit_equal=not sharded_unequal,
                   restart_unequal_fields=sharded_unequal)
    if (sharded_unequal or ck_shards != SHARDS
            or not sharded["max_rel_diff_vs_single_device"] <= AGREE_REL):
        raise RuntimeError(f"cli sharded leg: {sharded}")
    return {"full_width": full, "restart": restart, "sharded": sharded}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpas_tpu_torch import cuda_build, probes
    from mpas_tpu_torch.config import Namelist
    from mpas_tpu_torch.dynamics.model import build_model
    from mpas_tpu_torch.mesh.generator import generate_mesh
    from mpas_tpu_torch.mesh.renumber import renumber_mesh
    from mpas_tpu_torch.ops import take_columns, windowed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "nvidia-smi", "card": smi, "device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path),
          "ptxas_kernel_registers_smem_spill": {
              obj: [[r["kernel"], r["registers"], r["smem_bytes"],
                     r["spill_bytes"]] for r in rows]
              for obj, rows in cuda_build.ptxas_report().items()}})

    # full-width model: x1.40962, 41 levels, float32, dt=300 s
    t0 = time.perf_counter()
    nl = Namelist(config_nvertlevels=41, config_dt=300.0, dtype="float32",
                  config_jw_u_perturbation=1.0)
    mesh = generate_mesh(levels=6)
    setup = {"generate_mesh": time.perf_counter() - t0}
    model = build_model(nl, mesh, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup.update(model.setup_seconds)
    k1_args, k2_calls, gathers = record_step(model)
    torch.cuda.synchronize()

    # 3. Kernel 1
    k1 = timed(lambda: check_acoustic(k1_args, torch))
    emit({"phase": "acoustic_column", **k1})
    emit({"phase": "acoustic_column_shapes", **check_acoustic_shapes(torch)})

    # 4. Kernel 2
    k2 = check_gather_reduce(k2_calls, torch)
    for row in k2:
        emit({"phase": "gather_reduce", **row})
    forms = {"default": emit_gather_forms(k2_calls, "default")}
    take_step = emit_take_columns_step(
        gathers, index_vector_names(model.mesh_arrays), "default", torch)

    # 5. the main path: 10 full-width steps, counted
    main = timed(lambda: counted_steps(model, torch))
    launches = main["launches"]
    emit({"phase": "main_path", "cells": model.mesh.nCells,
          "edges": model.mesh.nEdges, "levels": 41, "dtype": "float32",
          "dt": 300.0, "setup_s": setup_s, "setup_s_by_stage": setup, **main})
    check_summary(main["summary"], "main_path")

    # 6. where the time of a full-width step goes
    emit({"phase": "profile",
          **timed(lambda: profile_steps(model, PROFILE_STEPS, torch))})
    shapes_seen = set(k2_calls)
    del k1_args, k2_calls, gathers

    # 6b. the stacked domain decomposition on the card, from this model
    sharded = timed(lambda: sharded_run(model, torch))
    emit({"phase": "sharded", "cells": model.mesh.nCells, "levels": 41,
          "dtype": "float32", "dt": 300.0,
          "note": f"{SHARDS} shards side by side on one card: correctness "
                  "and cost of the decomposition, not a scaling figure",
          **sharded})
    del model
    torch.cuda.empty_cache()

    # 6c. a regional run at full width, driven by a global run's LBCs
    regional = timed(lambda: regional_run(mesh, nl, torch))
    emit({"phase": "regional", **regional})
    torch.cuda.empty_cache()

    # 7. the JAX bench's setting: edges aligned to their owner cells
    t0 = time.perf_counter()
    nl_o = nl.replace(config_orient_edges=True)
    model = build_model(nl_o, mesh, device="cuda")
    torch.cuda.synchronize()
    setup_o = time.perf_counter() - t0
    _, calls, gathers = record_step(model)
    new_calls = {k: v for k, v in calls.items() if k not in shapes_seen}
    k2_orient = check_gather_reduce(new_calls, torch)
    for row in k2_orient:
        emit({"phase": "gather_reduce_orient", **row})
    forms["aligned"] = emit_gather_forms(calls, "aligned")
    take_step += emit_take_columns_step(
        gathers, index_vector_names(model.mesh_arrays), "aligned", torch)
    del calls, new_calls, gathers
    orient = timed(lambda: counted_steps(model, torch, ORIENT_STEPS))
    prof = timed(lambda: profile_steps(model, PROFILE_STEPS, torch))
    emit({"phase": "main_path_orient", "cells": model.mesh.nCells,
          "edges": model.mesh.nEdges, "edges_real": model.mesh.nEdgesReal,
          "non_owned_slots": model.mesh_arrays.eoc_split.width - 3,
          "levels": 41, "dtype": "float32", "dt": 300.0, "setup_s": setup_o,
          "setup_s_by_stage": model.setup_seconds, **orient,
          "profile": prof})
    check_summary(orient["summary"], "main_path_orient")
    mesh_aligned = model.mesh
    del model
    torch.cuda.empty_cache()

    # 7b. the moist path at full width: JW + WSM6 + PBL, default numbering
    t0 = time.perf_counter()
    nl_m = nl.replace(config_moisture=True, config_microphysics="wsm6",
                      config_pbl="ysu_lite")
    model = build_model(nl_m, mesh, device="cuda")
    torch.cuda.synchronize()
    setup_m = time.perf_counter() - t0
    _, calls, _ = record_step(model)
    new_calls = {k: v for k, v in calls.items() if k not in shapes_seen}
    k2_moist = check_gather_reduce(new_calls, torch)
    for row in k2_moist:
        emit({"phase": "gather_reduce_moist", **row})
    if not k2_moist:
        raise RuntimeError("gather_reduce_moist: the moist step added no "
                           "call shape of Kernel 2")
    k2_calls_per_step = sum(v["calls"] for v in calls.values())
    del calls, new_calls
    torch.cuda.empty_cache()
    moist = timed(lambda: counted_steps(model, torch,
                                        k2_more_than=DRY_K2_PER_STEP))
    emit({"phase": "main_path_moist", "cells": model.mesh.nCells,
          "edges": model.mesh.nEdges, "levels": 41, "dtype": "float32",
          "dt": 300.0, "microphysics": model.namelist.config_microphysics,
          "pbl": model.namelist.config_pbl,
          "species": int(model.state.scalars.shape[0]),
          "nfall": model.namelist.config_kessler_nfall,
          "gather_reduce_calls_per_step": k2_calls_per_step,
          "setup_s": setup_m, "setup_s_by_stage": model.setup_seconds,
          **moist, "moisture": check_moisture(model.state, "main_path_moist")})
    check_summary(moist["summary"], "main_path_moist")
    prof_m = timed(lambda: profile_steps(model, PROFILE_STEPS, torch))
    emit({"phase": "profile_moist", **prof_m,
          "parts": profile_moist_parts(model, prof_m, torch)})
    check_moisture(model.state, "profile_moist")

    # 7c. radiation on the moist model, and steps with its heating
    from mpas_tpu_torch.physics.driver import physics_init
    rad = timed(lambda: radiation_call(model, physics_init(), torch))
    rad_steps = counted_steps(model, torch, RADIATION_STEPS,
                              k2_more_than=DRY_K2_PER_STEP)
    check_summary(rad_steps["summary"], "radiation")
    rt = model.state.rt_diabatic_tend
    if not (bool(rt.isfinite().all()) and float(rt.abs().max()) > 0.0):
        raise RuntimeError("radiation: rt_diabatic_tend is zero or not "
                           "finite after the steps")
    del rad_steps["gather_sectors"], rad_steps["ms_per_step"]
    emit({"phase": "radiation", "cells": model.mesh.nCells, "levels": 41,
          "dtype": "float32", **rad, "radt_steps": RADT_STEPS,
          "radiation_ms_per_step": rad["wall_ms"] / RADT_STEPS,
          "moist_ms_per_step_median": moist["ms_per_step_median"],
          "steps_after": rad_steps,
          "moisture": check_moisture(model.state, "radiation")})
    del model
    torch.cuda.empty_cache()

    # 8. card against CPU, float64, x1.2562, 2 steps
    nl6 = Namelist(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
                   config_jw_u_perturbation=1.0)
    mesh4 = generate_mesh(levels=4)
    agreement(nl6, mesh4, "agreement", torch)
    agreement(nl6.replace(config_renumber_mesh=True, config_orient_edges=True),
              mesh4, "agreement_orient", torch)
    agreement(nl6.replace(config_moisture=True, config_microphysics="wsm6",
                          config_pbl="ysu_lite"),
              mesh4, "agreement_moist", torch)
    agreement(nl6.replace(config_cell_form_ops=True, config_hollingsworth=True,
                          config_apvm_upwinding=0.5),
              mesh4, "agreement_cellform", torch)
    # the reduced-planet cases: radius / 100 keeps the 642-cell test's
    # ~4.4 km cell spacing on the 2562-cell mesh
    radius = Namelist().config_sphere_radius / 100.0
    small = dict(config_coriolis=False, config_vertical_stretch=1.0,
                 config_sphere_radius=radius, config_nvertlevels=16,
                 config_xnutr=0.3, config_len_disp=4800.0)
    nl_mw = Namelist(config_init_case=21, dtype="float64", config_dt=12.0,
                     config_ztop=16000.0, config_zd=10000.0,
                     config_mtn_h0=250.0, config_mtn_halfwidth=20000.0,
                     config_mtn_wavelength=80000.0, **small)
    nl_sq = Namelist(config_init_case=22, dtype="float64", config_dt=16.0,
                     config_number_of_sub_steps=4, config_ztop=20000.0,
                     config_zd=14000.0, config_moisture=True,
                     config_microphysics="wsm6", config_sq_bubble_dtheta=3.0,
                     **small)
    mesh4s = generate_mesh(levels=4, sphere_radius=radius)
    agreement(nl_mw, mesh4s, "agreement_mountain", torch)
    agreement(nl_sq, mesh4s, "agreement_squall", torch)
    agreement_radiation(nl6.replace(config_moisture=True,
                                    config_microphysics="wsm6",
                                    config_pbl="ysu_lite"), mesh4, torch)
    agreement_regional(nl6, mesh4, torch)
    agreement_sharded(nl6, mesh4, torch)

    # 8b. the squall line on the card, float32: convection must develop
    model = build_model(nl_sq.replace(dtype="float32"), mesh4s, device="cuda")
    squall = timed(lambda: counted_steps(model, torch, SQUALL_STEPS,
                                         k2_more_than=DRY_K2_PER_STEP))
    summ = squall["summary"]
    w_amp = max(abs(summ["w_min"]), abs(summ["w_max"]))
    water = check_moisture(model.state, "squall")
    condensate = float(model.state.scalars[1:].max())
    del squall["gather_sectors"]
    emit({"phase": "squall", "cells": model.mesh.nCells, "levels": 16,
          "dtype": "float32", "dt": 16.0,
          "nfall": model.namelist.config_kessler_nfall, **squall,
          "w_amplitude": w_amp, "condensate_max": condensate,
          "moisture": water})
    if summ["nan_detected"] or not 0.3 < w_amp < 60.0:
        raise RuntimeError(f"squall: no convective updraft (|w| = {w_amp}) "
                           f"or NaN: {summ}")
    if not condensate > 1e-6:
        raise RuntimeError(f"squall: no condensate formed ({condensate})")
    del model
    torch.cuda.empty_cache()

    # 8c. the command line on the card
    cli = timed(lambda: cli_runs(torch))
    emit({"phase": "cli", **cli})
    torch.cuda.empty_cache()

    # 9. the windowed study on the RCM-renumbered x1.40962 mesh
    windowed.launches = 0
    study = timed(lambda: {"rows": probes.windowed_study(
        renumber_mesh(mesh)[0], Kst=(48, 168))})
    k3_launches = windowed.launches
    for row in study["rows"]:
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"],
                                                 "float32")
        emit({"phase": "windowed_study", **row, "launches": k3_launches,
              "smi_before": study["smi_before"],
              "smi_after": study["smi_after"]})
        worst = max(row["err_over_bound"], row["gather_reduce_err_over_bound"],
                    row["err_over_bound_vs_index_select"])
        if worst > 1.0:
            raise RuntimeError(f"windowed_study Kst={row['Kst']}: error over "
                               f"its round-off bound ({worst})")
    if k3_launches <= 0:
        raise RuntimeError("windowed_study never launched Kernel 3")
    # Kernel 3 beside Kernel 2 on the step's own edgesOnEdge reduction
    for numbering, m in (("default", mesh), ("aligned", mesh_aligned)):
        row = probes.reduce_study(
            m.edgesOnEdge, m.weightsOnEdge * m.edgesOnEdge_mask, m.nEdges, 82)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"],
                                                 "float32")
        emit({"phase": "windowed_step_table", "table": "edgesOnEdge",
              "numbering": numbering, **row})
        if max(row["err_over_bound"], row["gather_reduce_err_over_bound"],
               row["err_over_bound_vs_index_select"]) > 1.0:
            raise RuntimeError(f"windowed_step_table {numbering}: error over "
                               "its round-off bound")

    # 10. the gather probe: Kernel 4 (A, B) and Kernel 2 (C)
    take_columns.launches = take_columns.row_form_launches = 0
    probe = timed(probes.gather_probe)
    k4_launches = take_columns.launches
    k4_row_launches = take_columns.row_form_launches
    for key in "ABC":
        row = probe[key]
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"],
                                                 "float32")
        emit({"phase": "gather_probe", "probe": key, **row,
              "smi_before": probe["smi_before"],
              "smi_after": probe["smi_after"]})
    if probe["A"]["max_abs_err"] != 0.0 or probe["B"]["max_abs_err"] != 0.0:
        raise RuntimeError("gather_probe: Kernel 4 differs from index_select")
    forms["probe_c"] = probe["C"]["forms"]
    if max(probe["C"]["err_over_bound"],
           forms["probe_c"]["direct_err_over_bound"],
           forms["probe_c"]["rows_err_over_bound"]) > 1.0:
        raise RuntimeError("gather_probe C: error over its round-off bound")
    if k4_launches <= 0:
        raise RuntimeError("gather_probe never launched Kernel 4")
    del probe["outputs"]
    take_forms = emit_take_forms(mesh, torch)

    big = max(k2, key=lambda r: r["Kt"] * r["R"] * r["M"])
    k3 = max(study["rows"], key=lambda r: r["Kst"])
    a = probe["A"]
    kernels = [
        {"name": "acoustic_column_update", "route": "cuda",
         "source": "mpas_tpu_torch/csrc/acoustic_column.cu",
         "replaces": "mpas_tpu/ops/pallas_acoustic.py:34",
         "launches": launches["acoustic_column"],
         "launches_orient": orient["launches"]["acoustic_column"],
         "launches_moist": moist["launches"]["acoustic_column"],
         "launches_cli": cli["full_width"]["launches"]["acoustic_column"],
         "launches_sharded": sharded["launches"]["acoustic_column"],
         "launches_regional": regional["launches"]["regional"][
             "acoustic_column"],
         "max_abs_err": k1["float32"]["max_abs_err"],
         "max_rel_err": k1["float32"]["max_rel_err"],
         "ms": k1["float32"]["ms"],
         "ms_cold_l2": k1["float32"]["ms_cold_l2"],
         "ms_after_idle": k1["float32"]["ms_after_idle"],
         "plain_ms": k1["float32"]["plain_ms"],
         "bound_ms": k1["float32"]["bound_ms"],
         "bound_by": k1["float32"]["bound_by"], "library_ms": None,
         "shape": [k1["float32"]["K"], k1["float32"]["C"]],
         "form": "column tile",
         **{k: k1["float32"][k] for k in
            ("tile_columns", "level_lanes", "smem_bytes", "ctas_per_sm",
             "tiles_ms", "copy_same_bytes_ms")},
         "float64": {k: k1["float64"][k] for k in
                     ("ms", "ms_cold_l2", "bound_ms", "plain_ms",
                      "max_rel_err", "tile_columns", "level_lanes",
                      "smem_bytes", "ctas_per_sm", "tiles_ms",
                      "copy_same_bytes_ms")}},
        {"name": "gather_reduce", "route": "cuda",
         "source": "mpas_tpu_torch/csrc/gather_reduce.cu",
         "replaces": "tools/windowed_kernels.py:160",
         "also_replaces": ["tools/pallas_gather_probe.py:110"],
         "launches": launches["gather_reduce"],
         "launches_orient": orient["launches"]["gather_reduce"],
         "launches_moist": moist["launches"]["gather_reduce"],
         "launches_cli": cli["full_width"]["launches"]["gather_reduce"],
         "launches_sharded": sharded["launches"]["gather_reduce"],
         "launches_regional": regional["launches"]["regional"][
             "gather_reduce"],
         "moist_shapes": [[r["Kt"], r["N"], r["R"], r["M"], r["S"]]
                          for r in k2_moist],
         "row_form_launches": main["gather_reduce_row_form_launches"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in k2 + k2_orient + k2_moist),
         "max_err_over_bound": max(r["max_err_over_bound"]
                                   for r in k2 + k2_orient + k2_moist),
         "ms": big["ms"], "ms_cold_l2": big["ms_cold_l2"],
         "ms_after_idle": big["ms_after_idle"], "plain_ms": big["plain_ms"],
         "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
         "library_ms": big["library_ms"],
         "library_same_layout_ms": big["library_same_layout_ms"],
         "shape": [big["Kt"], big["N"], big["R"], big["M"], big["S"]],
         "probe_c": {k: probe["C"][k] for k in
                     ("ms", "ms_cold_l2", "plain_ms", "bound_ms", "library_ms",
                      "library_same_layout_ms", "err_over_bound")},
         "forms": forms},
        {"name": "windowed_reduce", "route": "cuda",
         "source": "mpas_tpu_torch/csrc/windowed_reduce.cu",
         "replaces": "tools/windowed_study.py:48",
         "launches": k3_launches,
         "max_abs_err": max(r["max_abs_err"] for r in study["rows"]),
         "max_err_over_bound": max(r["err_over_bound"] for r in study["rows"]),
         "ms": k3["ms"], "ms_cold_l2": k3["ms_cold_l2"],
         "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"],
         "library_same_layout_ms": k3["library_same_layout_ms"],
         "staged_bytes": k3["staged_bytes"], "bytes": k3["bytes"],
         "shape": [k3["Kst"], k3["E"], k3["C"], k3["M"], k3["U"]]},
        {"name": "take_columns", "route": "cuda",
         "source": "mpas_tpu_torch/csrc/take_columns.cu",
         "replaces": "tools/pallas_gather_probe.py:55",
         "also_replaces": ["tools/pallas_gather_probe.py:82"],
         "launches": k4_launches, "row_form_launches": k4_row_launches,
         "launches_sharded": sharded["launches"]["take_columns"],
         "exchange": sharded["kernel4_exchange"],
         "form": a["form"], "forms": take_forms,
         "step_gate": {"open": sum(r["gate"] == "open" for r in take_step),
                       "shut": sum(r["gate"] == "shut" for r in take_step)},
         "max_abs_err": max(a["max_abs_err"], probe["B"]["max_abs_err"]),
         "ms": a["ms"], "ms_cold_l2": a["ms_cold_l2"],
         "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
         "bound_by": a["bound_by"], "library_ms": a["library_ms"],
         "shape": [a["K"], a["C"], a["R"]]},
    ]
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
