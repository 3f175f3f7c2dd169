#!/usr/bin/env python3
"""Smoke run of mpas_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, a dry Jablonowski-Williamson baroclinic-wave
run, through `build_model` and `Model.step` at full width (the x1.40962
mesh, 41 levels, float32, dt=300 s), and holds every CUDA kernel of that
path against its plain PyTorch version on the inputs the path gives it.
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
  7. main_path_orient: the same run with config_orient_edges=True (the JAX
     bench's setting) on the same mesh, with Kernel 2 checked at the shapes
     the aligned step adds (gather_reduce_orient, gather_forms), 10 counted
     steps and PROFILE_STEPS traced ones;
  8. agreement: 2 steps on the card and on the CPU at x1.2562, 8 levels,
     float64, port against port, on the default numbering and (agreement_
     orient) with config_renumber_mesh and config_orient_edges;
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
`kernels` line, the nvidia-smi line, and last the `ok` line. Any failed
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


def profile_steps(model, n, torch):
    """Trace `n` steps: launches per step, the device-busy share (union of
    the kernels' device intervals over the traced wall time), and device
    time per step by kernel name, largest first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.step(n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("profile: the trace holds no device activity")
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


def counted_steps(model, torch):
    """MAIN_STEPS steps with the launch counters of Kernels 1 and 2 set to 0
    first: the step times, the host CPU time the process spent per step
    (more host work moves it, a busy host's other tenants do not), the
    launches, the peak memory and the summary. Fails if either kernel never
    launched."""
    from mpas_tpu_torch.ops import acoustic_column, gather_reduce
    from mpas_tpu_torch.probes import step_ms
    acoustic_column.launches = gather_reduce.launches = 0
    gather_reduce.row_form_launches = 0
    torch.cuda.reset_peak_memory_stats()
    cpu0 = time.process_time()
    times = step_ms(model, MAIN_STEPS)
    cpu_ms = (time.process_time() - cpu0) * 1e3 / MAIN_STEPS
    launches = {"acoustic_column": acoustic_column.launches,
                "gather_reduce": gather_reduce.launches}
    if any(v <= 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")
    return dict(steps=MAIN_STEPS, ms_per_step_median=statistics.median(times),
                ms_per_step=times, host_cpu_ms_per_step=cpu_ms,
                launches=launches,
                gather_reduce_row_form_launches=gather_reduce.row_form_launches,
                gather_sectors=model.mesh_arrays.gather_sectors,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                summary=model.summarize())


def agreement(nl, mesh, what, torch):
    """2 float64 steps on the card and on the CPU: max relative difference
    per field, which must stay within AGREE_REL."""
    from mpas_tpu_torch.dynamics.model import build_model
    gpu = build_model(nl, mesh, device="cuda")
    cpu = build_model(nl, mesh, device="cpu")
    gpu.step(2)
    cpu.step(2)
    agree = {}
    for n in ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p"):
        a = getattr(gpu.state, n).cpu()
        b = getattr(cpu.state, n)
        agree[n] = float((a - b).abs().max() / b.abs().max())
    emit({"phase": what, "cells": mesh.nCells, "edges": gpu.mesh.nEdges,
          "levels": nl.config_nvertlevels, "dtype": nl.dtype, "steps": 2,
          "orient_edges": nl.config_orient_edges,
          "renumber_mesh": nl.config_renumber_mesh,
          "max_rel_err": agree, "limit_rel": AGREE_REL})
    bad = {k: v for k, v in agree.items() if not v <= AGREE_REL}
    if bad:
        raise RuntimeError(f"{what}: card and CPU disagree: {bad}")


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
    del model, k1_args, k2_calls, gathers
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
    orient = timed(lambda: counted_steps(model, torch))
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

    # 8. card against CPU, float64, x1.2562 / 8 levels, 2 steps
    nl6 = Namelist(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
                   config_jw_u_perturbation=1.0)
    mesh4 = generate_mesh(levels=4)
    agreement(nl6, mesh4, "agreement", torch)
    agreement(nl6.replace(config_renumber_mesh=True, config_orient_edges=True),
              mesh4, "agreement_orient", torch)

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
         "row_form_launches": main["gather_reduce_row_form_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in k2 + k2_orient),
         "max_err_over_bound": max(r["max_err_over_bound"]
                                   for r in k2 + k2_orient),
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
