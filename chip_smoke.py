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
     the step's first call, in float32 and (inputs widened) float64;
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
     (probes.gather_probe).

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
# kernel, counted from csrc/acoustic_column.cu (forward ~41, backward ~23)
ACOUSTIC_FLOPS_PER_POINT = 64
MAIN_STEPS = 10
PROFILE_STEPS = 3
PROFILE_TOP = 15
K1_F32_REL = 1e-4     # float32 kernel vs plain, relative to max |plain|
K1_F64_REL = 1e-12    # float64 bound of tests/test_pallas.py
AGREE_REL = 1e-9      # float64 card vs CPU after 2 steps, per field


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
    """Run one step with both wrappers wrapped, keeping the arguments of the
    first acoustic column call and of the first gather-reduce call of each
    shape (Kt, N, R, M, S), and the number of calls per shape."""
    from mpas_tpu_torch.ops import acoustic, stencils
    k1_args, k2_calls = [], {}
    k1_orig, k2_orig = acoustic.acoustic_column_update, stencils.gather_reduce

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

    acoustic.acoustic_column_update, stencils.gather_reduce = k1, k2
    try:
        model.step(1)
    finally:
        acoustic.acoustic_column_update, stencils.gather_reduce = k1_orig, k2_orig
    return k1_args[0], k2_calls


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
        if rel > limit:
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
        res[name] = dict(K=K, C=C, max_abs_err=err, max_rel_err=rel,
                         limit_rel=limit, ms=ms, plain_ms=plain_ms,
                         ms_cold_l2=cuda_ms(k1, cold_l2=True),
                         ms_after_idle=cuda_ms(k1, after_idle=True),
                         bytes=nb, bound_ms=b_ms, bound_by=b_by)
    return res


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
    k1_args, k2_calls = record_step(model)
    torch.cuda.synchronize()

    # 3. Kernel 1
    k1 = timed(lambda: check_acoustic(k1_args, torch))
    emit({"phase": "acoustic_column", **k1})

    # 4. Kernel 2
    k2 = check_gather_reduce(k2_calls, torch)
    for row in k2:
        emit({"phase": "gather_reduce", **row})
    forms = {"default": emit_gather_forms(k2_calls, "default")}

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
    del model, k1_args, k2_calls
    torch.cuda.empty_cache()

    # 7. the JAX bench's setting: edges aligned to their owner cells
    t0 = time.perf_counter()
    nl_o = nl.replace(config_orient_edges=True)
    model = build_model(nl_o, mesh, device="cuda")
    torch.cuda.synchronize()
    setup_o = time.perf_counter() - t0
    _, calls = record_step(model)
    new_calls = {k: v for k, v in calls.items() if k not in shapes_seen}
    k2_orient = check_gather_reduce(new_calls, torch)
    for row in k2_orient:
        emit({"phase": "gather_reduce_orient", **row})
    forms["aligned"] = emit_gather_forms(calls, "aligned")
    del calls, new_calls
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
    take_columns.launches = 0
    probe = timed(probes.gather_probe)
    k4_launches = take_columns.launches
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
         "shape": [k1["float32"]["K"], k1["float32"]["C"]]},
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
         "launches": k4_launches,
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
