"""One run of one cell: set-up, warm-up, the timed window, the traced steps
(with `trace`), the comparison with the reference, and the result line.

The window drives `step(1)` of the model that
`mpas_tpu_torch.dynamics.model.build_model` returns (or the configuration's
own `programs/` module builds), back to back as a user's run does, with no
synchronisation inside it; a CUDA event recorded after each step gives the
step intervals, read after the window.
"""

from __future__ import annotations

import gc
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import check, inputs, spec
from .trace import trace_steps

# top-level module names that no run may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "mpas_tpu")
CACHE_DIR = spec.ROOT / ".cache"


def fix_cache_dirs():
    """Every kernel cache a library of the run may use, at a fixed path
    inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE_DIR / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class StepClock:
    """Marks the end of each step: a CUDA event on the card, the host's
    clock elsewhere. `intervals_ms` is read after the window."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def build_program(cell, draws, grid, device):
    """The program's model for this cell and seed, with the seeded inputs:
    the configuration's own `programs/` module where it names one, else
    `mpas_tpu_torch`'s `build_model`."""
    namelist = dict(cell.namelist,
                    config_jw_u_perturbation=draws.jw_u_perturbation)
    if cell.program is not None:
        model = cell.program.build(namelist, grid, device)
    else:
        from mpas_tpu_torch.config import Namelist
        from mpas_tpu_torch.dynamics.model import build_model
        from mpas_tpu_torch.mesh.loader import load_mesh
        model = build_model(Namelist(**namelist), load_mesh(str(grid)),
                            device=device)
    s = model.state
    n_scalars = 0 if s.scalars is None else s.scalars.shape[0]
    K, C = s.theta_m.shape
    model.state = check.with_inputs(
        s, check.condensate_for(cell, draws, n_scalars, K, C))
    return model


def sizes_of(model) -> dict:
    nl, m = model.namelist, model.mesh_arrays
    s = model.state
    return dict(nCells=m.nCells, nEdges=m.nEdges,
                nVertices=int(m.edgesOnVertex.shape[0]),
                K=int(s.theta_m.shape[0]), maxEdges=int(m.edgesOnCell.shape[1]),
                maxEdges2=int(m.edgesOnEdge.shape[1]),
                n_sub=nl.config_number_of_sub_steps,
                split=nl.config_dynamics_split_steps,
                n_scalars=0 if s.scalars is None else int(s.scalars.shape[0]),
                microphysics=nl.config_microphysics,
                nfall=nl.config_kessler_nfall,
                itemsize=s.theta_m.element_size(),
                index_itemsize=m.edgesOnEdge.element_size(),
                dtype=str(s.theta_m.dtype).replace("torch.", ""),
                dt=nl.config_dt)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0_perf: float, age0: float, grid_dir=inputs.GRID_DIR,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)):
    """One run; returns the result dict, whose last key is `checks`."""
    import torch
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    draws = inputs.draw(seed, cell.traffic)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    model = build_program(cell, draws, grid, device)
    warmup = int(cell.traffic["warmup_steps"])
    model.step(warmup)
    sync()
    setup_s = age0 + time.perf_counter() - t0_perf
    setup_stages = dict(model.setup_seconds)

    # the timed window: steps back to back until `seconds` have passed on
    # the host's clock, then one synchronisation
    clock = StepClock(torch, device)
    kept, n = None, 0
    t_start = time.perf_counter()
    while True:
        model.step(1)
        n += 1
        clock.mark()
        if n == draws.check_step:
            kept = check.snapshot(model.state)
        if time.perf_counter() - t_start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t_start
    if kept is None:            # a window shorter than the drawn step
        kept, draws.check_step = check.snapshot(model.state), n
    step_ms = clock.intervals_ms()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = check.nonfinite(check.to_host(check.fields(model.state)))
    dt = model.namelist.config_dt
    e2e = {
        "sim_days_per_hour": ((n * dt / 86400.0) / (window_s / 3600.0),
                              "days/h"),
        "step_ms_p95": (float(np.percentile(step_ms, 95)), "ms"),
        "peak_mem_gib": (peak / 2 ** 30, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    quarters = [statistics.median(q) for q in np.array_split(step_ms, 4)
                if len(q)]
    pcts = np.percentile(step_ms, [5, 50, 90, 95, 99])
    log(f"window: {n} steps in {window_s:.3f} s, median step "
        f"{statistics.median(step_ms):.3f} ms (by quarter of the window: "
        f"{', '.join(f'{q:.3f}' for q in quarters)}; percentiles 5/50/90/"
        f"95/99: {', '.join(f'{q:.3f}' for q in pcts)}), checked step "
        f"{draws.check_step}")

    reported = spec.reported_in(cell.name)
    breakdown, layer = None, {}
    if trace:
        tr = trace_steps(lambda: model.step(1), int(cell.traffic["trace_steps"]),
                         torch)
        run = SimpleNamespace(trace=tr, sizes=sizes_of(model),
                              setup_stages=setup_stages, window_steps=n,
                              window_s=window_s, step_ms=step_ms)
        for name, reader in spec.metric_readers().items():
            if reported is not None and name not in reported:
                continue
            value = reader.read(run)
            if value is not None:
                layer[name] = {"value": float(value), "unit": reader.UNIT}
        breakdown = tr.breakdown()

    # the reference runs once the program's state is freed
    prog = check.to_host(kept)
    del kept, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    steps = warmup + draws.check_step
    t_ref = time.perf_counter()
    ref0, ref = check.reference_run(cell, draws, grid, steps, device)
    log(f"reference: {steps} steps in {time.perf_counter() - t_ref:.1f} s")
    numbers = dict(check.gaps(prog, ref, ref0), nonfinite=bad)
    correct, failed, checks = check.verdict(numbers, cell.limits)
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")

    metrics = layer if trace else {
        k: {"value": v, "unit": u} for k, (v, u) in e2e.items()
        if reported is None or k in reported}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.wall_s)
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
