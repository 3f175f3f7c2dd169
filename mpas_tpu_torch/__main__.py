"""Command-line model driver: the main.rg analog.

The port of `mpas_tpu.__main__`: the reference's run flow (main.rg:15-75)
— load or generate a mesh -> JW init -> core init -> timestep loop with
per-step summaries, radiation intervals, checkpoints -> history output:

    python -m mpas_tpu_torch --grid generate:4 --levels 26 --steps 10 \
        --output timestep_output.nc [--config namelist.json] [--physics]
        [--restart ckpt.npz] [--checkpoint-every 50] [--device cpu]
        [--shards 4] [--metis graph.info.part.4]

It runs on the CUDA device unless `--device cpu` is given; without a card,
`--device cuda` raises rather than falling back to the CPU. `--shards N`
decomposes the domain into N shards (parallel/sharded.py): all N on the
one device in this process, or, under `torchrun --nproc-per-node N -m
mpas_tpu_torch --shards N`, one process per shard (gloo with `--device
cpu`, NCCL on cuda:LOCAL_RANK otherwise). History and checkpoints of a
sharded run are written by rank 0 alone.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpas_tpu_torch",
                                 description="MPAS-Atmosphere dycore in "
                                             "PyTorch (CUDA)")
    ap.add_argument("--grid", default="generate:4",
                    help="MPAS grid netCDF, or 'generate:LEVELS' for a "
                         "synthetic CVT mesh (generate:4 -> 2562 cells, "
                         "generate:6 -> 40962 cells)")
    ap.add_argument("--config", default=None, help="namelist file (JSON or name=value)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--ztop", type=float, default=None)
    ap.add_argument("--dtype", default=None, choices=["float32", "float64"])
    ap.add_argument("--no-perturbation", action="store_true")
    ap.add_argument("--orient-edges", action="store_true",
                    help="ownership-aligned edge numbering (mesh/orient.py);"
                         " edge ids and checkpoints are not interchangeable "
                         "with the default numbering")
    ap.add_argument("--output", default="timestep_output.nc")
    ap.add_argument("--output-full-3d", action="store_true")
    ap.add_argument("--history-every", type=int, default=0,
                    help="record a history snapshot every N steps (the "
                         "output becomes a multi-time-level file)")
    ap.add_argument("--log-every", type=int, default=0,
                    help="steps between summarize/NaN-check fetches (each "
                         "fetch waits for the device). Default 0 = every 10 "
                         "steps.")
    ap.add_argument("--shards", type=int, default=0,
                    help="domain-decompose into N shards (0 = single device):"
                         " one process per shard under torchrun, else all N"
                         " on --device")
    ap.add_argument("--metis", default=None, help="METIS partition file")
    ap.add_argument("--restart", default=None, help="restart checkpoint to resume")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-path", default="restart.npz")
    ap.add_argument("--physics", action="store_true",
                    help="enable the radiation/cloud physics driver: both "
                         "radiation schemes on (config_radt_lw_scheme "
                         "cam_lw, config_radt_sw_scheme cam_sw)")
    ap.add_argument("--radt-steps", type=int, default=5,
                    help="dynamics steps between radiation calls (>= 1): "
                         "both radiation intervals at this many steps")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.physics and args.radt_steps < 1:
        ap.error(f"--radt-steps must be >= 1 (got {args.radt_steps})")
    if args.levels is not None and args.levels < 3:
        ap.error(f"--levels must be >= 3 (got {args.levels}): the vertical "
                 "solver needs at least 3 mass levels")

    from .dynamics.model import resolve_device

    sharded = args.shards > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    distributed = sharded and world > 1
    if world > 1 and world != args.shards:
        ap.error(f"--shards {args.shards} under {world} processes: give one "
                 "process per shard")
    device = resolve_device(args.device)
    if distributed:
        import torch.distributed as dist
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return _run(args, device, sharded)
    finally:
        if distributed:
            dist.destroy_process_group()


def radiation_namelist(nl, radt_steps: int):
    """`--physics --radt-steps n` on one device: both radiation schemes on,
    both intervals n * dt, on which the step's alarm rings every n steps
    from step 0 (`radiation_rings` takes n * dt multiplied in floats as n
    steps)."""
    interval = radt_steps * nl.config_dt
    return nl.replace(config_radt_lw_scheme="cam_lw",
                      config_radt_sw_scheme="cam_sw",
                      config_radtlw_interval=interval,
                      config_radtsw_interval=interval)


def _run(args, device, sharded):
    from .config import Namelist
    from .dynamics.model import build_model
    from .io.history import (HistoryWriter, gathered_state, load_restart,
                             save_restart, write_history)

    nl = Namelist.from_file(args.config) if args.config else Namelist()
    overrides = {}
    if args.levels is not None:
        overrides["config_nvertlevels"] = args.levels
    if args.dt is not None:
        overrides["config_dt"] = args.dt
    if args.ztop is not None:
        overrides["config_ztop"] = args.ztop
    if args.steps is not None:
        overrides["config_run_duration_steps"] = args.steps
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    if args.no_perturbation:
        overrides["config_jw_u_perturbation"] = 0.0
    if args.orient_edges:
        overrides["config_orient_edges"] = True
    nl = nl.replace(**overrides)

    rank0 = int(os.environ.get("RANK", "0")) == 0
    log = (lambda *a: None) if args.quiet or not rank0 else print

    if args.grid.startswith("generate:"):
        from .mesh.writer import generate_and_cache
        levels = int(args.grid.split(":")[1])
        log(f"generating (or loading cached) x1.{10 * 4 ** levels + 2} CVT mesh ...")
        # honor a reduced-planet namelist (DCMIP-style small-sphere cases)
        mesh = generate_and_cache(levels, sphere_radius=nl.config_sphere_radius)
    else:
        from .mesh.loader import load_mesh
        mesh = load_mesh(args.grid, sphere_radius=nl.config_sphere_radius)

    # MPAS rule of thumb: dt ~ 6 s per km of cell spacing; apply when the
    # user did not set an explicit dt. 4 s/km of the MINIMUM spacing keeps
    # the acoustic CFL ~0.65 with 2 substeps (6 s/km is marginal at CFL ~1
    # and unstable on imperfect CVT meshes)
    if args.dt is None and args.config is None:
        dx_km = float(mesh.dcEdge.min()) / 1e3
        nl = nl.replace(config_dt=min(720.0, 4.0 * dx_km))
    if args.physics and not sharded:
        # the step's own radiation alarm (the sharded runner calls
        # apply_physics in the loop below)
        nl = radiation_namelist(nl, args.radt_steps)
    t0 = time.time()
    log(f"building model (levels={nl.config_nvertlevels}, dt={nl.config_dt:.0f}s, "
        f"device={device}) ...")
    model = build_model(nl, mesh, device=device)
    log(f"model ready in {time.time() - t0:.1f}s: {model.mesh.nCells} cells, "
        f"{model.mesh.nEdges} edges, {nl.config_nvertlevels} levels")

    runner = model
    if sharded:
        from .parallel.sharded import shard_model, sharded_summarize
        log(f"sharding into {args.shards} shards ...")
        runner = shard_model(model, args.shards, metis_path=args.metis)

    if args.restart:
        # a sharded checkpoint restores into the sharded runner, a
        # single-device checkpoint into the model — same shard count required
        load_restart(args.restart, runner)
        log(f"resumed from {args.restart} at step {runner.step_count}")

    phys = None
    if args.physics and sharded:
        from .physics.driver import physics_init
        phys = physics_init()
        runner.enable_physics(phys)

    hist = None
    if args.output and args.history_every:
        hist = HistoryWriter(model, full_3d=args.output_full_3d)

    def record_history():
        if sharded:
            hist.record(state=gathered_state(runner, model),
                        time_value=float(runner.step_count))
        else:
            hist.record()

    # wall time of the loop's parts other than the steps; the device is
    # synchronized before each, so the steps' queued work counts as theirs
    spent = {"history": 0.0, "checkpoints": 0.0}
    if phys is not None:
        spent = {"radiation": 0.0, **spent}

    def timed(part, fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.time()
        out = fn()
        spent[part] += time.time() - t
        return out

    n_steps = nl.config_run_duration_steps
    log_every = args.log_every if args.log_every > 0 else 10
    t0 = time.time()
    for step in range(n_steps):
        if phys is not None and step % args.radt_steps == 0:
            timed("radiation", lambda: runner.apply_physics(phys))
            log("  physics: radiation interval applied (sharded)")
        runner.step(1)
        # summarize waits for the device: fetch only every --log-every steps
        if (step + 1) % log_every == 0 or step + 1 == n_steps:
            pd = None if sharded else model.radiation_diags
            if pd is not None:
                log(f"  physics (last radiation call, {model.radiation_calls}"
                    f" so far): cldfra max={float(pd['cldfra'].max()):.2f} "
                    f"OLR mean={float(pd['olr'].mean()):.0f} W/m2 "
                    f"qr range=[{float(pd['qrl'].min()) * 86400:.1f},"
                    f"{float(pd['qrs'].max()) * 86400:.1f}] K/day")
            s = sharded_summarize(runner) if sharded else model.summarize()
            log(f"step {runner.step_count}: "
                f"w=[{s['w_min']:+.3e},{s['w_max']:+.3e}] "
                f"u=[{s['u_min']:+.2f},{s['u_max']:+.2f}]"
                + (" *** NaN detected ***" if s["nan_detected"] else ""))
            if s["nan_detected"]:
                log("aborting: NaN in prognostic fields")
                return 1
        if hist is not None and (step + 1) % args.history_every == 0:
            timed("history", record_history)
        if args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
            timed("checkpoints",
                  lambda: save_restart(args.checkpoint_path, runner))
            log(f"checkpoint -> {args.checkpoint_path}")
    elapsed = time.time() - t0
    log(f"{n_steps} steps in {elapsed:.2f}s "
        f"({elapsed / max(n_steps, 1) * 1000:.1f} ms/step; of the loop: "
        + ", ".join(f"{k} {v:.2f}s" for k, v in spent.items()) + ")")

    if args.output:
        state = None
        if sharded:
            # the history's time is the model's step count (mpas_tpu writes
            # the unstepped model's 0 here)
            state, model.step_count = gathered_state(runner, model), runner.step_count
        if rank0:
            if hist is not None:
                hist.write(args.output)
            else:
                write_history(args.output, model, state=state,
                              full_3d=args.output_full_3d)
        log(f"history -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
