"""The readings that a cell's limits are set from: the program as the
cell's runs build it (`harness.build_program`), stepped to the step the
seed draws after the warm-up with no timed window in between, against the
cell's reference, on the seeds given. With `--program-configs`, the
program built from another configuration's namelist takes the program's
place too, as a control that has to fail the limits: `jw_moist_wsm6` (the
radiation off) against `moist_120km_rad30m`'s reference. The reference
runs once a seed.

    python benchmark/readings.py --workload <cell> --seeds 1 2 3 \
        [--program-configs <config> ...] [--device cuda]

Prints one JSON line a seed and program (`program`: `sound`, or the
configuration's name): its numbers beside the limits and whether it came
out correct. The benchmark's own runs never run it.
"""

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import check, harness, inputs, spec  # noqa: E402


def with_config(cell, config_name: str):
    """The cell with another configuration's namelist and program (its
    traffic, reference and limits kept)."""
    config = spec._load(spec.ROOT, "configs", config_name)
    return dataclasses.replace(
        cell, config_name=config_name, config=config,
        program=spec._own_module(spec.ROOT, "programs",
                                 config.get("program")))


def program_state(cell, draws, grid, steps: int, device) -> dict:
    """Host copies of the compared fields of the cell's program after
    `steps` steps, the model freed."""
    model = harness.build_program(cell, draws, grid, device)
    model.step(steps)
    prog = check.to_host(check.fields(model.state))
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return prog


def readings(cell, seed: int, device, programs=("sound",),
             grid_dir=inputs.GRID_DIR) -> dict:
    """{program: its compared numbers} for one seed: `sound` is the cell's
    own program, any other name a configuration's."""
    draws = inputs.draw(seed, cell.traffic)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    steps = int(cell.traffic["warmup_steps"]) + draws.check_step
    progs = {name: program_state(
        cell if name == "sound" else with_config(cell, name), draws, grid,
        steps, device) for name in programs}
    ref0, ref = check.reference_run(cell, draws, grid, steps, device)
    return {name: dict(check.gaps(prog, ref, ref0),
                       nonfinite=check.nonfinite(prog))
            for name, prog in progs.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program-configs", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    harness.fix_cache_dirs()
    device = torch.device(args.device)
    programs = ["sound"] + args.program_configs
    for seed in args.seeds:
        t0 = time.perf_counter()
        draws = inputs.draw(seed, cell.traffic)
        for name, numbers in readings(cell, seed, device, programs).items():
            correct, failed, checks = check.verdict(numbers, cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "check_step": draws.check_step,
                              "program": name, "correct": correct,
                              "failed": failed,
                              "seconds": time.perf_counter() - t0,
                              "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
