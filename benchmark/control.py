"""The controls of the comparison that decides `correct`: the reference put
in the program's place one precision below the configuration's (bfloat16
for its float32), at the cell's own size, on the seeds given, in two forms:
`bf16_compute` computes the whole step in bfloat16; `bf16_store` computes
in float32 and rounds every value the state keeps between steps to
bfloat16. Both have to fail the cell's limits. The benchmark's own runs
never run them. `f32_reference`, the reference itself in float32, is no
control but a witness: what sound float32 arithmetic reads against the
float64 reference on the same seed.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--forms bf16_store f32_reference] [--device cuda]

Prints one JSON line a seed and form: its gaps, the limits and whether it
came out correct (a control must not).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import check, inputs, spec  # noqa: E402

# (compute type, storage type) of each control
CONTROLS = {"bf16_compute": (torch.bfloat16, None),
            "bf16_store": (torch.float32, torch.bfloat16)}
WITNESSES = {"f32_reference": (torch.float32, None)}


def control_numbers(cell, seed: int, device, grid_dir=inputs.GRID_DIR,
                    forms=tuple(CONTROLS)) -> dict:
    """{form: its compared numbers} for one seed, at the step the seed
    draws, after the cell's warm-up; `forms` are names of CONTROLS or
    WITNESSES."""
    draws = inputs.draw(seed, cell.traffic)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    steps = int(cell.traffic["warmup_steps"]) + draws.check_step
    ref0, ref = check.reference_run(cell, draws, grid, steps, device)
    out = {}
    for name in forms:
        dtype, store = {**CONTROLS, **WITNESSES}[name]
        _, ctl = check.reference_run(cell, draws, grid, steps, device, dtype,
                                     store)
        out[name] = dict(check.gaps(ctl, ref, ref0),
                         nonfinite=check.nonfinite(ctl))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--forms", nargs="+", default=list(CONTROLS),
                   choices=list(CONTROLS) + list(WITNESSES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        forms = control_numbers(cell, seed, device, forms=args.forms)
        for name, numbers in forms.items():
            correct, failed, checks = check.verdict(numbers, cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": name, "correct": correct,
                              "failed": failed,
                              "seconds": time.perf_counter() - t0,
                              "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
