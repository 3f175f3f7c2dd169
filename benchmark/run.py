"""Run one cell of the benchmark of mpas_tpu_torch once, on the card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`, `attempted`
(steps in the window), `failed` (checks over their limit), `metrics` (the
end-to-end metrics with --trace 0, the per-layer ones with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`, each number
compared beside its limit. The same checks are the last lines of standard
error. Exits non-zero, printing no result, without enough CUDA devices or
if jax or the JAX package was loaded.
"""

import os
import time


def process_age_s() -> float:
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# the process's age at this moment of the host's clock: set-up is measured
# from the process's start, before the interpreter reached this line
AGE0, T0_PERF = process_age_s(), time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    harness.fix_cache_dirs()

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import mpas_tpu_torch  # noqa: F401  (fail before any work without it)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda"), T0_PERF, AGE0)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
