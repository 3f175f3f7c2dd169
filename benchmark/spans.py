"""What the per-layer metrics of the step's phases read from a trace's host
events: the program's top-level spans (host events named by the phase of
the step they mark), their host time, and the runtime calls that launch
device work from inside them. The readers name the spans and the calls;
nothing here is imported from the program, so a renamed span reads as
none."""

from __future__ import annotations

import bisect


def spans(host: list, prefixes: tuple) -> list:
    """Sorted (start_us, end_us) of the host events whose names start with
    one of `prefixes`; the program's spans do not nest, so these are
    disjoint."""
    return sorted((s, e) for name, s, e in host if name.startswith(prefixes))


def host_us(found: list) -> float:
    return sum(e - s for s, e in found)


def calls_inside(host: list, found: list, calls: tuple) -> int:
    """Host events named in `calls` that start inside one of the disjoint
    sorted intervals `found`."""
    starts = [s for s, _ in found]
    n = 0
    for name, s, _ in host:
        if name in calls:
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s < found[i][1]
    return n
