"""The device trace of a few steps, reduced to what the per-layer metrics
and the breakdown read: the device's operations (name, start, end), the
union of their intervals, the traced wall time, and the idle gaps between
them by what the host was doing."""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass

TOP = 10              # entries of each list of the breakdown
NAME_CHARS = 120      # a kernel's name is cut to this many characters


@dataclass
class Trace:
    steps: int
    wall_s: float                 # host clock around the traced steps
    device: list                  # (name, start_us, end_us) of each op
    host: list                    # (name, start_us, end_us) of host ops

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device)) / 1e6

    def by_name(self) -> dict:
        """{name: [launches, device seconds]}."""
        out = {}
        for name, s, e in self.device:
            d = out.setdefault(name, [0, 0.0])
            d[0] += 1
            d[1] += (e - s) / 1e6
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], v[1]] for n, v in ops],
                "idle_gaps": idle_gaps(self.device, self.host)[:TOP]}


def merged(device: list) -> list:
    """The union of the device intervals, as sorted disjoint [start, end)."""
    out = []
    for s, e in sorted((s, e) for _, s, e in device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(device: list, host: list) -> list:
    """[name, seconds] of the device's idle gaps, summed by the outermost
    host operation running at each gap's middle ("python" where none ran),
    longest first."""
    top, end = [], None
    for name, s, e in sorted(host, key=lambda h: (h[1], -h[2])):
        if end is None or s >= end:
            top.append((s, e, name))
            end = e
    starts = [t[0] for t in top]
    totals = {}
    busy = merged(device)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        name = top[i][2] if i >= 0 and top[i][1] > mid else "python"
        totals[name] = totals.get(name, 0.0) + (s1 - e0) / 1e6
    return sorted(([n[:NAME_CHARS], v] for n, v in totals.items()),
                  key=lambda nv: -nv[1])


def trace_steps(step, n: int, torch) -> Trace:
    """Run `step()` n times under torch.profiler, with the device
    synchronised before and after."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        (device if e.device_type == cuda else host).append(rec)
    if not device:
        raise RuntimeError("the trace holds no device activity")
    return Trace(steps=n, wall_s=wall, device=device, host=host)
