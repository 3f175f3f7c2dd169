"""The comparison that decides `correct`.

The window's state at one step drawn from the seed (u, w, theta_m, rho_zz
and, where the run carries them, scalars and rainnc) is held against the
frozen plain reference (`reference/`, or the configuration's own module
under `references/`), which loads the same grid file, takes the same
seeded inputs, builds its own coefficients and initial state in float64
and runs as many steps. Each field's gap is the largest difference
from the reference over the largest change of the reference's field since
its initial state (per species for scalars); rainnc, which starts at 0,
is compared by root mean square. The window's last state must hold no
non-finite value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import inputs
from .reference.config import Namelist as RefNamelist
from .reference.dynamics.model import build_model as ref_build_model
from .reference.mesh.loader import load_mesh as ref_load_mesh

FIELDS = ("u", "w", "theta_m", "rho_zz", "scalars", "rainnc")


def fields(state) -> dict:
    """The compared fields of a state that carries them."""
    return {k: getattr(state, k) for k in FIELDS
            if getattr(state, k, None) is not None}


def snapshot(state) -> dict:
    """Copies of the compared fields, on the state's device."""
    return {k: v.clone() for k, v in fields(state).items()}


def nonfinite(host: dict) -> int:
    """Non-finite values in host copies of the compared fields."""
    return int(sum((~np.isfinite(v)).sum() for v in host.values()))


def with_inputs(state, cond):
    """The state with the seeded condensate in scalars[1:]."""
    if cond is None:
        return state
    s = state.scalars.clone()
    s[1:] = torch.from_numpy(cond).to(s.device, s.dtype)
    return state.replace(scalars=s)


def condensate_for(cell, draws, n_scalars: int, K: int, C: int):
    if n_scalars < 2:
        return None
    t = cell.traffic
    stretch = cell.namelist.get("config_vertical_stretch",
                                RefNamelist.config_vertical_stretch)
    return inputs.condensate(draws, n_scalars - 1, K, C, t["ztop"], stretch,
                             t["condensate_share"])


def rounded(state, dtype):
    """The state with every floating field rounded to `dtype` and back."""
    kw = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if torch.is_tensor(t) and t.is_floating_point():
            kw[f.name] = t.to(dtype).to(t.dtype)
    return state.replace(**kw)


def reference_run(cell, draws, grid, steps: int, device, dtype=torch.float64,
                  store=None):
    """(initial fields, fields after `steps` steps) of the reference (the
    configuration's own `references/` module where it names one), as
    float64 numpy. With `store`, every value the state keeps between steps
    is rounded to that type."""
    namelist = dict(cell.namelist,
                    config_jw_u_perturbation=draws.jw_u_perturbation)
    if cell.reference is not None:
        model = cell.reference.build(namelist, grid, device, dtype)
    else:
        model = ref_build_model(RefNamelist(**namelist),
                                ref_load_mesh(str(grid)), device, dtype)
    s = model.state
    n_scalars = 0 if s.scalars is None else s.scalars.shape[0]
    model.state = with_inputs(s, condensate_for(
        cell, draws, n_scalars, s.theta_m.shape[0], s.theta_m.shape[1]))
    if store is not None:
        step = model.step_fn
        model.step_fn = lambda st: rounded(step(st), store)
        model.state = rounded(model.state, store)
    start = to_host(fields(model.state))
    model.step(steps)
    return start, to_host(fields(model.state))


def to_host(f: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float64).numpy() for k, v in f.items()}


def gap(p, r, r0, norm=np.max) -> float:
    """norm |p - r| over norm |r - r0|, for `norm` the largest value or
    the root mean square: inf where p holds a non-finite value or where
    the reference did not move and the program did, 0 where neither
    did."""
    num = float(norm(np.abs(p - r)))
    den = float(norm(np.abs(r - r0)))
    if not np.isfinite(num):
        return float("inf")
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def rms(a):
    return np.sqrt(np.mean(a * a))


def gaps(prog: dict, ref: dict, ref0: dict) -> dict:
    """The compared numbers: the widest gap of each field (of each
    species for scalars), and the root-mean-square gap of rainnc, whose
    widest gap does not tell float32 from bfloat16 storage."""
    out = {}
    for k in FIELDS:
        if k not in ref:
            continue
        name = "rainnc_rms" if k == "rainnc" else k
        if k not in prog:
            out[name] = float("inf")
        elif k == "scalars":
            out[name] = max(gap(prog[k][i], ref[k][i], ref0[k][i])
                            for i in range(ref[k].shape[0]))
        else:
            out[name] = gap(prog[k], ref[k], ref0[k],
                            rms if k == "rainnc" else np.max)
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, failed, {name: {"value", "limit"}}): each number against
    its limit; a number without a limit, or that is not finite, fails."""
    checks, failed = {}, 0
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value <= limit
        failed += not ok
        # a non-finite number is written as null: JSON has no infinity
        checks[name] = {"value": value if np.isfinite(value) else None,
                        "limit": limit}
    return failed == 0, failed, checks
