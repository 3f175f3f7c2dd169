"""Kernel 3: windowed gather-reduce on a locality-renumbered mesh.

The port of tools/windowed_kernels.py, a study module. With the RCM
renumbering (mesh/renumber.py) the indices of every 128-output block of a
stencil table fall in one narrow window of W columns of the source table.
`WindowPlan` plans that once on the host (window starts `ws`, width `W`,
local indices `idx_localT`); `windowed_reduce`, `slot_reduce_windowed` and
`edge_pairs_windowed` have the JAX functions' signatures without
`precision`/`interpret` and return the same nested lists. They work in
float32, as the JAX functions do.

For tensors on the card they launch the CUDA kernel in
csrc/windowed_reduce.cu, which stages each block's window in shared memory
and gathers from there; for tensors on the CPU they run
`windowed_reduce_plain`, which rebuilds each global index from the plan
(ws[b]*128 + idx_local) and sums the M slots in order. `probes.
windowed_study` runs them; the main path does not (its reductions go to
ops/gather_reduce.py on any numbering).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

BLOCK = 128
MAX_WEIGHT_SETS = 4
SMEM_TARGET = 96 * 1024     # per CTA, so that two CTAs fit on an SM
SMEM_MAX = 232448           # Hopper's per-block limit (227 KB)

# kernel launches since the counter was last set to 0
launches = 0

_plan_cache: dict = {}


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class WindowPlan:
    """Host-side planning of one index array: per-block window starts
    (in units of 128 columns), the common window width W, and local
    indices."""

    def __init__(self, idx_np: np.ndarray, block: int = BLOCK):
        idx_np = np.asarray(idx_np)
        if idx_np.ndim == 1:
            idx_np = idx_np[:, None]
        R, M = idx_np.shape
        nb = (R + block - 1) // block
        Rp = nb * block
        pad = Rp - R
        idx_p = np.concatenate([idx_np, idx_np[-1:].repeat(pad, 0)], 0) \
            if pad else idx_np
        ws = (idx_p.reshape(nb, -1).min(axis=1) // 128).astype(np.int32)
        span = (idx_p.reshape(nb, -1).max(axis=1)
                - ws.astype(np.int64) * 128 + 1)
        W = int(np.ceil(span.max() / 128) * 128)
        local = idx_p - np.repeat(ws.astype(np.int64) * 128, block)[:, None]
        assert local.min() >= 0 and local.max() < W
        self.R, self.M, self.nb, self.Rp, self.W = R, M, nb, Rp, W
        self.block = block
        self.ws = ws                                     # [nb] int32
        self.pad = pad
        self.idx_localT = np.ascontiguousarray(
            local.T.astype(np.int32))                    # [M, Rp]
        # a table must be this wide so that ws*128 + W never overruns
        self.min_table_width = int(ws.max()) * 128 + W
        self._on_device: dict = {}

    def device_tables(self, device):
        """(ws [nb], idx_localT [M, Rp]) as int32 tensors on `device`,
        copied there once."""
        key = str(torch.device(device))
        hit = self._on_device.get(key)
        if hit is None:
            hit = (torch.from_numpy(self.ws).to(device),
                   torch.from_numpy(self.idx_localT).to(device))
            self._on_device[key] = hit
        return hit


def plan_windows(idx_arr, block: int = BLOCK) -> WindowPlan:
    """Cached planner, keyed by a content digest of the index array (an
    id() key could alias two arrays when the first is freed and the second
    reuses its address). `idx_arr` is a numpy array or a tensor."""
    idx_np = np.ascontiguousarray(_host(idx_arr))
    key = (hashlib.sha1(idx_np.tobytes()).digest(), idx_np.shape, block)
    plan = _plan_cache.get(key)
    if plan is None:
        plan = WindowPlan(idx_np, block)
        _plan_cache[key] = plan
    return plan


def pad_weights(plan: WindowPlan, w, device=None):
    """[R, M] (or [R]) weights -> [M, Rp] float32 with zero pad rows."""
    w = torch.as_tensor(w).to(device=device, dtype=torch.float32)
    if w.dim() == 1:
        w = w[:, None]
    wT = torch.zeros((w.shape[1], plan.Rp), dtype=torch.float32,
                     device=w.device)
    wT[:, :plan.R] = w.t()
    return wT


def level_chunk(plan: WindowPlan, Kin: int, S: int):
    """(KC, shared bytes per CTA) of the kernel for a [Kin, ...] table and S
    weight sets: the window tile [KC, W] plus the block's local indices and
    weights, at most SMEM_TARGET where one level fits, else SMEM_MAX; the
    levels split into equal chunks."""
    extra = 4 * BLOCK * plan.M * (1 + S)
    kc_max = (SMEM_TARGET - extra) // (4 * plan.W)
    if kc_max < 1:
        kc_max = (SMEM_MAX - extra) // (4 * plan.W)
    if kc_max < 1:
        raise ValueError(f"windowed_reduce: a window of W={plan.W} columns "
                         f"does not fit in {SMEM_MAX} bytes of shared memory")
    n_chunks = -(-Kin // kc_max)
    kc = -(-Kin // n_chunks)
    return kc, 4 * kc * plan.W + extra


def windowed_reduce_plain(plan: WindowPlan, tbl, wT):
    """The plain PyTorch version: tbl [Kin, Np] (Np >= min_table_width),
    wT [S, M, Rp] -> [S, Kin, R], with every global index rebuilt from the
    plan as ws[r // block]*128 + idx_localT[m, r] and the M slots summed in
    order m = 0..M-1."""
    ws, idxT = plan.device_tables(tbl.device)
    base = torch.repeat_interleave(ws.long() * 128, plan.block)      # [Rp]
    glob = base[None, :plan.R] + idxT[:, :plan.R].long()             # [M, R]
    acc = None
    for m in range(plan.M):
        g = torch.index_select(tbl, 1, glob[m])                      # [Kin, R]
        t = wT[:, m, None, :plan.R] * g[None]
        acc = t if acc is None else acc + t
    return acc


def windowed_gather_reduce(plan: WindowPlan, tbl, wT):
    """tbl [Kin, Np] float32 (contiguous, Np >= plan.min_table_width),
    wT [S, M, Rp] float32 with S <= 4 -> [S, Kin, R]: Kernel 3 on the card,
    `windowed_reduce_plain` on the CPU."""
    if tbl.device.type == "cpu":
        return windowed_reduce_plain(plan, tbl, wT)
    if tbl.device.type != "cuda":
        raise ValueError(f"windowed_reduce: unsupported device {tbl.device}")
    global launches
    from .. import cuda_build

    S = wT.shape[0]
    Kin, Np = tbl.shape
    if tbl.dtype != torch.float32 or wT.dtype != torch.float32:
        raise TypeError(f"windowed_reduce: tbl {tbl.dtype} and wT {wT.dtype} "
                        "must be float32")
    if wT.shape != (S, plan.M, plan.Rp) or not 1 <= S <= MAX_WEIGHT_SETS:
        raise ValueError(f"windowed_reduce: wT must be [S<=4, {plan.M}, "
                         f"{plan.Rp}], got {tuple(wT.shape)}")
    if Np < plan.min_table_width or plan.block != BLOCK:
        raise ValueError(f"windowed_reduce: table width {Np} < "
                         f"{plan.min_table_width} or block {plan.block} != "
                         f"{BLOCK}")
    if wT.device != tbl.device:
        raise ValueError(f"windowed_reduce: wT on {wT.device}, tbl on "
                         f"{tbl.device}")
    if not (tbl.is_contiguous() and wT.is_contiguous()):
        raise ValueError("windowed_reduce: tbl and wT must be contiguous")
    ws, idxT = plan.device_tables(tbl.device)
    kc, smem = level_chunk(plan, Kin, S)
    out = torch.empty((S, Kin, plan.R), dtype=torch.float32, device=tbl.device)
    code = cuda_build.library().windowed_reduce_f32(
        tbl.data_ptr(), ws.data_ptr(), idxT.data_ptr(), wT.data_ptr(),
        out.data_ptr(), Kin, Np, plan.R, plan.Rp, plan.M, S, plan.W, kc, smem,
        torch.cuda.current_stream(tbl.device).cuda_stream)
    cuda_build.check(code, "windowed_reduce")
    launches += 1
    return out


def windowed_reduce(plan: WindowPlan, fields, weight_sets, entries):
    """out[e][:, r] = sum_m weight_sets[s_e][r, m] * fields[f_e][:, idx[r, m]]
    for each entry e = (f_e, s_e).

    fields: tensors [K_i, N] sharing the planned index array (N >= the
    index range). They stack along dim 0 into one float32 table, padded
    with zero columns to the plan's `min_table_width`; the kernel applies
    every weight set to every row of the table, four sets a launch.
    Returns a list of [K_i, R] tensors in entry order."""
    dev = fields[0].device
    offs = np.cumsum([0] + [int(f.shape[0]) for f in fields])
    width = max([plan.min_table_width] + [int(f.shape[1]) for f in fields])
    tbl = torch.zeros((int(offs[-1]), width), dtype=torch.float32, device=dev)
    for f, o in zip(fields, offs):
        tbl[o:o + f.shape[0], :f.shape[1]] = f
    wT = torch.stack([pad_weights(plan, w, dev) for w in weight_sets])
    out = torch.cat([windowed_gather_reduce(plan, tbl, wT[s:s + MAX_WEIGHT_SETS])
                     for s in range(0, len(weight_sets), MAX_WEIGHT_SETS)])
    return [out[s, offs[f]:offs[f + 1]] for f, s in entries]


def slot_reduce_windowed(idx_arr, specs):
    """Drop-in for stencils.slot_reduce through windowed_reduce.

    specs: [(field [K_i, N], [w_0 [R, M], ...]), ...]; returns the same
    nested list structure of [K_i, R] tensors."""
    plan = plan_windows(idx_arr)
    fields, weight_sets, entries, shape = [], [], [], []
    set_ids: dict = {}          # a weight tensor given twice is one set
    for f, wl in specs:
        fi = len(fields)
        fields.append(f)
        row = []
        for w in wl:
            si = set_ids.get(id(w))
            if si is None:
                si = len(weight_sets)
                weight_sets.append(w)
                set_ids[id(w)] = si
            entries.append((fi, si))
            row.append(len(entries) - 1)
        shape.append(row)
    flat = windowed_reduce(plan, fields, weight_sets, entries)
    return [[flat[e] for e in row] for row in shape]


def edge_pairs_windowed(cellsOnEdge, *fields):
    """Drop-in for stencils.edge_pairs: per field, (f(cell1), f(cell2)),
    each read through the windowed reduction with a one-hot weight set per
    edge side."""
    plan = plan_windows(cellsOnEdge)        # [E, 2] -> M=2
    ones = _pair_ones(plan.R, str(fields[0].device))
    entries = [(f, s) for s in (0, 1) for f in range(len(fields))]
    flat = windowed_reduce(plan, list(fields), list(ones), entries)
    n = len(fields)
    return [(flat[f], flat[n + f]) for f in range(n)]


@functools.lru_cache(maxsize=8)
def _pair_ones(R: int, device: str):
    w = torch.zeros((2, R, 2), dtype=torch.float32, device=device)
    w[0, :, 0] = 1.0
    w[1, :, 1] = 1.0
    return w[0], w[1]
