"""Kernel 3: windowed gather-reduce on a locality-renumbered mesh.

The port of tools/windowed_kernels.py, a study module. With the RCM
renumbering (mesh/renumber.py) the indices of every 128-output block of a
stencil table fall in one narrow window of W columns of the source table.
`WindowPlan` plans that once on the host: the JAX module's window starts
`ws`, width `W` and local indices `idx_localT`, and the column plan the
CUDA kernel reads, per block the sorted distinct columns its references
name (`cols`, `U` wide) and each reference as a position in that list
(`idx_colsT`). `windowed_reduce`, `slot_reduce_windowed` and
`edge_pairs_windowed` have the JAX functions' signatures without
`precision`/`interpret` and return the same nested lists. They work in
float32, as the JAX functions do.

For tensors on the card they launch the CUDA kernel in
csrc/windowed_reduce.cu, which stages the block's columns (not its whole
window) in shared memory and gathers from there, so an index table of any
numbering is legal: a block that names many columns costs shared memory,
not correctness. For tensors on the CPU they run `windowed_reduce_plain`,
which rebuilds each global index from the column plan
(cols[r // 128, idx_colsT[m, r]]) and sums the M slots in order. `probes.
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
LIST_ALIGN = 32             # a block's column list is padded to a warp
SMEM_TARGET = 32 * 1024     # per CTA, so that seven CTAs fit on an SM
SMEM_MAX = 232448           # Hopper's per-block limit (227 KB)
SMEM_SM = 233472            # shared memory of one SM (228 KB)
CTA_WAVES = 4               # CTAs launched per CTA the card holds at once

# kernel launches since the counter was last set to 0
launches = 0

_plan_cache: dict = {}


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class WindowPlan:
    """Host-side planning of one index array: per-block window starts
    (in units of 128 columns), the common window width W and local
    indices, as tools/windowed_kernels.py plans them; and the column plan:
    `cols` [nb, U] int32, per block the sorted distinct columns its
    block*M references name, `ncols` [nb] of them, a short list padded
    with its last column, U the longest list rounded up to 32;
    `idx_colsT` [M, Rp] int32, each reference as a position in its block's
    list, so that cols[r // block, idx_colsT[m, r]] == idx[r, m]."""

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
        # the TPU kernel's table must be this wide (ws*128 + W never
        # overruns); the CUDA kernel needs only max_index + 1 columns
        self.min_table_width = int(ws.max()) * 128 + W
        self.max_index = int(idx_p.max())

        refs = idx_p.reshape(nb, block * M).astype(np.int64)
        order = np.argsort(refs, axis=1, kind="stable")
        srt = np.take_along_axis(refs, order, axis=1)
        pos_sorted = np.zeros_like(srt)
        pos_sorted[:, 1:] = np.cumsum(srt[:, 1:] != srt[:, :-1], axis=1)
        pos = np.empty_like(pos_sorted)
        np.put_along_axis(pos, order, pos_sorted, axis=1)
        ncols = pos_sorted[:, -1] + 1
        U = int(-(-int(ncols.max()) // LIST_ALIGN) * LIST_ALIGN)
        cols = np.repeat(srt[:, -1:], U, axis=1)
        np.put_along_axis(cols, pos_sorted, srt, axis=1)
        self.U = U
        self.cols = np.ascontiguousarray(cols.astype(np.int32))  # [nb, U]
        self.ncols = ncols.astype(np.int32)                      # [nb]
        self.idx_colsT = np.ascontiguousarray(
            pos.reshape(Rp, M).T.astype(np.int32))               # [M, Rp]
        self._on_device: dict = {}

    def device_tables(self, device):
        """(cols [nb, U], ncols [nb], idx_colsT [M, Rp]) as int32 tensors on
        `device`, copied there once."""
        key = str(torch.device(device))
        hit = self._on_device.get(key)
        if hit is None:
            hit = tuple(torch.from_numpy(a).to(device)
                        for a in (self.cols, self.ncols, self.idx_colsT))
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
    weight sets: a ring of two stages of [KC, U] floats plus the block's
    column list, positions and weights, at most SMEM_TARGET where a ring of
    one level fits in that, else SMEM_MAX; the levels split into equal
    chunks."""
    extra = 4 * (plan.U + BLOCK * plan.M * (1 + S))
    kc_max = (SMEM_TARGET - extra) // (8 * plan.U)
    if kc_max < 1:
        kc_max = (SMEM_MAX - extra) // (8 * plan.U)
    if kc_max < 1:
        raise ValueError(f"windowed_reduce: two stages of U={plan.U} columns "
                         f"do not fit in {SMEM_MAX} bytes of shared memory")
    n_chunks = -(-Kin // kc_max)
    kc = -(-Kin // n_chunks)
    return kc, 8 * kc * plan.U + extra


def level_slices(plan: WindowPlan, Kin: int, kc: int, smem: int,
                 n_sm: int) -> int:
    """How many CTAs share a block's level chunks (the grid's second
    dimension): enough that the launch holds CTA_WAVES CTAs for each one
    the card's `n_sm` SMs keep resident at `smem` bytes each, at most one
    per chunk."""
    # a resident CTA also takes 1 KB of the SM's shared memory for the system
    resident = n_sm * max(1, min(SMEM_SM // (smem + 1024), 2048 // BLOCK))
    return max(1, min(-(-Kin // kc), -(-CTA_WAVES * resident // plan.nb)))


def windowed_reduce_plain(plan: WindowPlan, tbl, wT):
    """The plain PyTorch version: tbl [Kin, Np] (Np > plan.max_index),
    wT [S, M, Rp] -> [S, Kin, R], with every global index rebuilt from the
    column plan as cols[r // block, idx_colsT[m, r]] and the M slots summed
    in order m = 0..M-1."""
    cols, _, idxT = plan.device_tables(tbl.device)
    rows = torch.arange(plan.R, device=tbl.device) // plan.block     # [R]
    glob = cols[rows[None], idxT[:, :plan.R].long()]                 # [M, R]
    acc = None
    for m in range(plan.M):
        g = torch.index_select(tbl, 1, glob[m])                      # [Kin, R]
        t = wT[:, m, None, :plan.R] * g[None]
        acc = t if acc is None else acc + t
    return acc


def windowed_gather_reduce(plan: WindowPlan, tbl, wT):
    """tbl [Kin, Np] float32 (contiguous, Np > plan.max_index),
    wT [S, M, Rp] float32 with S <= 4 -> [S, Kin, R]: Kernel 3 on the card,
    `windowed_reduce_plain` on the CPU."""
    if tbl.dim() != 2 or tbl.shape[0] < 1 or tbl.shape[1] <= plan.max_index:
        raise ValueError(f"windowed_reduce: table {tuple(tbl.shape)} must "
                         f"have a row and more than {plan.max_index} columns")
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
    if plan.block != BLOCK:
        raise ValueError(f"windowed_reduce: the kernel takes blocks of "
                         f"{BLOCK} outputs, the plan has {plan.block}")
    if wT.device != tbl.device:
        raise ValueError(f"windowed_reduce: wT on {wT.device}, tbl on "
                         f"{tbl.device}")
    if not (tbl.is_contiguous() and wT.is_contiguous()):
        raise ValueError("windowed_reduce: tbl and wT must be contiguous")
    cols, ncols, idxT = plan.device_tables(tbl.device)
    kc, smem = level_chunk(plan, Kin, S)
    slices = level_slices(plan, Kin, kc, smem, sm_count(tbl.device))
    out = torch.empty((S, Kin, plan.R), dtype=torch.float32, device=tbl.device)
    code = cuda_build.library().windowed_reduce_f32(
        tbl.data_ptr(), cols.data_ptr(), ncols.data_ptr(), idxT.data_ptr(),
        wT.data_ptr(), out.data_ptr(), Kin, Np, plan.R, plan.Rp, plan.M, S,
        plan.U, kc, slices, smem,
        torch.cuda.current_stream(tbl.device).cuda_stream)
    cuda_build.check(code, "windowed_reduce")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of the card `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def windowed_reduce(plan: WindowPlan, fields, weight_sets, entries):
    """out[e][:, r] = sum_m weight_sets[s_e][r, m] * fields[f_e][:, idx[r, m]]
    for each entry e = (f_e, s_e).

    fields: tensors [K_i, N] sharing the planned index array (N > the
    largest index). They stack along dim 0 into one float32 table, fields
    narrower than the widest padded with zero columns; the kernel applies
    every weight set to every row of the table, four sets a launch.
    Returns a list of [K_i, R] tensors in entry order."""
    dev = fields[0].device
    offs = np.cumsum([0] + [int(f.shape[0]) for f in fields])
    width = max(int(f.shape[1]) for f in fields)
    parts = [torch.nn.functional.pad(f, (0, width - f.shape[1]))
             if f.shape[1] < width else f for f in fields]
    tbl = (parts[0] if len(parts) == 1 else torch.cat(parts)
           ).float().contiguous()
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
