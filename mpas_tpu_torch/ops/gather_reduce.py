"""Kernel 2: stacked gather-reduce, out[s, k, r] = sum_m w[s, r, m] * tbl[k, idx[r, m]].

`gather_reduce` launches the CUDA kernels in csrc/gather_reduce.cu for
tensors on the card and runs `gather_reduce_plain` for tensors on the CPU.
It replaces the TPU kernel tools/windowed_kernels.py:windowed_reduce (and
covers tools/pallas_gather_probe.py:kern_c); the source note in the .cu file
says what bounds it on the H100 and what its two forms do about that.
`stencils.slot_reduce` is its one caller on the main path.

The two forms, both summing the slots in order m = 0..M-1:

  - `gather_reduce_direct`: gathers from the level-major table as it is. The
    form for index tables with locality (every table of a mesh).
  - `gather_reduce_rows`: transposes the table into scratch [N, Ktp] and reads
    one whole row per reference. The form for index tables that scatter.

`gather_reduce` picks between them from its operands alone, with
`row_form_gain`: `index_scatter` (the mean number of 32-byte sectors per slot
that the index tile of one warp, 32 consecutive rows, names; 32 when every
reference has a sector of its own; computed once per index tensor on the
host and kept in a small cache) over what the row-read form moves for the
same warp. `MeshArrays` computes the statistic for the mesh's tables when
it is made (`MeshArrays.gather_sectors`).
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WEIGHT_SETS = 4
SECTOR_BYTES = 32
WARP = 32

# `gather_reduce` takes the row-read form where `row_form_gain` is above
# this (and the table has a sector's worth of levels). Set from both forms
# timed in turns by chip_smoke.py (`gather_forms`; float32, device time, at
# x1.40962 with 41 levels) on an NVIDIA H100 80GB HBM3 at 700.00 W. The
# largest gain of a mesh's own table is 1.64 (edgesOnVertex on the
# ownership-aligned numbering): direct 0.041 ms, row-read 0.057. With 20% of
# edgesOnEdge's entries replaced by random ones the gain is 1.68: direct
# 0.231 ms, row-read 0.131; with 30%, 2.34: 0.319 against 0.136; at the
# probe's random indices, 7.3: 0.741 against 0.100. The model does not see
# the reuse between neighbouring warps that a mesh's numbering gives, so
# tables of equal gain fall on either side; the constant leans to the
# direct form, which every table of a mesh then takes.
ROW_FORM_MIN_GAIN = 2.0

# kernel launches since the counters were last set to 0: all of them, and
# those of the row-read form (its transpose and its reduction count one each)
launches = 0
row_form_launches = 0

SCATTER_CACHE_SIZE = 32
_scatter_cache: dict = {}


def gather_reduce_plain(tbl, idx, w):
    """The plain PyTorch version: tbl [Kt, N], idx [R, M], w [S, R, M] ->
    [S, Kt, R], summed over the slots in order m = 0..M-1."""
    acc = None
    for m in range(idx.shape[1]):
        g = torch.index_select(tbl, 1, idx[:, m])                 # [Kt, R]
        t = w[:, None, :, m] * g[None]
        acc = t if acc is None else acc + t
    return acc


def scatter_sectors(idx_np: np.ndarray, itemsize: int) -> float:
    """How far an index table scatters a warp's gathers: the number of
    distinct 32-byte sectors of a table row of `itemsize`-byte elements
    that the [32, M] index tile of 32 consecutive rows names, divided by
    M, as a mean over the warps of idx_np [R, M] (a last short warp counts
    with the rows it has). Between 1/M (the whole tile in one sector) and
    32 (every reference in a sector of its own). Sectors are counted over
    the tile, not slot by slot, because the slots of one warp find each
    other's sectors in the SM's cache."""
    per_sector = SECTOR_BYTES // itemsize
    R, M = idx_np.shape
    sec = np.asarray(idx_np, np.int64) // per_sector
    pad = -R % WARP
    if pad:                     # repeat the last row: no new sector
        sec = np.concatenate([sec, sec[-1:].repeat(pad, 0)], 0)
    s = np.sort(sec.reshape(-1, WARP * M), axis=1)
    distinct = 1 + (s[:, 1:] != s[:, :-1]).sum(axis=1)            # [warps]
    return float(distinct.mean()) / M


def index_scatter(idx, itemsize: int) -> float:
    """`scatter_sectors` of an index tensor, computed on the host the first
    time the tensor is seen and cached. The key is the tensor's identity
    (device, address, shape, row stride), not its content: hashing the
    content of a tensor on the card would cost a copy to the host per call.
    The entry holds the tensor, so its address cannot be handed to another
    tensor while the entry lives, and the tensor's version counter, so an
    in-place write recomputes."""
    key = (idx.device, idx.data_ptr(), tuple(idx.shape), idx.stride(0),
           itemsize)
    hit = _scatter_cache.get(key)
    if hit is not None and hit[1] == idx._version:
        return hit[2]
    value = scatter_sectors(idx.detach().cpu().numpy(), itemsize)
    _scatter_cache.pop(key, None)
    if len(_scatter_cache) >= SCATTER_CACHE_SIZE:
        _scatter_cache.pop(next(iter(_scatter_cache)))
    _scatter_cache[key] = (idx, idx._version, value)
    return value


def padded_levels(Kt: int, itemsize: int) -> int:
    """Row length of the transposed scratch: Kt rounded up so that every
    row starts on a 32-byte boundary."""
    per_sector = SECTOR_BYTES // itemsize
    return -(-Kt // per_sector) * per_sector


def transposed_scratch(tbl):
    """Uninitialised scratch [N, Ktp] for the transpose of tbl [Kt, N]."""
    Kt, N = tbl.shape
    return torch.empty((N, padded_levels(Kt, tbl.element_size())),
                       dtype=tbl.dtype, device=tbl.device)


def row_form_gain(sectors: float, itemsize: int, N: int, R: int,
                  M: int) -> float:
    """Sector traffic of the direct form over that of the row-read form, as
    modelled per warp of 32 rows and per level: the direct form fetches
    `sectors` * M sectors of 32 bytes; the row-read form reads 32 * M
    elements in full sectors and pays its share of transposing the table
    (N elements read and written, spread over R / 32 warps)."""
    return sectors / (itemsize * (1.0 + 2.0 * N / (R * M)))


def uses_row_form(tbl, idx) -> bool:
    """Whether `gather_reduce` sends tbl [Kt, N] with the index table idx
    [R, M] to the row-read form."""
    size = tbl.element_size()
    Kt, N = tbl.shape
    R, M = idx.shape
    return (Kt * size >= SECTOR_BYTES
            and row_form_gain(index_scatter(idx, size), size, N, R, M)
            > ROW_FORM_MIN_GAIN)


def _check(tbl, idx, w):
    """Raise on what the kernels do not take; (S, R, M, Kt, N) otherwise."""
    if tbl.device.type != "cuda":
        raise ValueError(f"gather_reduce: unsupported device {tbl.device}")
    S, R, M = w.shape
    Kt, N = tbl.shape
    if tbl.dtype not in (torch.float32, torch.float64) or w.dtype != tbl.dtype:
        raise TypeError(f"gather_reduce: tbl {tbl.dtype} and w {w.dtype} "
                        "must be one of float32/float64")
    if idx.dtype != torch.int32 or idx.shape != (R, M):
        raise TypeError(f"gather_reduce: idx must be int32 [{R}, {M}], got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if not (1 <= S <= MAX_WEIGHT_SETS):
        raise ValueError(f"gather_reduce: {S} weight sets (1..4 supported)")
    if min(Kt, N, R, M) < 1:
        raise ValueError(f"gather_reduce: empty operand, tbl {tuple(tbl.shape)}"
                         f", w {tuple(w.shape)}")
    for name, t in (("tbl", tbl), ("idx", idx), ("w", w)):
        if t.device != tbl.device:
            raise ValueError(f"gather_reduce: {name} on {t.device}, "
                             f"tbl on {tbl.device}")
    if not (tbl.is_contiguous() and w.is_contiguous() and idx.stride(1) == 1):
        raise ValueError("gather_reduce: tbl and w must be contiguous and "
                         "idx rows contiguous")
    return S, R, M, Kt, N


def _entry(name, dtype):
    from .. import cuda_build
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(cuda_build.library(), f"{name}_{suffix}")


def _direct(tbl, idx, w, dims):
    global launches
    from .. import cuda_build
    S, R, M, Kt, N = dims
    out = torch.empty((S, Kt, R), dtype=tbl.dtype, device=tbl.device)
    code = _entry("gather_reduce_direct", tbl.dtype)(
        tbl.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
        Kt, N, R, M, S, idx.stride(0),
        torch.cuda.current_stream(tbl.device).cuda_stream)
    cuda_build.check(code, "gather_reduce (direct form)")
    launches += 1
    return out


def _rows(tbl, idx, w, dims):
    global launches, row_form_launches
    from .. import cuda_build
    S, R, M, Kt, N = dims
    stream = torch.cuda.current_stream(tbl.device).cuda_stream
    tblT = transposed_scratch(tbl)
    Ktp = tblT.shape[1]
    code = _entry("transpose_table", tbl.dtype)(
        tbl.data_ptr(), tblT.data_ptr(), Kt, N, Ktp, stream)
    cuda_build.check(code, "gather_reduce (transpose)")
    launches += 1
    row_form_launches += 1
    out = torch.empty((S, Kt, R), dtype=tbl.dtype, device=tbl.device)
    code = _entry("gather_reduce_rows", tbl.dtype)(
        tblT.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
        Kt, Ktp, R, M, S, idx.stride(0), stream)
    cuda_build.check(code, "gather_reduce (row-read form)")
    launches += 1
    row_form_launches += 1
    return out


def gather_reduce_direct(tbl, idx, w):
    """The direct form on the card, whatever the index table (arguments as
    `gather_reduce`)."""
    return _direct(tbl, idx, w, _check(tbl, idx, w))


def gather_reduce_rows(tbl, idx, w):
    """The row-read form on the card, whatever the index table (arguments
    as `gather_reduce`): one launch transposes tbl into scratch [N, Ktp],
    one reduces from it."""
    return _rows(tbl, idx, w, _check(tbl, idx, w))


def gather_reduce(tbl, idx, w):
    """tbl [Kt, N] float, idx [R, M] int32 (rows may be strided, columns
    contiguous), w [S, R, M] with S <= 4 -> out [S, Kt, R]. The kernels
    do not bounds-check idx: its entries must lie in [0, N), as
    `MeshArrays` checks for the mesh's tables when it is made."""
    if tbl.device.type == "cpu":
        return gather_reduce_plain(tbl, idx, w)
    dims = _check(tbl, idx, w)
    if uses_row_form(tbl, idx):
        return _rows(tbl, idx, w, dims)
    return _direct(tbl, idx, w, dims)
