"""Kernel 4: column gather, out[k, r] = tbl[k, idx[r]].

`take_columns` launches the CUDA kernels in csrc/take_columns.cu for tensors
on the card and runs `take_columns_plain` (`torch.index_select`) for
tensors on the CPU. It replaces the TPU kernels
tools/pallas_gather_probe.py:kern_a and :kern_b, which compute this one
function; `probes.gather_probe` runs it. The main path's gathers
(`stencils.take_packed`) stay `torch.index_select`, as the JAX package
leaves them to XLA.

The two forms, bit-equal to each other and to `index_select`:

  - `take_columns_direct`: gathers from the level-major table as it is. The
    form for index vectors with locality (every index vector of a mesh).
  - `take_columns_rows`: transposes the table into scratch [N, Ktp]
    (Kernel 2's transpose) and reads one whole row per output column. The
    form for index vectors that scatter.

`take_columns` picks between them from its operands alone, as Kernel 2's
wrapper does: `index_scatter` of the index vector seen as [R, 1] and
`row_form_gain` with one slot (ops/gather_reduce.py).
"""

from __future__ import annotations

import torch

from . import gather_reduce as gr

# `take_columns` takes the row-read form where `row_form_gain` (one slot) is
# above this (and the table has a sector's worth of levels). Set from both
# forms timed in turns by chip_smoke.py (`take_forms`; device time, K = 83,
# N = 40962, R = 122880) on an NVIDIA H100 80GB HBM3 at 700.00 W. The
# row-read form takes the same time whatever the indices; the direct form
# takes 0.025 ms at cellsOnEdge[:, 0] (gain 0.34), 0.037 with 30% of its
# entries replaced by random ones (gain 1.77), 0.051 with 50% (gain 2.73,
# level with the row-read form) and 0.084 at the probe's random indices
# (gain 4.79). In float64 random indices have gain 2.40 and the row-read
# form still wins there (0.078 against 0.093), so the constant sits under
# that and over every index vector of a mesh (at most 1.42: float32,
# cellsOnEdge[:, 1] on the ownership-aligned numbering of x1.40962).
ROW_FORM_MIN_GAIN = 2.2

# kernel launches since the counters were last set to 0: all of them, and
# those of the row-read form (its transpose and its row pass count one each)
launches = 0
row_form_launches = 0


def take_columns_plain(tbl, idx):
    """The plain PyTorch version: tbl [K, N], idx [R] -> [K, R]."""
    return torch.index_select(tbl, 1, idx)


def index_gain(tbl, idx) -> float:
    """`row_form_gain` of gathering tbl [K, N] at idx [R]: the index vector
    is an index table of one slot."""
    size = tbl.element_size()
    return gr.row_form_gain(gr.index_scatter(idx.unsqueeze(1), size), size,
                            tbl.shape[1], idx.shape[0], 1)


def uses_row_form(tbl, idx) -> bool:
    """Whether `take_columns` sends tbl [K, N] with the index vector idx [R]
    to the row-read form."""
    return (tbl.shape[0] * tbl.element_size() >= gr.SECTOR_BYTES
            and index_gain(tbl, idx) > ROW_FORM_MIN_GAIN)


def _check(tbl, idx):
    """Raise on what the kernels do not take; (K, N, R) otherwise."""
    if tbl.device.type != "cuda":
        raise ValueError(f"take_columns: unsupported device {tbl.device}")
    if tbl.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"take_columns: tbl {tbl.dtype} must be float32 or "
                        "float64")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"take_columns: idx must be int32 [R], got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != tbl.device:
        raise ValueError(f"take_columns: idx on {idx.device}, tbl on "
                         f"{tbl.device}")
    if not (tbl.dim() == 2 and tbl.is_contiguous()):
        raise ValueError("take_columns: tbl must be a contiguous [K, N]")
    K, N = tbl.shape
    R = idx.shape[0]
    if min(K, N, R) < 1 or idx.stride(0) < 1:
        raise ValueError(f"take_columns: empty operand, tbl {tuple(tbl.shape)}"
                         f", idx {tuple(idx.shape)} (stride {idx.stride(0)})")
    return K, N, R


def _entry(name, dtype):
    from .. import cuda_build
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(cuda_build.library(), f"{name}_{suffix}")


def _direct(tbl, idx, dims):
    global launches
    from .. import cuda_build
    K, N, R = dims
    out = torch.empty((K, R), dtype=tbl.dtype, device=tbl.device)
    code = _entry("take_columns_direct", tbl.dtype)(
        tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), K, N, R,
        idx.stride(0), torch.cuda.current_stream(tbl.device).cuda_stream)
    cuda_build.check(code, "take_columns (direct form)")
    launches += 1
    return out


def _rows(tbl, idx, dims):
    global launches, row_form_launches
    from .. import cuda_build
    K, N, R = dims
    stream = torch.cuda.current_stream(tbl.device).cuda_stream
    tblT = gr.transposed_scratch(tbl)
    Ktp = tblT.shape[1]
    code = _entry("transpose_table", tbl.dtype)(
        tbl.data_ptr(), tblT.data_ptr(), K, N, Ktp, stream)
    cuda_build.check(code, "take_columns (transpose)")
    launches += 1
    row_form_launches += 1
    out = torch.empty((K, R), dtype=tbl.dtype, device=tbl.device)
    code = _entry("take_columns_rows", tbl.dtype)(
        tblT.data_ptr(), idx.data_ptr(), out.data_ptr(), K, Ktp, R,
        idx.stride(0), stream)
    cuda_build.check(code, "take_columns (row-read form)")
    launches += 1
    row_form_launches += 1
    return out


def take_columns_direct(tbl, idx):
    """The direct form on the card, whatever the index vector (arguments as
    `take_columns`)."""
    return _direct(tbl, idx, _check(tbl, idx))


def take_columns_rows(tbl, idx):
    """The row-read form on the card, whatever the index vector (arguments
    as `take_columns`): one launch transposes tbl into scratch [N, Ktp], one
    gathers whole rows from it."""
    return _rows(tbl, idx, _check(tbl, idx))


def take_columns(tbl, idx):
    """tbl [K, N] float32/float64 (contiguous), idx [R] int32 (any positive
    stride) -> [K, R]. The kernels do not bounds-check idx: its entries must
    lie in [0, N), as `MeshArrays` checks for the mesh's tables when it is
    made."""
    if tbl.device.type == "cpu":
        return take_columns_plain(tbl, idx)
    dims = _check(tbl, idx)
    if uses_row_form(tbl, idx):
        return _rows(tbl, idx, dims)
    return _direct(tbl, idx, dims)
