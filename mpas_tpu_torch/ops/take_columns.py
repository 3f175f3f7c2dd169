"""Kernel 4: column gather, out[k, r] = tbl[k, idx[r]].

`take_columns` launches the CUDA kernel in csrc/take_columns.cu for tensors
on the card and runs `take_columns_plain` (`torch.index_select`) for
tensors on the CPU. It replaces the TPU kernels
tools/pallas_gather_probe.py:kern_a and :kern_b, which compute this one
function; `probes.gather_probe` runs it. The main path's gathers
(`stencils.take_packed`) stay `torch.index_select`, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import torch

# kernel launches since the counter was last set to 0
launches = 0


def take_columns_plain(tbl, idx):
    """The plain PyTorch version: tbl [K, N], idx [R] -> [K, R]."""
    return torch.index_select(tbl, 1, idx)


def take_columns(tbl, idx):
    """tbl [K, N] float32/float64 (contiguous), idx [R] int32 -> [K, R].
    The kernel does not bounds-check idx: its entries must lie in [0, N),
    as `MeshArrays` checks for the mesh's tables when it is made."""
    if tbl.device.type == "cpu":
        return take_columns_plain(tbl, idx)
    if tbl.device.type != "cuda":
        raise ValueError(f"take_columns: unsupported device {tbl.device}")
    global launches
    from .. import cuda_build

    if tbl.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"take_columns: tbl {tbl.dtype} must be float32 or "
                        "float64")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"take_columns: idx must be int32 [R], got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != tbl.device:
        raise ValueError(f"take_columns: idx on {idx.device}, tbl on "
                         f"{tbl.device}")
    if not (tbl.dim() == 2 and tbl.is_contiguous() and idx.is_contiguous()):
        raise ValueError("take_columns: tbl must be a contiguous [K, N] and "
                         "idx a contiguous [R]")
    K, N = tbl.shape
    R = idx.shape[0]
    out = torch.empty((K, R), dtype=tbl.dtype, device=tbl.device)
    lib = cuda_build.library()
    fn = lib.take_columns_f32 if tbl.dtype == torch.float32 else lib.take_columns_f64
    code = fn(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), K, N, R,
              torch.cuda.current_stream(tbl.device).cuda_stream)
    cuda_build.check(code, "take_columns")
    launches += 1
    return out
