"""The stacked gather-reduce, out[s, k, r] = sum_m w[s, r, m] * tbl[k, idx[r, m]],
as plain PyTorch: the slots summed in order m = 0..M-1."""

from __future__ import annotations

import torch


def gather_reduce_plain(tbl, idx, w):
    """The plain PyTorch version: tbl [Kt, N], idx [R, M], w [S, R, M] ->
    [S, Kt, R], summed over the slots in order m = 0..M-1."""
    acc = None
    for m in range(idx.shape[1]):
        g = torch.index_select(tbl, 1, idx[:, m])                 # [Kt, R]
        t = w[:, None, :, m] * g[None]
        acc = t if acc is None else acc + t
    return acc


gather_reduce = gather_reduce_plain
