"""Carry a model's containers across from numpy: `from_jax_numpy`.

The model has no learned weights; what a run starts from is the mesh
arrays, the vertical metrics, the static fields and the state. This module
turns them, given as dicts of numpy arrays (one entry per field of
`mpas_tpu`'s MeshArrays / VerticalArrays / StaticState / State, taken with
`np.asarray` on the JAX side), into this package's containers on a given
device. It imports nothing of `mpas_tpu`: the caller does the `np.asarray`.

A domain-decomposed model keeps mpas_tpu's sharded layout at its files and
its boundaries: every per-entity array as [S, ..., L] blocks, one per
shard, each padded to the largest local count L. `stack_blocks` and
`split_blocks` turn that layout into the stacked one of
parallel/sharded.py's in-process back end, where the S blocks lie side by
side on the entity axis ([..., S*L]), and back; the distributed back end
holds block r on rank r.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import state as core_state


def _convert(cls, arrays: dict, dtype, device):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"{cls.__name__}.{f.name} missing from the "
                               "arrays given")
            continue
        a = arrays[f.name]
        if a is None or (np.ndim(a) == 0 and np.asarray(a).dtype == np.bool_):
            # a flag such as owner_aligned, given as a bool or a 0-d array
            kw[f.name] = None if a is None else bool(a)
        elif np.issubdtype(np.asarray(a).dtype, np.integer):
            kw[f.name] = core_state.to_index(a, device)
        else:
            kw[f.name] = core_state.to_float(a, dtype, device)
    return cls(**kw)


def from_jax_numpy(mesh_arrays: dict, vert: dict, static: dict, state: dict,
                   device="cuda", dtype=torch.float32):
    """Returns (MeshArrays, VerticalArrays, StaticState, State) on `device`
    in `dtype` (index tables int32), the cell-form tables, `scalars`
    [nS, K, C] and `rainnc` [C] included (None stays None). Keys the port's
    containers do not have are ignored; a missing field raises."""
    return (_convert(core_state.MeshArrays, mesh_arrays, dtype, device),
            _convert(core_state.VerticalArrays, vert, dtype, device),
            _convert(core_state.StaticState, static, dtype, device),
            _convert(core_state.State, state, dtype, device))


def stack_blocks(blocks):
    """[S, ..., L] per-shard blocks (numpy or torch) -> [..., S*L], the S
    blocks side by side on the last axis."""
    if torch.is_tensor(blocks):
        x = torch.movedim(blocks, 0, -2)
    else:
        x = np.moveaxis(np.asarray(blocks), 0, -2)
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def split_blocks(x, n_shards: int):
    """[..., S*L] -> [S, ..., L]: the inverse of stack_blocks."""
    L = x.shape[-1] // n_shards
    x = x.reshape(tuple(x.shape[:-1]) + (n_shards, L))
    if torch.is_tensor(x):
        return torch.movedim(x, -2, 0)
    return np.moveaxis(x, -2, 0)
