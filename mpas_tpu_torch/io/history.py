"""History and restart I/O.

The port of `mpas_tpu.io.history`, which rebuilds the reference's
write_output_plotting (mesh_loading.rg:810-1191) — which wrote only level-0
slices of 8 fields — as a full-field netCDF history writer compatible with
the reference's plotting scripts, plus an exact restart capability (absent
in the reference; SURVEY.md section 5).

The files are mpas_tpu's, field for field: the history is netCDF classic
through mesh/netcdf_io.py (scipy), the restart an `.npz` of every state
field in its level-major [K, N] layout with the same markers. The State of
this package has mpas_tpu's fields, so a checkpoint written by either
package restores into the other. A sharded model (parallel/sharded.py)
writes and reads mpas_tpu's sharded layout: every field as [S, ..., L]
blocks plus the `__n_shards__` marker, whichever back end holds it; its
stacked layout is reshaped at this file boundary only. `save_restart_torch`
/ `load_restart_torch` write the same payload with `torch.save` (mpas_tpu
writes it with orbax).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh.netcdf_io import write_netcdf
from ..ops import diagnostics as diag_ops

# fields written for plotting parity with the reference writer
# (mesh_loading.rg:810-1191): u, v, w, pressure, pressure_p, rho, theta,
# surface_pressure + mesh coordinates
PLOT_LEVEL = 0

# restart state-array layout: 1 = level-major [K, N] (mpas_tpu round 3+)
RESTART_LAYOUT_VERSION = 1


def _host(t):
    return t.detach().cpu().numpy()


def _snapshot_fields(model, state, full_3d: bool):
    """One time level of history fields (host numpy dict).

    Device fields are level-major [K, N] (core/state.py); the file keeps the
    reference's element-major [nCells, nVertLevels] convention, so each
    field transposes at this host boundary."""
    out = diag_ops.output_diagnostics(state, model.static)
    pressure = _host(out["pressure"]).T                   # [C, K]
    vg = model.vgrid
    sp = (vg.cf1 * pressure[:, 0] + vg.cf2 * pressure[:, 1]
          + vg.cf3 * pressure[:, 2])
    K = pressure.shape[1]
    tr = lambda a: _host(a).T
    sl = (lambda a: a) if full_3d else (lambda a: a[:, PLOT_LEVEL:PLOT_LEVEL + 1])
    return {
        "u": sl(tr(state.u)), "v": sl(tr(state.v)),
        "w": sl(tr(state.w)[:, :K]),
        "rho": sl(tr(out["rho"])),
        "theta": sl(tr(out["theta"])),
        "pressure": sl(pressure),
        "pressure_p": sl(tr(state.pressure_p)),
        "surface_pressure": sp,
    }


_STATE_DIM = {"u": "nEdges", "v": "nEdges"}


def write_history(path: str, model, state=None, full_3d: bool = False,
                  snapshots=None):
    """Write a timestep_output.nc-style history file.

    With full_3d=False matches the reference writer's level-0 2-D slices;
    with full_3d=True writes complete [nCells, nVertLevels] fields.
    `snapshots`: optional list of (time_value, fields-dict from
    `_snapshot_fields`) — a multi-time-level history (HistoryWriter);
    default is one snapshot of the given/current state."""
    m = model.mesh
    if snapshots is None:
        state = state if state is not None else model.state
        snapshots = [(float(getattr(model, "step_count", 0)),
                      _snapshot_fields(model, state, full_3d))]
    T = len(snapshots)
    K = model.state.theta_m.shape[0]
    dims = {
        "Time": T, "nCells": m.nCells, "nEdges": m.nEdges,
        "nVertices": m.nVertices, "maxEdges": m.maxEdges,
        "vertexDegree": m.vertexDegree, "nVertLevels": K,
        "nVertLevelsP1": K + 1,
    }
    kdim = ("nVertLevels",) if full_3d else ("one",)
    if not full_3d:
        dims["one"] = 1

    variables = {
        # mesh (for the plotting scripts' patch construction)
        "latCell": (("nCells",), m.latCell),
        "lonCell": (("nCells",), m.lonCell),
        "latVertex": (("nVertices",), m.latVertex),
        "lonVertex": (("nVertices",), m.lonVertex),
        "nEdgesOnCell": (("nCells",), m.nEdgesOnCell.astype(np.int32)),
        "verticesOnCell": (("nCells", "maxEdges"),
                           (m.verticesOnCell + 1).astype(np.int32)),
        "areaCell": (("nCells",), m.areaCell),
        "xtime": (("Time",), np.array([t for t, _ in snapshots])),
    }
    for name in snapshots[0][1]:
        stacked = np.stack([f[name] for _, f in snapshots])   # [T, ...]
        d0 = _STATE_DIM.get(name, "nCells")
        dnames = ("Time", d0) + (() if stacked.ndim == 2 else kdim)
        variables[name] = (dnames, stacked)
    write_netcdf(path, dims, variables,
                 attrs={"on_a_sphere": b"YES", "sphere_radius": m.sphere_radius})
    return path


class HistoryWriter:
    """Accumulates per-interval snapshots during a run and writes one
    multi-time-level history file — the time-series capability the
    reference's single-snapshot write_output_plotting lacks."""

    def __init__(self, model, full_3d: bool = False):
        self.model = model
        self.full_3d = full_3d
        self.snapshots = []

    def record(self, state=None, time_value=None):
        state = state if state is not None else self.model.state
        t = (time_value if time_value is not None
             else float(getattr(self.model, "step_count", len(self.snapshots))))
        self.snapshots.append(
            (t, _snapshot_fields(self.model, state, self.full_3d)))

    def write(self, path: str):
        return write_history(path, self.model, full_3d=self.full_3d,
                             snapshots=self.snapshots)


def _payload(model) -> dict:
    """Every state field that is set (host numpy; a sharded model's as
    [S, ..., L] blocks), the step counter, the layout marker and, for a
    sharded model, its shard count."""
    if hasattr(model, "state_blocks"):
        arrays = model.state_blocks()
    else:
        arrays = {f.name: _host(getattr(model.state, f.name))
                  for f in dataclasses.fields(model.state)
                  if getattr(model.state, f.name) is not None}
    arrays["__step_count__"] = np.asarray(model.step_count)
    # layout/version marker: state arrays are level-major [K, N];
    # load_restart refuses files without it so an element-major checkpoint
    # fails loudly instead of loading transposed fields
    arrays["__layout__"] = np.asarray(RESTART_LAYOUT_VERSION)
    n_shards = getattr(model, "n_shards", 0)
    if n_shards:
        arrays["__n_shards__"] = np.asarray(n_shards)
    return arrays


def _check_markers(path, layout, ck_shards, model):
    if layout != RESTART_LAYOUT_VERSION:
        raise ValueError(
            f"restart file {path} has state layout version {layout} "
            f"(0 = pre-level-major, unmarked); this build reads version "
            f"{RESTART_LAYOUT_VERSION} (level-major [K, N] state). "
            f"Regenerate the checkpoint with save_restart.")
    mdl_shards = getattr(model, "n_shards", 0)
    if ck_shards != mdl_shards:
        raise ValueError(
            f"checkpoint written with {ck_shards or 'no'} shards cannot "
            f"restore into a model with {mdl_shards or 'no'} shards")


def _write(model, write):
    """Run write() in the one process that writes a run's files (under
    torch.distributed rank 0, the others waiting for it)."""
    if getattr(model, "is_writer", True):
        write()
    if hasattr(model, "barrier"):
        model.barrier()


def save_restart(path: str, model):
    """Exact-restart checkpoint: every prognostic/persistent state field plus
    the step counter, as a compressed npz (host-side), in mpas_tpu's format
    (a sharded model's state as [S, ..., L] blocks with its shard-count
    marker; under torch.distributed every rank calls it, rank 0 writes)."""
    payload = _payload(model)
    _write(model, lambda: np.savez_compressed(path, **payload))
    return path


def load_restart(path: str, model):
    """Restore a checkpoint written by save_restart, of this package or of
    mpas_tpu (bitwise exact), onto the model's device and dtype."""
    with np.load(path) as f:
        data = dict(f)
    _check_markers(path, int(data.get("__layout__", 0)),
                   int(data.get("__n_shards__", 0)), model)
    model.state = model.state.replace(**_restored_updates(path, data, model))
    model.step_count = int(data["__step_count__"])
    return model


def _restored_updates(path, data, model):
    """Map checkpoint fields onto the model's state fields, rejecting fields
    the restoring configuration has disabled (None) with a config-mismatch
    error, and fields whose shape differs (a sharded model's: its
    [S, ..., L] blocks)."""
    sharded = hasattr(model, "from_blocks")
    updates = {}
    for f in dataclasses.fields(model.state):
        if f.name in data:
            cur = getattr(model.state, f.name)
            if cur is None:
                raise ValueError(
                    f"checkpoint {path} carries field '{f.name}' but the "
                    f"restoring model has it disabled (None) — config "
                    f"mismatch (e.g. a moist checkpoint into a dry model)")
            arr = np.asarray(data[f.name])
            expect = (model.block_shape(f.name) if sharded
                      else tuple(cur.shape))
            if arr.shape != expect:
                raise ValueError(
                    f"checkpoint {path} field '{f.name}' has shape "
                    f"{arr.shape} but the restoring model expects "
                    f"{expect} — mesh/levels mismatch, or the edge "
                    f"numbering differs (config_orient_edges checkpoints "
                    f"are not interchangeable with the default numbering)")
            updates[f.name] = (model.from_blocks(arr, cur) if sharded else
                               torch.as_tensor(arr).to(
                                   device=cur.device, dtype=cur.dtype
                               ).contiguous())
    return updates


def gathered_state(sm, model):
    """Global State assembled from a ShardedModel's owned entries (for
    history output of sharded runs), on the model's device."""
    g = sm.gather_state(model.mesh)
    updates = {}
    for k, v in g.items():
        if v is not None:
            cur = getattr(model.state, k)
            updates[k] = torch.from_numpy(v).to(device=cur.device,
                                                dtype=cur.dtype)
    return model.state.replace(**updates)


def save_restart_torch(path: str, model):
    """save_restart's payload written with `torch.save` (state fields as CPU
    tensors): this package's counterpart of mpas_tpu's
    `save_restart_orbax`."""
    payload = {k: torch.from_numpy(v) for k, v in _payload(model).items()}
    _write(model, lambda: torch.save(payload, path))
    return path


def load_restart_torch(path: str, model):
    """Restore a save_restart_torch checkpoint (bitwise exact), with the
    same layout/shard-count validation as the npz reader: the counterpart
    of mpas_tpu's `load_restart_orbax`."""
    data = {k: v.numpy() for k, v in
            torch.load(path, map_location="cpu", weights_only=True).items()}
    _check_markers(path, int(data.get("__layout__", 0)),
                   int(data.get("__n_shards__", 0)), model)
    model.state = model.state.replace(**_restored_updates(path, data, model))
    model.step_count = int(data["__step_count__"])
    return model
