"""Sharded model assembly: global arrays -> per-shard local blocks -> the
SRK3 step with halo exchanges.

The port of `mpas_tpu.parallel.sharded`. The horizontal domain is split
into shards (parallel/partition.py); each shard holds its owned entities
plus a 3-ring halo, the unchanged single-device operators run over the
local blocks, and parallel/halo.py refreshes the halos at the exchange
points of dynamics/srk3.py. Two back ends, one ShardedModel:

  - stacked (in process, the default): the S local blocks lie side by side
    on the entity axis of every array ([K, S*L]) on the model's device, and
    every local index of shard s in the adjacency tables is offset by s*L
    (the 0 that partition.remap gives a missing neighbour and the global-0
    padding of l2g included), so each shard reads only its own block, as
    under mpas_tpu's shard_map. The mesh is block-diagonal and one step
    advances all shards;
  - distributed: when torch.distributed is initialized with world size
    n_shards, rank r holds block r ([K, L]) on its own device and the
    exchanges are collectives (gloo on the CPU, NCCL on cards).

At its boundaries (checkpoints, gather_state, the summarize oracle) a
ShardedModel speaks mpas_tpu's layout: [S, ..., L] blocks, one per shard.
The local meshes are always built with owner_aligned=False: the global
slot-major invariant of an ownership-aligned numbering does not survive
the local remap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import state as core_state
from ..dynamics import srk3
from ..weights import split_blocks, stack_blocks
from . import partition as part_mod
from .halo import ExchangeArrays, ExchangeRound, HaloExchange, HaloTables

# field -> (entity of its first axis, remap target for index arrays or None)
_MESH_FIELDS = {
    "cellsOnEdge": ("edge", "cell"), "verticesOnEdge": ("edge", "vertex"),
    "edgesOnCell": ("cell", "edge"), "cellsOnCell": ("cell", "cell"),
    "verticesOnCell": ("cell", "vertex"),
    "edgesOnCell_mask": ("cell", None), "edgesOnCellSign": ("cell", None),
    "cellsOnVertex": ("vertex", "cell"), "edgesOnVertex": ("vertex", "edge"),
    "edgesOnVertexSign": ("vertex", None),
    "edgesOnEdge": ("edge", "edge"), "edgesOnEdge_mask": ("edge", None),
    "weightsOnEdge": ("edge", None),
    "kiteForCell": ("cell", None), "kiteAreasOnVertex": ("vertex", None),
    "latCell": ("cell", None), "lonCell": ("cell", None),
    "latEdge": ("edge", None), "lonEdge": ("edge", None),
    "angleEdge": ("edge", None), "dvEdge": ("edge", None),
    "dcEdge": ("edge", None), "invDvEdge": ("edge", None),
    "invDcEdge": ("edge", None), "areaCell": ("cell", None),
    "invAreaCell": ("cell", None), "invAreaTriangle": ("vertex", None),
    "meshScalingDel2": ("edge", None), "meshScalingDel4": ("edge", None),
    "meshScalingRegionalCell": ("cell", None),
    "meshScalingRegionalEdge": ("edge", None),
    "bdyMaskCell": ("cell", None), "bdyMaskEdge": ("edge", None),
    "advCellsForEdge": ("edge", "cell"), "advMaskForEdge": ("edge", None),
    "adv_coefs": ("edge", None), "adv_coefs_3rd": ("edge", None),
    "dirHess": ("cell", None), "tanWeights": ("cell", None),
    "slotOnCell": ("edge", None),
    "coeffs_reconstruct": ("cell", None), "defc_a": ("cell", None),
    "defc_b": ("cell", None), "fEdge": ("edge", None), "fVertex": ("vertex", None),
}
# slot-major coefficient tables carry the entity on their LAST axis;
# adjacency and weights keep it on axis 0
_LAST_AXIS_MESH = {"dirHess", "tanWeights"}

_STATIC_ENTITY = {
    "zgrid": "cell", "zz": "cell", "dss": "cell", "zxu": "edge",
    "zb_cell": "cell", "zb3_cell": "cell", "rho_base": "cell",
    "theta_base": "cell", "rtheta_base": "cell", "exner_base": "cell",
    "pressure_base": "cell", "t_init": "cell",
}


def _state_entity(name: str, C: int, E: int, V: int, arr) -> str:
    n = arr.shape[-1]          # level-major layout: entity axis is LAST
    if n == C:
        return "cell"
    if n == E:
        return "edge"
    if n == V:
        return "vertex"
    raise ValueError(f"cannot classify state field {name} with trailing dim {n}")


def _host(t):
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class ShardedModel:
    n_shards: int
    partition: part_mod.ShardedPartition
    mesh_arrays: Any      # MeshArrays over the local blocks
    static: Any           # StaticState, the same layout
    vert: Any             # the model's VerticalArrays (replicated)
    tables: Any           # HaloTables
    state: Any            # State, [..., S*L] (stacked) or [..., L] (rank)
    namelist: Any
    entities: dict        # state field -> "cell" | "edge" | "vertex"
    rank: Optional[int] = None    # None: stacked; else this process's shard
    step_fn: Callable = None
    summarize_fn: Callable = None
    radiation_fn: Callable = None
    step_count: int = 0

    def step(self, n: int = 1):
        for _ in range(n):
            self.state = self.step_fn(self.state)
            self.step_count += 1
        return self.state

    @property
    def dtype(self):
        return self.state.theta_m.dtype

    @property
    def device(self):
        return self.state.theta_m.device

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the files of a sharded run (rank 0,
        or the one process of the stacked back end)."""
        return self.rank in (None, 0)

    def barrier(self):
        if self.distributed:
            import torch.distributed as dist
            dist.barrier()

    def apply_physics(self, phys, julian: float | None = None):
        """Sharded physics coupling: the columnar radiation runs on the local
        columns, halo columns included, so no exchange is needed, and writes
        rt_diabatic_tend."""
        from ..physics.driver import time_params
        if julian is None:
            julian = self.step_count * self.namelist.config_dt / 86400.0
        if self.radiation_fn is None:
            raise RuntimeError("call enable_physics(phys) first")
        tp = time_params(phys, julian, self.dtype, self.device)
        rthraten = self.radiation_fn(self.state, tp)
        self.state = self.state.replace(
            rt_diabatic_tend=rthraten.contiguous().to(self.dtype))

    def enable_physics(self, phys):
        if self.radiation_fn is None:
            self.radiation_fn = make_sharded_radiation(self, phys)

    # ---- mpas_tpu's [S, ..., L] block layout ----

    def blocks(self, x):
        """One local tensor -> its [S, ..., L] blocks, host numpy (under
        torch.distributed a collective: every rank gets every block)."""
        if not self.distributed:
            return _host(split_blocks(x, self.n_shards))
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        dist.all_gather(parts, x)
        return np.stack([_host(t) for t in parts])

    def from_blocks(self, blocks, like):
        """[S, ..., L] blocks -> the local tensor, as `like` (device, dtype)."""
        blocks = np.asarray(blocks)
        local = blocks[self.rank] if self.distributed else stack_blocks(blocks)
        return torch.as_tensor(np.ascontiguousarray(local)).to(
            device=like.device, dtype=like.dtype)

    def state_blocks(self) -> dict:
        """Every state field that is set as [S, ..., L] blocks (host)."""
        return {f.name: self.blocks(getattr(self.state, f.name))
                for f in dataclasses.fields(self.state)
                if getattr(self.state, f.name) is not None}

    def block_shape(self, name: str) -> tuple:
        """The [S, ..., L] shape of a state field's blocks."""
        x = getattr(self.state, name)
        l2g = getattr(self.partition, f"{self.entities[name]}_l2g")
        return (self.n_shards,) + tuple(x.shape[:-1]) + (l2g.shape[1],)

    def gather_state(self, model_mesh) -> dict:
        """Collect owned entries back into global arrays (host numpy;
        under torch.distributed a collective, and every rank gets them)."""
        p = self.partition
        sizes = {"cell": model_mesh.nCells, "edge": model_mesh.nEdges,
                 "vertex": model_mesh.nVertices}
        out = {}
        for f in dataclasses.fields(self.state):
            x = getattr(self.state, f.name)
            if x is None:
                out[f.name] = None
                continue
            x = self.blocks(x)
            ent = self.entities[f.name]
            l2g = getattr(p, f"{ent}_l2g")
            om = getattr(p, f"{ent}_owned_mask")
            g = np.zeros(x.shape[1:-1] + (sizes[ent],), x.dtype)
            for s in range(self.n_shards):
                sel = om[s] > 0
                g[..., l2g[s][sel]] = x[s][..., sel]
            out[f.name] = g
        return out


def stacked_source(xt: part_mod.ExchangeTable, L: int, mode: str) -> np.ndarray:
    """The stacked back end's source vector [S*L] of one entity type: slot
    s*L + j reads slot src[s*L + j], itself except where j is a halo slot
    of shard s, which reads its owner's slot d*L + (the owner's local
    index). Built from the plan a distributed run would use: the
    ppermute rounds for "ppermute", the all-pairs table otherwise."""
    S = xt.recv_pos.shape[0]
    src = np.arange(S * L, dtype=np.int64)
    if mode == "ppermute" and xt.rounds:
        for r in xt.rounds:
            for d, s in r["perm"]:
                keep = r["recv_slot"][s] < L
                src[s * L + r["recv_slot"][s][keep]] = (
                    d * L + r["send_idx"][d][keep])
    else:
        s_idx, slot = np.nonzero(xt.recv_is_halo > 0)
        d, pos = np.divmod(xt.recv_pos[s_idx, slot], xt.max_send)
        src[s_idx * L + slot] = d * L + xt.send_idx[d, s_idx, pos]
    return src.astype(np.int32)


def _exchange_arrays(xt, L, mode, rank, dtype, device) -> ExchangeArrays:
    idx = lambda a: core_state.to_index(a, device)
    if rank is None:
        return ExchangeArrays(n_halo=int(np.sum(xt.recv_is_halo > 0)),
                              source=idx(stacked_source(xt, L, mode)))
    n_halo = int(np.sum(xt.recv_is_halo[rank] > 0))
    if mode == "ppermute" and xt.rounds:
        rounds = []
        for r in xt.rounds:
            keep = np.nonzero(r["recv_slot"][rank] < L)[0]
            rounds.append(ExchangeRound(
                perm=tuple((int(d), int(t)) for d, t in r["perm"]),
                send_idx=idx(r["send_idx"][rank]),
                send_mask=core_state.to_float(r["send_mask"][rank], dtype,
                                              device),
                recv_cols=torch.from_numpy(keep).to(device),
                recv_slot=torch.from_numpy(
                    r["recv_slot"][rank][keep].astype(np.int64)).to(device)))
        return ExchangeArrays(n_halo=n_halo, rounds=tuple(rounds))
    return ExchangeArrays(
        n_halo=n_halo, send_idx=idx(xt.send_idx[rank]),
        send_mask=core_state.to_float(xt.send_mask[rank], dtype, device),
        recv_pos=idx(xt.recv_pos[rank]),
        recv_is_halo=core_state.to_float(xt.recv_is_halo[rank], dtype, device))


def shard_model(model, n_shards: int,
                metis_path: str | None = None) -> ShardedModel:
    """Build a ShardedModel from a (single-device) Model: the stacked back
    end on the model's device, or the distributed one when torch.distributed
    is initialized with world size n_shards (every rank builds the same
    partition from its own copy of the model and keeps its block)."""
    import torch.distributed as dist
    distributed = (dist.is_available() and dist.is_initialized()
                   and dist.get_world_size() == n_shards)
    rank = dist.get_rank() if distributed else None
    mesh = model.mesh
    nl = model.namelist
    dtype, dev = model.dtype, model.device
    p = part_mod.build_partition(mesh, n_shards, metis_path=metis_path)
    S = n_shards
    C, E, V = mesh.nCells, mesh.nEdges, mesh.nVertices

    l2g = {"cell": p.cell_l2g, "edge": p.edge_l2g, "vertex": p.vertex_l2g}
    g2l = {"cell": p.cell_g2l, "edge": p.edge_g2l, "vertex": p.vertex_g2l}
    L = {k: v.shape[1] for k, v in l2g.items()}

    def shard_field(arr, entity, remap_to=None, axis=0):
        """The local array of a global one: per-shard blocks ([S, L, ...]
        with the entity on axis 0, [S, ..., L] on the last), index entries
        remapped to local slots (offset by s*L in the stacked layout), then
        the blocks side by side (stacked) or this rank's block."""
        if axis == 0:
            out = arr[l2g[entity]]                   # [S, L, ...]
        else:
            out = np.moveaxis(np.take(arr, l2g[entity], axis=-1), -2, 0)
        if remap_to is not None:
            res = np.empty_like(out)
            for s in range(S):
                res[s] = part_mod.remap(g2l[remap_to][s], out[s])
                if rank is None:
                    res[s] += s * L[remap_to]
            out = res
        if rank is not None:
            return out[rank]
        if axis == 0:
            return out.reshape((S * out.shape[1],) + out.shape[2:])
        return stack_blocks(out)

    def put(a):
        if np.issubdtype(a.dtype, np.integer):
            return core_state.to_index(a, dev)
        return core_state.to_float(a, dtype, dev)

    marr = core_state.MeshArrays(
        **{name: put(shard_field(_host(getattr(model.mesh_arrays, name)),
                                 entity, remap_to,
                                 -1 if name in _LAST_AXIS_MESH else 0))
           for name, (entity, remap_to) in _MESH_FIELDS.items()},
        owner_aligned=False)
    static = core_state.StaticState(
        **{name: put(shard_field(_host(getattr(model.static, name)), ent,
                                 axis=-1))
           for name, ent in _STATIC_ENTITY.items()})
    entities, state_kw = {}, {}
    for f in dataclasses.fields(model.state):
        x = getattr(model.state, f.name)
        if x is None:
            state_kw[f.name] = None
            continue
        entities[f.name] = _state_entity(f.name, C, E, V, x)
        state_kw[f.name] = put(shard_field(_host(x), entities[f.name],
                                           axis=-1))
    state = core_state.State(**state_kw)

    mode = getattr(nl, "config_halo_exchange", "ppermute")
    tables = HaloTables(**{
        ent: _exchange_arrays(getattr(p, f"{ent}_x"), L[ent], mode, rank,
                              dtype, dev)
        for ent in ("cell", "edge", "vertex")})

    sm = ShardedModel(n_shards=S, partition=p, mesh_arrays=marr,
                      static=static, vert=model.vert, tables=tables,
                      state=state, namelist=nl, entities=entities, rank=rank)
    sm.step_fn = make_sharded_step(sm, dt=nl.config_dt)
    sm.summarize_fn = make_sharded_summarize(sm)
    # every rank has its tables before the first exchange (NCCL wants all
    # ranks in the first collective of a group)
    sm.barrier()
    return sm


def make_sharded_step(sm: ShardedModel, dt: float):
    halo = HaloExchange(sm.tables, n_rings=part_mod.HALO_RINGS)

    def step(state):
        return srk3.atm_srk3(state, sm.static, sm.mesh_arrays, sm.vert,
                             sm.namelist, dt, halo=halo)

    return step


def make_sharded_radiation(sm: ShardedModel, phys):
    """Sharded radiation: the columnar radctl chain
    (physics/driver.radiation_columns) over the local columns. Halo columns
    are computed redundantly, like the dycore stencils, so no exchange is
    needed. Returns radiation(state, tp) -> rthraten [K, local columns]."""
    from ..physics.driver import make_radiation_fn
    fn = make_radiation_fn(phys, sm.dtype, sm.device)
    m, sta, vert = sm.mesh_arrays, sm.static, sm.vert

    def radiation(state, tp):
        pressure = sta.pressure_base + state.pressure_p         # [K, L]
        sp = (vert.cf1 * pressure[0] + vert.cf2 * pressure[1]
              + vert.cf3 * pressure[2])
        # columnar radiation keeps the CAM [cols, pver] convention
        qv = state.scalars[0].T if state.scalars is not None else None
        qc = (state.scalars[1].T if state.scalars is not None
              and state.scalars.shape[0] > 1 else None)
        rthraten, _ = fn(m.latCell, m.lonCell, state.theta_m.T, state.exner.T,
                         pressure.T, sp, qv, qc, tp)
        return rthraten.T

    return radiation


def make_sharded_summarize(sm: ShardedModel):
    """Global diagnostics over the owned entities: masked extrema and a NaN
    count per shard, then (distributed) an all_reduce of MIN / MAX / SUM,
    the replacement for the reference's stubbed mpas_dmpar_* reductions
    (rk_timestep.rg:207-210, 309-311). Returns summarize(state) -> dict of
    0-d tensors."""
    p = sm.partition

    def owned(mask):
        m = mask > 0
        m = m[sm.rank] if sm.distributed else m.reshape(-1)
        return torch.from_numpy(np.ascontiguousarray(m)).to(sm.device)

    cm, em = owned(p.cell_owned_mask)[None, :], owned(p.edge_owned_mask)[None, :]
    big = torch.finfo(sm.dtype).max

    def summarize(state):
        def mm(x, mask):
            return (torch.where(mask, x, big).min(),
                    torch.where(mask, x, -big).max())
        w_min, w_max = mm(state.w, cm)
        u_min, u_max = mm(state.u, em)
        th_min, th_max = mm(state.theta_m, cm)
        wsp = torch.sqrt(state.u ** 2 + state.v ** 2)
        wsp_max = torch.where(em, wsp, -big).max()
        # NaNs counted apart, so that the masking cannot hide them
        nan_local = (torch.isnan(torch.where(cm, state.w, 0.0)).any()
                     | torch.isnan(torch.where(em, state.u, 0.0)).any())
        lows = torch.stack([w_min, u_min, th_min])
        highs = torch.stack([w_max, u_max, wsp_max, th_max])
        nan_count = nan_local.to(sm.dtype).reshape(1)
        if sm.distributed:
            import torch.distributed as dist
            dist.all_reduce(lows, op=dist.ReduceOp.MIN)
            dist.all_reduce(highs, op=dist.ReduceOp.MAX)
            dist.all_reduce(nan_count, op=dist.ReduceOp.SUM)
        return dict(w_min=lows[0], w_max=highs[0], u_min=lows[1],
                    u_max=highs[1], wsp_max=highs[2], theta_min=lows[2],
                    theta_max=highs[3], nan_detected=nan_count[0] > 0)

    return summarize


def sharded_summarize(sm: ShardedModel):
    """Global min/max/NaN diagnostics of the current sharded state."""
    if sm.summarize_fn is None:
        sm.summarize_fn = make_sharded_summarize(sm)
    out = sm.summarize_fn(sm.state)
    return {k: (bool(v) if k == "nan_detected" else float(v))
            for k, v in out.items()}


def host_summarize_oracle(sm: ShardedModel):
    """Host-numpy reference for the device reduction (test oracle only)."""
    p = sm.partition
    cm = np.asarray(p.cell_owned_mask) > 0
    em = np.asarray(p.edge_owned_mask) > 0
    # blocks are [S, K, L]; swap to [S, L, K] so the [S, L] owned masks
    # select whole columns
    w = np.swapaxes(sm.blocks(sm.state.w), 1, 2)
    u = np.swapaxes(sm.blocks(sm.state.u), 1, 2)
    v = np.swapaxes(sm.blocks(sm.state.v), 1, 2)
    th = np.swapaxes(sm.blocks(sm.state.theta_m), 1, 2)
    wsp = np.sqrt(u ** 2 + v ** 2)
    return dict(
        w_min=float(w[cm].min()), w_max=float(w[cm].max()),
        u_min=float(u[em].min()), u_max=float(u[em].max()),
        wsp_max=float(wsp[em].max()),
        theta_min=float(th[cm].min()), theta_max=float(th[cm].max()),
        nan_detected=bool(np.isnan(w[cm]).any() or np.isnan(u[em]).any()),
    )
