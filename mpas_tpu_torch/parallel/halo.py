"""Halo exchange: refresh every shard's halo slots from their owners.

The port of `mpas_tpu.parallel.halo`. One interface (`HaloExchange`), two
back ends, chosen by the tables it is given (parallel/sharded.py builds
them from parallel/partition.py's exchange plans):

  - stacked (in process): the S shards' local blocks lie side by side on the
    entity axis of one [K, S*L] tensor. A refresh is one column gather of
    the packed block at `ExchangeArrays.source`, the identity except at
    halo slots, which point at their owner's slot. On the card the gather
    is Kernel 4 (ops/take_columns.py). This gives the values of mpas_tpu's
    all_to_all (send x mask -> all_to_all -> take(recv_pos) ->
    where(recv_is_halo)) and of its ppermute rounds, whichever plan the
    source vector was built from;
  - distributed (`torch.distributed`, one process per shard, each holding
    its [K, L] block): "all_to_all" is one `all_to_all_single` of the
    [S, K, max_send] send buffer; "ppermute" one `batch_isend_irecv` per
    schedule round (a rank outside the round's pairs does nothing), padding
    slots (recv_slot >= L) dropped. gloo on the CPU, NCCL on cards.

Fields are level-major [K, L]: the entity axis is the last. A refresh
packs all fields of one entity type on the level axis and exchanges them
once.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.take_columns import take_columns

# packed exchanges since the counters were last set to 0, and the bytes of
# the halo values they refreshed (over all shards in process; this rank's
# under torch.distributed): what a distributed run sends
exchanges = 0
halo_bytes = 0


@dataclasses.dataclass
class ExchangeRound:
    """One neighbour-only round of this rank (partition._build_exchange):
    every shard sends to <=1 peer and receives from <=1 peer."""
    perm: tuple             # ((src, dst), ...)
    send_idx: Any           # [m] this rank's send columns (0-padded)
    send_mask: Any          # [m]
    recv_cols: Any          # [m'] received columns kept (recv_slot < L)
    recv_slot: Any          # [m'] local slots they are written to


@dataclasses.dataclass
class ExchangeArrays:
    """One entity type's exchange plan on the device.

    Stacked: `source` [S*L] int32, and `n_halo`, the halo slots of all
    shards. Distributed: this rank's rows of the plan, send_idx [S, m] /
    send_mask [S, m] / recv_pos [L] / recv_is_halo [L] for "all_to_all",
    `rounds` for "ppermute", and `n_halo`, this rank's halo slots."""
    n_halo: int
    source: Any = None
    send_idx: Any = None
    send_mask: Any = None
    recv_pos: Any = None
    recv_is_halo: Any = None
    rounds: tuple = ()


@dataclasses.dataclass
class HaloTables:
    cell: ExchangeArrays
    edge: ExchangeArrays
    vertex: ExchangeArrays


class HaloExchange:
    """Refreshes halo slots from their owners.

    `n_rings` is the halo depth the partition was built with
    (partition.HALO_RINGS); the solver uses it to decide when redundant
    ring compute can replace exchanges inside the acoustic loop
    (dynamics/srk3.py). The distributed back end exchanges over the
    default process group, one rank per shard."""

    def __init__(self, tables: HaloTables, n_rings: int = 3):
        self.t = tables
        self.n_rings = n_rings

    def _exchange(self, xb, tbl: ExchangeArrays):
        if tbl.source is not None:
            return take_columns(xb.contiguous(), tbl.source)
        if tbl.rounds:
            return self._exchange_ppermute(xb, tbl)
        return self._exchange_all_to_all(xb, tbl)

    def _exchange_all_to_all(self, xb, tbl: ExchangeArrays):
        import torch.distributed as dist
        K = xb.shape[0]
        S, m = tbl.send_idx.shape
        send = torch.index_select(xb, 1, tbl.send_idx.reshape(-1))
        send = send.reshape(K, S, m) * tbl.send_mask[None]
        send = send.permute(1, 0, 2).contiguous()                  # [S, K, m]
        recv = torch.empty_like(send)
        # recv[d] is what shard d sent this rank
        dist.all_to_all_single(recv, send)
        recv_flat = recv.permute(1, 0, 2).reshape(K, S * m)
        new_vals = torch.index_select(recv_flat, 1, tbl.recv_pos)  # [K, L]
        return torch.where(tbl.recv_is_halo[None, :] > 0, new_vals, xb)

    def _exchange_ppermute(self, xb, tbl: ExchangeArrays):
        import torch.distributed as dist
        rank = dist.get_rank()
        out = xb.clone()
        for rnd in tbl.rounds:
            ops, recv = [], None
            for src, dst in rnd.perm:
                if src == rank:
                    send = (torch.index_select(xb, 1, rnd.send_idx)
                            * rnd.send_mask[None, :]).contiguous()
                    ops.append(dist.P2POp(dist.isend, send, dst))
                if dst == rank:
                    recv = xb.new_empty((xb.shape[0], rnd.send_idx.shape[0]))
                    ops.append(dist.P2POp(dist.irecv, recv, src))
            if not ops:
                continue
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if recv is not None:
                out[:, rnd.recv_slot] = torch.index_select(recv, 1,
                                                           rnd.recv_cols)
        return out

    def _exchange_packed(self, fields, tbl: ExchangeArrays):
        """ONE exchange per refresh: all fields sharing an entity type stack
        along the level axis into a single [sum K_i, L] block."""
        global exchanges, halo_bytes
        blocks = [f if f.ndim > 1 else f[None, :] for f in fields]
        packed = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)
        out = self._exchange(packed, tbl)
        exchanges += 1
        halo_bytes += tbl.n_halo * packed.shape[0] * packed.element_size()
        outs, off = [], 0
        for f, b in zip(fields, blocks):
            o = out[off:off + b.shape[0]]
            outs.append(o if f.ndim > 1 else o[0])
            off += b.shape[0]
        return tuple(outs)

    def cell(self, *fields):
        out = self._exchange_packed(fields, self.t.cell)
        return out if len(out) > 1 else out[0]

    def edge(self, *fields):
        out = self._exchange_packed(fields, self.t.edge)
        return out if len(out) > 1 else out[0]

    def vertex(self, *fields):
        out = self._exchange_packed(fields, self.t.vertex)
        return out if len(out) > 1 else out[0]

    # ---- solver-level bundles ----

    def refresh_state(self, state, scalars: bool = False):
        """Refresh all prognostic + physics-coupling halos (stage start).

        With `scalars` (the step's top) the species [nS, K, L] ride in the
        same cell exchange: transport leaves garbage in their outer halo
        ring, and the step's moist coefficients (qtot, cqw, cqu) read it.
        mpas_tpu's refresh_state carries no species, so its sharded moist
        step lets that garbage reach owned entries (~1e-11 relative after 2
        steps); with it the stacked step is the single-device step."""
        fields = [state.w, state.theta_m, state.rho_zz, state.rho_p,
                  state.rtheta_p, state.exner, state.pressure_p, state.rw]
        scal = state.scalars if scalars else None
        if scal is not None:
            nS, K, L = scal.shape
            fields.append(scal.reshape(nS * K, L))
        out = self.cell(*fields)
        upd = dict(zip(("w", "theta_m", "rho_zz", "rho_p", "rtheta_p",
                        "exner", "pressure_p", "rw"), out))
        if scal is not None:
            upd["scalars"] = out[-1].reshape(nS, K, L)
        upd["u"], upd["ru"] = self.edge(state.u, state.ru)
        return state.replace(**upd)

    def refresh_acoustic(self, ac):
        """Refresh acoustic perturbation halos (once per substep)."""
        rho_pp, rtheta_pp, rtheta_pp_old, rw_p = self.cell(
            ac.rho_pp, ac.rtheta_pp, ac.rtheta_pp_old, ac.rw_p)
        ru_p = self.edge(ac.ru_p)
        return ac.replace(rho_pp=rho_pp, rtheta_pp=rtheta_pp,
                          rtheta_pp_old=rtheta_pp_old, rw_p=rw_p, ru_p=ru_p)

    def refresh_tend(self, tend):
        """Refresh the large-step tendencies once per RK stage (2 packed
        exchanges). With tendencies valid over the FULL halo, the acoustic
        loop needs no exchange at all when ns + 1 <= n_rings: each substep
        consumes one ring of acoustic-perturbation validity and the
        post-loop recovery one more, so owned outputs stay exact while the
        outer-ring garbage is healed by the next stage-top refresh_state."""
        tend_w, tend_theta, tend_rho = self.cell(
            tend.tend_w, tend.tend_theta, tend.tend_rho)
        tend_u = self.edge(tend.tend_u)
        return tend.replace(tend_u=tend_u, tend_w=tend_w,
                            tend_theta=tend_theta, tend_rho=tend_rho)
