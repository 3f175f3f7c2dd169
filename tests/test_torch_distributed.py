"""The distributed back end of mpas_tpu_torch.parallel.sharded: 2 spawned
processes, torch.distributed with gloo on the CPU, one shard each, against
the stacked back end in this process on the same model (dry JW, float64,
generate_mesh(levels=3, lloyd_iterations=2), 8 levels, 2 steps), for both
config_halo_exchange modes: every state block bit-equal (the bound is
1e-13), the same number of exchanges, the same summary, and a checkpoint
written by rank 0 that restores into the stacked model.

The processes rendezvous on a port chosen at run time, and the test joins
them with a timeout of its own, so a rank that skips a collective fails
the test instead of hanging it."""

import socket

import numpy as np
import pytest
import torch.multiprocessing as mp

MODES = ("ppermute", "all_to_all")
WORLD = 2
TIMEOUT_S = 150
KW = dict(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
          config_jw_u_perturbation=1.0)


def _model(mode):
    from mpas_tpu_torch.config import Namelist
    from mpas_tpu_torch.dynamics.model import build_model
    from mpas_tpu_torch.mesh.generator import generate_mesh
    return build_model(Namelist(**KW, config_halo_exchange=mode),
                       generate_mesh(levels=3, lloyd_iterations=2),
                       device="cpu")


def _run(sm):
    """2 steps: (state blocks, exchanges, summary)."""
    from mpas_tpu_torch.parallel import halo
    from mpas_tpu_torch.parallel.sharded import sharded_summarize
    halo.exchanges = 0
    sm.step(2)
    exchanges = halo.exchanges
    return sm.state_blocks(), exchanges, sharded_summarize(sm)


def _worker(rank, port, ck_dir, queue):
    import torch.distributed as dist
    from mpas_tpu_torch.io.history import save_restart
    from mpas_tpu_torch.parallel.sharded import shard_model
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        out = {}
        for mode in MODES:
            sm = shard_model(_model(mode), WORLD)
            assert sm.rank == rank and sm.state.u.shape[-1] == \
                sm.partition.edge_l2g.shape[1]
            out[mode] = _run(sm)
            save_restart(f"{ck_dir}/{mode}.npz", sm)
        queue.put((rank, out if rank == 0 else None))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of both modes, from 2 spawned gloo processes."""
    ck_dir = str(tmp_path_factory.mktemp("ck"))
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, ck_dir, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=TIMEOUT_S) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return got[0], ck_dir


@pytest.mark.parametrize("mode", MODES)
def test_distributed_matches_stacked(ranks, mode):
    from mpas_tpu_torch.parallel.sharded import shard_model
    out, _ = ranks
    blocks, exchanges, summary = out[mode]
    ref_blocks, ref_exchanges, ref_summary = _run(
        shard_model(_model(mode), WORLD))
    assert set(blocks) == set(ref_blocks)
    for k, v in ref_blocks.items():
        assert v.shape == blocks[k].shape, k
        err = np.abs(v - blocks[k]).max() / max(np.abs(v).max(), 1e-300)
        assert err <= 1e-13, (k, err)
    assert exchanges == ref_exchanges == 24
    assert summary == ref_summary


@pytest.mark.parametrize("mode", MODES)
def test_rank0_checkpoint_restores_into_stacked(ranks, mode):
    from mpas_tpu_torch.io.history import load_restart
    from mpas_tpu_torch.parallel.sharded import shard_model
    out, ck_dir = ranks
    sm = shard_model(_model(mode), WORLD)
    load_restart(f"{ck_dir}/{mode}.npz", sm)
    assert sm.step_count == 2
    for k, v in sm.state_blocks().items():
        assert np.array_equal(v, out[mode][0][k]), k
