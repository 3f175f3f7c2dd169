"""The port's study and probe entry points: `windowed_study` and
`gather_probe`.

  - `windowed_study(mesh)` is the counterpart of tools/windowed_study.py:
    main. On a locality-renumbered mesh it reduces a random [Kst, E] edge
    table over edgesOnCell with the weights edgesOnCellSign *
    edgesOnCell_mask through Kernel 3 (ops/windowed.py), Kernel 2
    (ops/gather_reduce.py), a loop of `index_select`s (the study's own
    baseline, `xla_slot_reduce`) and Kernel 3's plain version.
  - `gather_probe()` is the counterpart of tools/pallas_gather_probe.py:
    main at its shapes (K=83, C=40962, R=122880, M=10): A and B gather
    columns through Kernel 4 (ops/take_columns.py; the TPU probe's B
    broadcast one index row to all K rows, so its function is A's), and C
    is the fused 10-slot weighted reduce, which is Kernel 2.
  - `compare_numberings(nl, mesh)` times the step on the default and on the
    ownership-aligned edge numbering in turns, both models on one card.
    `python -m mpas_tpu_torch.probes` runs it at full width (x1.40962, 41
    levels, float32, dt = 300 s) and prints one JSON line.

Both run on the card unless `device="cpu"` is asked for. There they compute
the same results through the plain versions and time nothing: every time
they return is milliseconds of the card, from CUDA events. Inputs come from
a numpy seed. Each returns plain numbers (and, for the tests, the results);
chip_smoke.py prints them beside their bounds.
"""

from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from .dynamics.model import build_model, resolve_device
from .ops import gather_reduce as gr
from .ops import take_columns as tc
from .ops import windowed as wd


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of `fn()` over `reps` runs, timed with CUDA
    events one run at a time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def step_ms(model, n):
    """Milliseconds of each of `n` single steps, timed with CUDA events."""
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        model.step(1)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def roundoff_ratio(out, ref, mag, M):
    """Largest ratio of |out - ref| to the round-off bound of an M-term sum
    taken in either order, 4 (M+1) eps sum_m |w g| (`mag`), eps of out's
    dtype; above 1 is a fault."""
    lim = 4 * (M + 1) * torch.finfo(out.dtype).eps * mag + 1e-30
    return float(((out - ref).abs() / lim).max())


def csr_weights(idx, w, N):
    """The weighted gather-reduce as one sparse matrix: idx [R, M], w
    [S, R, M] -> CSR [S*R, N], for `torch.sparse.mm` with the table's
    transpose (the library call timed beside Kernels 2 and 3; the port
    never calls it)."""
    S, R, M = w.shape
    rows = torch.arange(S * R, device=w.device).repeat_interleave(M)
    cols = idx.long().repeat(S, 1).reshape(-1)
    W = torch.sparse_coo_tensor(torch.stack([rows, cols]), w.reshape(-1),
                                (S * R, N)).coalesce()
    return W.to_sparse_csr()


def _timer(dev):
    return cuda_ms if dev.type == "cuda" else (lambda fn: None)


def windowed_study(mesh, Kst=(48, 168), device="cuda", seed=0):
    """One row per Kst: the plan (W, blocks, the kernel's level chunk and
    shared bytes per CTA), Kernel 3 against its plain version (error and
    its ratio to the round-off bound) and against the index_select loop,
    Kernel 2 against that loop, and the times of Kernel 3, Kernel 2, the
    index_select loop, the plain version and the CSR product. `bytes` is
    what the reduction must move (table, idx and w read once, output
    written once); `staged_bytes` what Kernel 3 reads into its windows."""
    dev = resolve_device(device)
    time = _timer(dev)
    idx_np = np.asarray(mesh.edgesOnCell, np.int32)
    w_np = np.asarray(mesh.edgesOnCellSign * mesh.edgesOnCell_mask,
                      np.float32)
    plan = wd.plan_windows(idx_np)
    C, M = idx_np.shape
    E = mesh.nEdges
    idx = torch.from_numpy(idx_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)[None]                       # [1, C, M]
    wT = wd.pad_weights(plan, w[0], dev)[None]                     # [1, M, Rp]
    rng = np.random.default_rng(seed)
    rows = []
    for K in Kst:
        tbl = torch.from_numpy(rng.standard_normal((K, E), np.float32)).to(dev)
        tbl_p = torch.nn.functional.pad(
            tbl, (0, max(0, plan.min_table_width - E)))
        out3 = wd.windowed_gather_reduce(plan, tbl_p, wT)[0]
        ref3 = wd.windowed_reduce_plain(plan, tbl_p, wT)[0]
        out2 = gr.gather_reduce(tbl, idx, w)[0]
        base = gr.gather_reduce_plain(tbl, idx, w)[0]
        mag = gr.gather_reduce_plain(tbl.abs(), idx, w.abs())[0]
        kc, smem = wd.level_chunk(plan, K, 1)
        csr = csr_weights(idx, w, E)
        tblT = tbl.t().contiguous()
        rows.append(dict(
            Kst=K, C=C, E=E, M=M, W=plan.W, blocks=plan.nb, Kc=kc,
            smem_bytes=smem,
            max_abs_err=float((out3 - ref3).abs().max()),
            err_over_bound=roundoff_ratio(out3, ref3, mag, M),
            err_over_bound_vs_index_select=roundoff_ratio(out3, base, mag, M),
            gather_reduce_err_over_bound=roundoff_ratio(out2, base, mag, M),
            max_abs_out=float(base.abs().max()),
            ms=time(lambda: wd.windowed_gather_reduce(plan, tbl_p, wT)),
            gather_reduce_ms=time(lambda: gr.gather_reduce(tbl, idx, w)),
            index_select_ms=time(lambda: gr.gather_reduce_plain(tbl, idx, w)),
            plain_ms=time(lambda: wd.windowed_reduce_plain(plan, tbl_p, wT)),
            library_ms=time(lambda: torch.sparse.mm(csr, tblT)),
            bytes=4 * (K * E + 2 * C * M + K * C),
            staged_bytes=4 * plan.nb * K * plan.W,
            flops=2 * K * C * M))
    return rows


def gather_probe_inputs(K=83, C=40962, R=122880, M=10, seed=0):
    """The probe's random inputs, as numpy: tbl [K, C] float32, idx [R] and
    idx_slots [R, M] int32 in [0, C), w [R, M] float32."""
    rng = np.random.default_rng(seed)
    return dict(tbl=rng.standard_normal((K, C), np.float32),
                idx=rng.integers(0, C, R, dtype=np.int32),
                idx_slots=rng.integers(0, C, (R, M), dtype=np.int32),
                w=rng.standard_normal((R, M), np.float32))


def gather_probe(K=83, C=40962, R=122880, M=10, device="cuda", seed=0):
    """A, B and C of the TPU probe. Returns {"A": row, "B": row, "C": row,
    "outputs": (a, b, c)}; each row holds the error against the reference
    (exact for A and B: index_select for A, the broadcast `torch.gather`
    that is take_along_axis's counterpart for B; the plain version and its
    round-off bound for C), the kernel's, plain version's and library
    call's times, and the bytes and operations of the function."""
    dev = resolve_device(device)
    time = _timer(dev)
    inp = {k: torch.from_numpy(v).to(dev)
           for k, v in gather_probe_inputs(K, C, R, M, seed).items()}
    tbl, idx, idx_slots, w = (inp["tbl"], inp["idx"], inp["idx_slots"],
                              inp["w"][None])
    idx_kr = idx.long()[None].expand(K, R)

    a = tc.take_columns(tbl, idx)
    b = tc.take_columns(tbl, idx)
    c = gr.gather_reduce(tbl, idx_slots, w)[0]
    ref_a = torch.index_select(tbl, 1, idx)
    ref_b = torch.gather(tbl, 1, idx_kr)
    ref_c = gr.gather_reduce_plain(tbl, idx_slots, w)[0]
    mag_c = gr.gather_reduce_plain(tbl.abs(), idx_slots, w.abs())[0]
    csr = csr_weights(idx_slots, w, C)
    tblT = tbl.t().contiguous()
    take_bytes = 4 * (K * C + R + K * R)
    k4_ms = time(lambda: tc.take_columns(tbl, idx))
    plain_ms = time(lambda: tc.take_columns_plain(tbl, idx))
    row_a = dict(K=K, C=C, R=R, max_abs_err=float((a - ref_a).abs().max()),
                 ms=k4_ms, plain_ms=plain_ms,
                 library_ms=time(lambda: torch.index_select(tbl, 1, idx)),
                 bytes=take_bytes, flops=0)
    row_b = dict(row_a, max_abs_err=float((b - ref_b).abs().max()),
                 ms=time(lambda: tc.take_columns(tbl, idx)),
                 library_ms=time(lambda: torch.gather(tbl, 1, idx_kr)))
    row_c = dict(K=K, C=C, R=R, M=M,
                 max_abs_err=float((c - ref_c).abs().max()),
                 err_over_bound=roundoff_ratio(c, ref_c, mag_c, M),
                 ms=time(lambda: gr.gather_reduce(tbl, idx_slots, w)),
                 plain_ms=time(lambda: gr.gather_reduce_plain(tbl, idx_slots, w)),
                 library_ms=time(lambda: torch.sparse.mm(csr, tblT)),
                 bytes=4 * (K * C + 2 * R * M + K * R), flops=2 * K * R * M)
    return {"A": row_a, "B": row_b, "C": row_c, "outputs": (a, b, c)}


def compare_numberings(nl, mesh):
    """Median ms per step of 10 single steps, per block, for the default
    numbering and for config_orient_edges, both models built from `nl` and
    `mesh` and kept on the card, run in turns (default, orient, orient,
    default) three times after 2 warm-up steps each. Needs a card: it
    times nothing else."""
    models = {"default": build_model(nl, mesh, device="cuda"),
              "orient": build_model(nl.replace(config_orient_edges=True),
                                    mesh, device="cuda")}
    for m in models.values():
        m.step(2)
    blocks = {name: [] for name in models}
    for _ in range(3):
        for name in ("default", "orient", "orient", "default"):
            blocks[name].append(statistics.median(step_ms(models[name], 10)))
    return blocks


if __name__ == "__main__":
    from .config import Namelist
    from .mesh.generator import generate_mesh

    nl = Namelist(config_nvertlevels=41, config_dt=300.0, dtype="float32",
                  config_jw_u_perturbation=1.0)
    blocks = compare_numberings(nl, generate_mesh(levels=6))
    print(json.dumps({"compare_numberings": blocks,
                      "device": torch.cuda.get_device_name(0)}))
