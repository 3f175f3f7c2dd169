"""The port's study and probe entry points: `windowed_study` and
`gather_probe`.

  - `windowed_study(mesh)` is the counterpart of tools/windowed_study.py:
    main. On a locality-renumbered mesh it reduces a random [Kst, E] edge
    table over edgesOnCell with the weights edgesOnCellSign *
    edgesOnCell_mask through Kernel 3 (ops/windowed.py), Kernel 2
    (ops/gather_reduce.py), a loop of `index_select`s (the study's own
    baseline, `xla_slot_reduce`) and Kernel 3's plain version.
    `reduce_study` is its one row, on any index table.
  - `gather_probe()` is the counterpart of tools/pallas_gather_probe.py:
    main at its shapes (K=83, C=40962, R=122880, M=10): A and B gather
    columns through Kernel 4 (ops/take_columns.py; the TPU probe's B
    broadcast one index row to all K rows, so its function is A's), and C
    is the fused 10-slot weighted reduce, which is Kernel 2.
  - `gather_forms(tbl, idx, w)` holds both forms of Kernel 2 against the
    plain version on one input and times them in turns; `take_forms(tbl,
    idx)` does the same for Kernel 4 against `index_select`.
  - `acoustic_inputs(K, C, seed)` makes Kernel 1's arguments at any shape
    from a numpy seed (`acoustic_args` puts them on a device), for the
    checks of the kernel at shapes the step does not give it.
  - `seeded_condensate(state, seed)` puts condensate across the freezing
    level into a moist state, for the checks that need cloud and ice (the
    JW wave forms none in a few steps); `sediment_inputs(K, C, seed)` makes
    falling species and their columns at any shape, for Kernel 5.
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

from . import constants
from .dynamics.model import build_model, resolve_device
from .ops import gather_reduce as gr
from .ops import take_columns as tc
from .ops import windowed as wd
from .ops.acoustic import ImplicitCoefs


L2_FLUSH_BYTES = 256 * 1024 * 1024      # 5x the H100's 50 MB L2
SPIN_CYCLES = 200_000                   # ~0.1 ms at the H100's 1.98 GHz


def cuda_ms(fn, reps=20, warmup=3, cold_l2=False, after_idle=False):
    """Median milliseconds of `fn()` over `reps` runs, timed with CUDA
    events one run at a time. Before each run, outside the timed events,
    the device is given ~0.1 ms of other work, so that the host has
    enqueued the run before the first event passes and the time between
    the events is the device's alone: a spin kernel that touches no
    memory (the run then finds in the L2 what the run before left there),
    or, with `cold_l2`, the overwriting of a scratch tensor several times
    the L2's size (the run then finds none of its inputs in the cache).
    With `after_idle` there is no such work: the events then also span the
    host's own time to launch onto an idle device, tens of microseconds."""
    scratch = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
               if cold_l2 else None)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if scratch is not None:
            scratch.zero_()
        elif not after_idle:
            torch.cuda._sleep(SPIN_CYCLES)
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


def csr_same_layout(csr, tbl, S, R):
    """The library call made to compute the kernels' whole function: the
    table transposed first and the product brought back to [S, Kt, R]."""
    Kt = tbl.shape[0]
    return (torch.sparse.mm(csr, tbl.t().contiguous())
            .reshape(S, R, Kt).transpose(1, 2).contiguous())


def _timer(dev, cold_l2=False):
    if dev.type != "cuda":
        return lambda fn: None
    return lambda fn: cuda_ms(fn, cold_l2=cold_l2)


def reduce_study(idx_np, w_np, N, K, device="cuda", seed=0):
    """One row of the windowed study: a random [K, N] float32 table reduced
    over idx_np [R, M] with the weights w_np [R, M]. The plan (W, U,
    blocks, the kernel's level chunk, slices and shared bytes per CTA),
    Kernel 3 against its plain version (error and its ratio to the
    round-off bound) and against the index_select loop, Kernel 2 against
    that loop, and the times of Kernel 3, Kernel 2, the index_select loop,
    the plain version and the CSR product (`library_ms` with the table
    transposed beforehand and the result left [R, K];
    `library_same_layout_ms` with both conversions timed), each kernel
    also with a cold L2. `bytes` is what the reduction must move (table,
    idx and w read once, output written once); `staged_bytes` what Kernel
    3 copies into shared memory."""
    dev = resolve_device(device)
    time, time_cold = _timer(dev), _timer(dev, cold_l2=True)
    idx_np = np.ascontiguousarray(idx_np, np.int32)
    plan = wd.plan_windows(idx_np)
    R, M = idx_np.shape
    idx = torch.from_numpy(idx_np).to(dev)
    w = torch.from_numpy(np.asarray(w_np, np.float32)).to(dev)[None]  # [1, R, M]
    wT = wd.pad_weights(plan, w[0], dev)[None]                     # [1, M, Rp]
    rng = np.random.default_rng(seed)
    tbl = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(dev)
    out3 = wd.windowed_gather_reduce(plan, tbl, wT)[0]
    ref3 = wd.windowed_reduce_plain(plan, tbl, wT)[0]
    out2 = gr.gather_reduce(tbl, idx, w)[0]
    base = gr.gather_reduce_plain(tbl, idx, w)[0]
    mag = gr.gather_reduce_plain(tbl.abs(), idx, w.abs())[0]
    kc, smem = wd.level_chunk(plan, K, 1)
    slices = (wd.level_slices(plan, K, kc, smem, wd.sm_count(dev))
              if dev.type == "cuda" else None)
    csr = csr_weights(idx, w, N)
    tblT = tbl.t().contiguous()
    k3 = lambda: wd.windowed_gather_reduce(plan, tbl, wT)
    k2 = lambda: gr.gather_reduce(tbl, idx, w)
    return dict(
        Kst=K, R=R, N=N, M=M, W=plan.W, U=plan.U, blocks=plan.nb, Kc=kc,
        slices=slices, smem_bytes=smem,
        sectors=gr.index_scatter(idx, 4),
        max_abs_err=float((out3 - ref3).abs().max()),
        err_over_bound=roundoff_ratio(out3, ref3, mag, M),
        err_over_bound_vs_index_select=roundoff_ratio(out3, base, mag, M),
        gather_reduce_err_over_bound=roundoff_ratio(out2, base, mag, M),
        max_abs_out=float(base.abs().max()),
        ms=time(k3), ms_cold_l2=time_cold(k3),
        gather_reduce_ms=time(k2), gather_reduce_ms_cold_l2=time_cold(k2),
        index_select_ms=time(lambda: gr.gather_reduce_plain(tbl, idx, w)),
        plain_ms=time(lambda: wd.windowed_reduce_plain(plan, tbl, wT)),
        library_ms=time(lambda: torch.sparse.mm(csr, tblT)),
        library_same_layout_ms=time(lambda: csr_same_layout(csr, tbl, 1, R)),
        bytes=4 * (K * N + 2 * R * M + K * R),
        staged_bytes=4 * K * int(plan.ncols.sum()),
        flops=2 * K * R * M)


def windowed_study(mesh, Kst=(48, 168), device="cuda", seed=0):
    """One `reduce_study` row per Kst on the mesh's edgesOnCell table with
    the weights edgesOnCellSign * edgesOnCell_mask; C and E name the row's
    R and N."""
    rows = []
    for K in Kst:
        row = reduce_study(mesh.edgesOnCell,
                           mesh.edgesOnCellSign * mesh.edgesOnCell_mask,
                           mesh.nEdges, K, device, seed)
        rows.append(dict(row, C=row["R"], E=row["N"]))
    return rows


def gather_forms(tbl, idx, w):
    """Both forms of Kernel 2 on one input on the card: each form's largest
    error over its round-off bound against the plain version, the index
    table's `index_scatter`, the form `gather_reduce` picks, and the
    forms' times in turns (direct, rows, rows, direct; the mean of each
    form's two medians), warm and with a cold L2."""
    M = idx.shape[1]
    ref = gr.gather_reduce_plain(tbl, idx, w)
    mag = gr.gather_reduce_plain(tbl.abs(), idx, w.abs())
    forms = {"direct": lambda: gr.gather_reduce_direct(tbl, idx, w),
             "rows": lambda: gr.gather_reduce_rows(tbl, idx, w)}
    row = {f"{name}_err_over_bound": roundoff_ratio(fn(), ref, mag, M)
           for name, fn in forms.items()}
    for key, cold in (("ms", False), ("ms_cold_l2", True)):
        turns = {"direct": [], "rows": []}
        for name in ("direct", "rows", "rows", "direct"):
            turns[name].append(cuda_ms(forms[name], cold_l2=cold))
        for name, ts in turns.items():
            row[f"{name}_{key}"] = sum(ts) / len(ts)
    sectors = gr.index_scatter(idx, tbl.element_size())
    return dict(row, sectors=sectors,
                gain=gr.row_form_gain(sectors, tbl.element_size(),
                                      tbl.shape[1], *idx.shape),
                picked="rows" if gr.uses_row_form(tbl, idx) else "direct")


def take_forms(tbl, idx):
    """Both forms of Kernel 4 on one input on the card: whether each equals
    `index_select` bit for bit, the index vector's `index_scatter` and
    `row_form_gain`, the form `take_columns` picks, and the times of the
    two forms and of `index_select` in turns (direct, rows, library,
    library, rows, direct; the mean of each one's two medians), warm and
    with a cold L2."""
    ref = torch.index_select(tbl, 1, idx)
    forms = {"direct": lambda: tc.take_columns_direct(tbl, idx),
             "rows": lambda: tc.take_columns_rows(tbl, idx),
             "library": lambda: torch.index_select(tbl, 1, idx)}
    row = {f"{name}_exact": bool(torch.equal(forms[name](), ref))
           for name in ("direct", "rows")}
    for key, cold in (("ms", False), ("ms_cold_l2", True)):
        turns = {name: [] for name in forms}
        for name in ("direct", "rows", "library", "library", "rows", "direct"):
            turns[name].append(cuda_ms(forms[name], cold_l2=cold))
        for name, ts in turns.items():
            row[f"{name}_{key}"] = sum(ts) / len(ts)
    return dict(row, sectors=gr.index_scatter(idx.unsqueeze(1),
                                              tbl.element_size()),
                gain=tc.index_gain(tbl, idx),
                picked="rows" if tc.uses_row_form(tbl, idx) else "direct")


def acoustic_inputs(K, C, seed=0):
    """Kernel 1's arguments at any shape, as float64 numpy arrays from a
    seed: {"fields": the 14 level-major fields by the wrapper's argument
    names, "coefs": the ImplicitCoefs fields}. The tridiagonal factors come
    from a diagonally dominant system (sub- and super-diagonal in [-0.4,
    -0.1], diagonal 1 + their magnitudes), factored as the model factors
    its own, so alpha_tri and gamma_tri are well conditioned; interface
    fields are zero at interfaces 0 and K, as the model's are."""
    rng = np.random.default_rng(seed)

    def level(scale):
        return rng.normal(0.0, scale, (K, C))

    def iface(scale, positive=False):
        a = rng.normal(0.0, scale, (K + 1, C))
        if positive:
            a = np.abs(a)
        a[0] = a[K] = 0.0
        return a

    sub = -rng.uniform(0.1, 0.4, (K + 1, C))
    sup = -rng.uniform(0.1, 0.4, (K + 1, C))
    diag = 1.0 - sub - sup
    alpha = np.zeros((K + 1, C))
    gamma = np.zeros((K + 1, C))
    for k in range(1, K):
        alpha[k] = 1.0 / (diag[k] - sub[k] * gamma[k - 1])
        gamma[k] = sup[k] * alpha[k]
    sub[0] = sub[K] = 0.0
    coefs = dict(cofrz=rng.uniform(0.05, 0.2, K),
                 cofwr=iface(0.5, positive=True),
                 cofwz=iface(0.5, positive=True),
                 coftz=iface(300.0, positive=True),
                 cofwt=np.abs(level(0.1)), a_tri=sub, alpha_tri=alpha,
                 gamma_tri=gamma)
    fields = dict(
        rs0=level(1e-4), ts0=level(1e-2), ac_rho_pp=level(1e-4),
        ac_rtheta_pp=level(1e-2), ac_rw_p=iface(1e-3), wwAvg=iface(1e-3),
        tend_rho=level(1e-7), tend_rt=level(1e-5), tend_w=iface(1e-5),
        zz=rng.uniform(0.8, 1.0, (K, C)), dss_i=iface(1e-3, positive=True),
        zz_rho_i=iface(1.0, positive=True), w=iface(1e-2),
        dw_save=iface(1e-3))
    return {"fields": fields, "coefs": coefs}


def acoustic_args(inputs, device="cuda", dtype=torch.float64,
                  tendencies=True, dts=240.0, epssm=0.1):
    """The positional arguments of `acoustic_column_update` from
    `acoustic_inputs`, as tensors of `dtype` on `device`; with
    `tendencies=False`, tend_rho and tend_rt are None."""
    dev = resolve_device(device)
    conv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    f = {k: conv(v) for k, v in inputs["fields"].items()}
    coefs = ImplicitCoefs(**{k: conv(v) for k, v in inputs["coefs"].items()})
    tend = (f["tend_rho"], f["tend_rt"]) if tendencies else (None, None)
    return (f["rs0"], f["ts0"], f["ac_rho_pp"], f["ac_rtheta_pp"],
            f["ac_rw_p"], f["wwAvg"], *tend, f["tend_w"], coefs, f["zz"],
            f["dss_i"], f["zz_rho_i"], f["w"], f["dw_save"], dts, epssm)


def mixed_index_table(idx, fraction, N, seed=0):
    """A copy of the index table idx with `fraction` of its entries, picked
    at random, replaced by random columns in [0, N): a table between a
    mesh's own and a random one, for the crossover of Kernel 2's forms."""
    rng = np.random.default_rng(seed)
    mixed = idx.cpu().numpy().copy()
    hit = rng.random(mixed.shape) < fraction
    mixed[hit] = rng.integers(0, N, int(hit.sum()), dtype=mixed.dtype)
    return torch.from_numpy(mixed).to(idx.device)


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
    round-off bound for C), the kernel's (warm and with a cold L2), plain
    version's and library call's times, and the bytes and operations of
    the function; C also holds `gather_forms` of its input on the card."""
    dev = resolve_device(device)
    time, time_cold = _timer(dev), _timer(dev, cold_l2=True)
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
                 form="rows" if tc.uses_row_form(tbl, idx) else "direct",
                 gain=tc.index_gain(tbl, idx), ms=k4_ms, plain_ms=plain_ms,
                 ms_cold_l2=time_cold(lambda: tc.take_columns(tbl, idx)),
                 library_ms=time(lambda: torch.index_select(tbl, 1, idx)),
                 bytes=take_bytes, flops=0)
    row_b = dict(row_a, max_abs_err=float((b - ref_b).abs().max()),
                 ms=time(lambda: tc.take_columns(tbl, idx)),
                 library_ms=time(lambda: torch.gather(tbl, 1, idx_kr)))
    row_c = dict(K=K, C=C, R=R, M=M,
                 max_abs_err=float((c - ref_c).abs().max()),
                 err_over_bound=roundoff_ratio(c, ref_c, mag_c, M),
                 ms=time(lambda: gr.gather_reduce(tbl, idx_slots, w)),
                 ms_cold_l2=time_cold(
                     lambda: gr.gather_reduce(tbl, idx_slots, w)),
                 plain_ms=time(lambda: gr.gather_reduce_plain(tbl, idx_slots, w)),
                 library_ms=time(lambda: torch.sparse.mm(csr, tblT)),
                 library_same_layout_ms=time(
                     lambda: csr_same_layout(csr, tbl, 1, R)),
                 bytes=4 * (K * C + 2 * R * M + K * R), flops=2 * K * R * M)
    if dev.type == "cuda":
        row_c["forms"] = gather_forms(tbl, idx_slots, w)
    return {"A": row_a, "B": row_b, "C": row_c, "outputs": (a, b, c)}


# the condensate species in the order of scalars[1:], each with its mixing
# ratio [kg/kg] and the phase it takes: liquid where T > 268 K, ice where
# 220 K < T < 273.15 K (so both between 268 and 273.15 K)
CONDENSATE = (("qc", 4e-4, "liquid"), ("qr", 2e-4, "liquid"),
              ("qi", 1.5e-4, "ice"), ("qs", 3e-4, "ice"), ("qg", 2e-4, "ice"))


def seeded_condensate(state, seed=0, share=0.7):
    """`state` with condensate across the freezing level: each species of
    scalars[1:] (as many of CONDENSATE as the microphysics carries) gets
    its mixing ratio where its phase can live, times a factor in [0.5, 1.5)
    from a numpy seed, at a random `share` of the points and zero elsewhere.
    The radiation's cloud optics then see cloudy and clear layers, liquid
    and ice, and WSM6 runs its warm and its ice paths. The scalars are a
    new tensor; the other fields are the state's own."""
    s = state.scalars
    t = state.theta_m / (1.0 + constants.rvord * s[0]) * state.exner
    rng = np.random.default_rng(seed)
    shape = (s.shape[0] - 1,) + tuple(t.shape)
    factor = (0.5 + rng.random(shape)) * (rng.random(shape) < share)
    factor = torch.from_numpy(factor).to(s.device, s.dtype)
    new = s.clone()
    for i, (_, q, phase) in enumerate(CONDENSATE[:s.shape[0] - 1]):
        where = (t > 268.0) if phase == "liquid" else (t > 220.0) & (t < 273.15)
        new[i + 1] = q * where.to(s.dtype) * factor[i]
    return state.replace(scalars=new)


def sediment_inputs(K, C, seed=0, extremes=False):
    """Column physics inputs at any shape, as float64 numpy [K, C] arrays
    from a seed, for the checks of Kernel 5 (physics/sediment.py) and of the
    schemes that call it at shapes no run gives: {"qr", "qs", "qg", "rho",
    "dz", "t", "p"}. Layers stretched to 30 km (dz grows as the 1.4th power
    of height: 166 m at the bottom of 41 levels), a lapse-rate temperature
    with noise down to 210 K, pressure with a 7 km scale height, rho the
    dry density; rain, snow and graupel get their mixing ratio of
    CONDENSATE where their phase can live, times a factor in [0.5, 1.5) at
    70% of the points, as `seeded_condensate` gives a state. With
    `extremes`, every 7th column from column 2 holds no condensate and the
    one after it 50 g/kg of each species, at which each fall law reaches
    its cap in the thin air of the upper levels."""
    rng = np.random.default_rng(seed)
    zi = 30000.0 * np.linspace(0.0, 1.0, K + 1) ** 1.4
    z = 0.5 * (zi[1:] + zi[:-1])[:, None]
    t = (np.maximum(300.0 - 6.5e-3 * z, 210.0)
         + rng.normal(0.0, 1.0, (K, C)))
    p = 1.0e5 * np.exp(-z / 7000.0) * np.ones((K, C))
    out = dict(rho=p / (constants.rgas * t), t=t, p=p,
               dz=np.repeat(np.diff(zi)[:, None], C, axis=1))
    liquid = t > 268.0
    ice = (t > 220.0) & (t < 273.15)
    for name, q, phase in CONDENSATE:
        if name not in ("qr", "qs", "qg"):
            continue
        factor = (0.5 + rng.random((K, C))) * (rng.random((K, C)) < 0.7)
        out[name] = q * factor * (liquid if phase == "liquid" else ice)
        if extremes:
            out[name][:, 2::7] = 0.0
            out[name][:, 3::7] = 0.05
    return out


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
