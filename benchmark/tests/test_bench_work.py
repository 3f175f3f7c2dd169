"""The frozen work counts behind `acoustic_column_roofline_pct`,
`sediment_roofline_pct` and `step_mfu`, against counts made by hand and
against the arguments of a real call."""

import pytest
import torch

from benchmark import check, inputs, spec, work
from benchmark.reference.ops import acoustic as ref_acoustic
from conftest import tiny


def test_acoustic_column_by_hand():
    K, C = 2, 3
    level, iface = K * C, (K + 1) * C           # 6, 9
    read = (level * 6                            # rs0 ts0 rho_pp rtheta_pp zz cofwt
            + iface * 7                          # rw_p wwAvg tend_w dss_i zz_rho_i w dw_save
            + iface * 6                          # cofwz coftz cofwr a_tri alpha_tri gamma_tri
            + K)                                 # cofrz
    written = level * 2 + iface * 2
    assert read + written == 185
    assert work.acoustic_column(K, C, 4) == (4 * 185, 64 * 6)
    assert work.acoustic_column(K, C, 8)[0] == 8 * 185


def test_acoustic_column_counts_every_argument(grid_dir, monkeypatch):
    """The count is the bytes of the tensors one call of the step reads
    and writes."""
    seen = []
    real = ref_acoustic.acoustic_column_update

    def spy(*args, **kw):
        outs = real(*args, **kw)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        coefs = args[9]
        tensors += [getattr(coefs, n) for n in (
            "cofrz", "cofwz", "coftz", "cofwr", "cofwt", "a_tri",
            "alpha_tri", "gamma_tri")]
        seen.append((args[0].shape, sum(t.numel() * t.element_size()
                                        for t in tensors + list(outs))))
        return outs

    monkeypatch.setattr(ref_acoustic, "acoustic_column_update", spy)
    cell = tiny(spec.load_cell("dry_120km"))
    draws = inputs.draw(5, cell.traffic)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    check.reference_run(cell, draws, grid, 1, torch.device("cpu"),
                        torch.float32)
    assert len(seen) == sum(work.acoustic_substeps(2))
    for (K, C), nbytes in seen:
        assert work.acoustic_column(K, C, 4)[0] == nbytes


def test_step_by_hand():
    z = dict(nCells=12, nEdges=30, nVertices=20, K=2, maxEdges=6,
             maxEdges2=10, n_sub=2, split=1, n_scalars=0, itemsize=4,
             index_itemsize=4, dtype="float32")
    state = 2 * 30 + 3 * 12 + 2 * 2 * 12          # u, w, theta_m + rho_zz: 144
    stages, substeps = 3, 1 + 1 + 2
    elements = (2 * state * stages + 2 * state * substeps
                + 6 * 2 * 12 + 2 * 30 + 3 * 12)     # metrics, zxu, dss
    geometry = 30 * 10 + 4 * 30 + 12 + 2 * 20
    tables = 4 * 30 + 30 * 10 + 2 * 12 * 6 + 6 * 20
    nbytes, flops = work.step(z)
    assert nbytes == 4 * (elements + geometry) + 4 * tables == 13648
    assert flops == 64 * 2 * 12 * substeps
    moist = dict(z, n_scalars=6)
    assert work.step(moist)[0] - nbytes == 4 * 2 * 6 * 2 * 12


def test_sediment_by_hand():
    K, C, nfall = 2, 3, 4
    # per column: rain nfall * (K * (7 + 7) + 2) + 4K = 4 * 30 + 8 = 128,
    # snow 4 * (2 * 13 + 2) + 8 = 120
    assert work.sediment(K, C, ("rain",), nfall, 4) == (
        4 * (2 * 6 + 6 + 6 + 3), 3 * 128)
    nbytes, flops = work.sediment(K, C, ("rain", "snow"), nfall, 8)
    # rho, dz; q of each species read and written; an accumulation each
    assert nbytes == 8 * (6 + 6 + 2 * 6 + 2 * 6 + 2 * 3) == 336
    assert flops == 3 * 128 + 3 * 120 == 744
    assert work.sediment(K, C, work.FALLING["wsm6"], nfall, 4)[1] == \
        3 * (128 + 120 + 128)
    assert [len(work.FALLING[m]) for m in ("kessler", "wsm6lite", "wsm6")] \
        == [1, 2, 3]


def test_bound_takes_the_longer_side():
    assert work.bound_seconds(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert work.bound_seconds(0, 67e12, "float32") == pytest.approx(1.0)
    assert work.bound_seconds(3.35e12, 2 * 67e12, "float32") == \
        pytest.approx(2.0)
