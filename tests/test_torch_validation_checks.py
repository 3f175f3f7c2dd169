"""mpas_tpu_torch.validation's checks, namelists, loop and command line,
on the CPU:

  - every check passes on the reference's own TPU artifact in
    docs/validation/ (opened read-only), and fails on a copy made wrong in
    the one way it guards against: a flat ps_min, a NaN in w, a negative
    vapour, a rain series that is not monotone, the wave moved off the
    mountain;
  - the reference's own jw480 series on the generated mesh (its first day
    run here) fails the three JW06 checks the port's fails there;
  - the digitized JW06 table equals tests/golden/jw06_psmin_digitized.csv;
  - mountain_wave.make_namelist(L) equals tools/mountain_wave_run's, field
    by field;
  - timed_loop records where the tools do and runs its hook before each
    hour's steps;
  - the command line writes its artifacts and its JSON line, refuses
    docs/validation/ as its output, raises for --device cuda without a
    card, and applies the convergence checks to three series.
"""

import json
import os
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from tools import mountain_wave_run

from mpas_tpu_torch.validation import __main__ as cli
from mpas_tpu_torch.validation import checks as C
from mpas_tpu_torch.validation import common, jw, mountain_wave

import validation_reference
from test_torch_copies import as_mpas_tpu

REPO = Path(__file__).resolve().parents[1]
VDIR = REPO / "docs" / "validation"


def art(name):
    with np.load(VDIR / name) as d:
        return {k: d[k] for k in d.files}


def series(name):
    return art(name)["ps_min"]


def flat(ps):
    return np.full_like(ps, ps[0])


def nan_w(a):
    a = dict(a)
    a["w"] = a["w"].copy()
    a["w"].flat[a["w"].size // 2] = np.nan
    return a


def negative_vapour(a):
    a = dict(a)
    for k in ("qv", "scalars"):
        if k in a:
            a[k] = a[k].copy()
            a[k][0, 0] = -1e-3
    return a


def rain_not_monotone(a):
    a = dict(a)
    a["rain_series"] = a["rain_series"].copy()
    a["rain_series"][-1] = a["rain_series"][-2] - 1.0
    return a


def wave_off_the_mountain(a):
    """The same field with the mountain's side of the planet swapped with
    the far side."""
    a = dict(a)
    a["lonCell"] = np.mod(a["lonCell"] + np.pi, 2.0 * np.pi)
    return a


# name -> (check on the reference's artifact(s), arguments)
REFERENCE = {
    "jw06_trajectory": (C.jw06_trajectory,
                        lambda: (series("jw_psmin_series.npz"),)),
    "phase_structure_480": (lambda ps: C.phase_structure(ps, True),
                            lambda: (series("jw_psmin_series.npz"),)),
    "phase_structure_240": (lambda ps: C.phase_structure(ps, False),
                            lambda: (series("jw_psmin_10242.npz"),)),
    "phase_structure_120": (
        lambda ps: C.phase_structure(ps, True) + C.deep_but_bounded(ps),
        lambda: (series("jw_psmin_40962.npz"),)),
    "day15_production_240": (lambda a: C.day15(a, strict=False),
                             lambda: (art("jw15_10242.npz"),)),
    "day15_production_120": (lambda a: C.day15(a, strict=False),
                             lambda: (art("jw15_40962.npz"),)),
    "resolution_convergence": (
        C.resolution_convergence,
        lambda: (series("jw_psmin_series.npz"), series("jw_psmin_40962.npz"))),
    "three_resolution_convergence": (
        C.three_resolution_convergence,
        lambda: (series("jw_psmin_series.npz"), series("jw_psmin_10242.npz"),
                 series("jw_psmin_40962.npz"))),
    "mountain_wave": (C.mountain_wave, lambda: (art("mw_state.npz"),)),
    "supercell": (C.supercell, lambda: (art("supercell_state.npz"),)),
    "moist_kessler": (C.moist_kessler, lambda: (art("jw15_moist.npz"),)),
    "moist_wsm6": (C.moist_wsm6, lambda: (art("jw15_moist_wsm6.npz"),)),
    "radiation_coupled": (C.radiation_coupled,
                          lambda: (art("jw_radiation_10242.npz"),)),
}

# (reference case, corruption of its arguments, checks that must fail)
CORRUPTED = [
    ("jw06_trajectory", lambda ps: (flat(ps),),
     {"growth_by_day12_pa", "deep_low_pa", "jw06_day10_gap_pa",
      "deepening_min_day"}),
    ("phase_structure_480", lambda ps: (flat(ps),),
     {"explosive_by_day9_pa", "growth_by_day7_pa"}),
    ("phase_structure_240", lambda ps: (flat(ps),), {"explosive_by_day9_pa"}),
    ("day15_production_240", lambda a: (nan_w(a),),
     {"w_finite", "w_max_abs"}),
    ("day15_production_120", lambda a: (nan_w(a),),
     {"w_finite", "w_max_abs"}),
    ("resolution_convergence", lambda c, f: (c, flat(f)),
     {f"finer_deeper_day{d}_pa" for d in range(8, 13)}),
    ("three_resolution_convergence", lambda c, m, f: (c, flat(m), f),
     {f"coarse_lags_mid_day{d}_pa" for d in range(8, 12)}),
    ("mountain_wave", lambda a: (wave_off_the_mountain(a),),
     {"forced_layer_corr", "z1km_corr", "far_over_near_rms"}),
    ("mountain_wave", lambda a: (nan_w(a),), {"w_finite"}),
    ("supercell", lambda a: (negative_vapour(a),), {"scalars_min"}),
    ("supercell", lambda a: (rain_not_monotone(a),), {"rain_step_min_mm"}),
    ("supercell", lambda a: (nan_w(a),), {"w_max_abs"}),
    ("moist_kessler", lambda a: (negative_vapour(a),), {"qv_min"}),
    ("moist_kessler", lambda a: (rain_not_monotone(a),),
     {"rain_step_min_mm"}),
    ("moist_kessler", lambda a: (nan_w(a),), {"finite", "w_max_abs"}),
    ("moist_wsm6", lambda a: (negative_vapour(a),), {"scalars_min"}),
    ("moist_wsm6", lambda a: (rain_not_monotone(a),), {"rain_step_min_mm"}),
    ("radiation_coupled", lambda a: (negative_vapour(a),), {"qv_min"}),
    ("radiation_coupled", lambda a: (nan_w(a),), {"u_w_finite", "w_max_abs"}),
]


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_checks_pass_on_the_reference_artifact(name):
    fn, args = REFERENCE[name]
    out = fn(*args())
    assert out and all(isinstance(c, C.Check) for c in out)
    assert len({c.name for c in out}) == len(out)
    assert C.failed(out) == [], C.failed(out)


@pytest.mark.parametrize("case", range(len(CORRUPTED)),
                         ids=[f"{n}-{sorted(e)[0]}" for n, _, e in CORRUPTED])
def test_checks_fail_on_a_corrupted_copy(case):
    name, corrupt, expect = CORRUPTED[case]
    fn, args = REFERENCE[name]
    failed = {c.name for c in C.failed(fn(*corrupt(*args())))}
    assert expect <= failed, (expect, failed)


def test_strict_day15_on_the_generated_240km_mesh():
    """TestDay15's own checks (the 480 km run's: a quiet southern
    hemisphere, |w| < 0.5) on the 240 km artifact: all hold but the
    southern hemisphere's, which the reference holds only at 480 km."""
    out = C.day15(art("jw15_10242.npz"), strict=True)
    assert [c.name for c in C.failed(out)] == ["sh_over_nh_amplitude"]
    assert len(out) == len(C.day15(art("jw15_10242.npz"), strict=False)) + 1


def test_reference_artifacts_are_opened_read_only():
    before = {p.name: p.stat().st_mtime_ns for p in VDIR.iterdir()}
    assert common.load_reference("jw_psmin_10242.npz")["ps_min"].shape == (16,)
    assert common.load_reference("absent.npz") is None
    with pytest.raises(ValueError, match="read and never written"):
        common.write_artifacts({"x.npz": {"a": np.zeros(1)}}, str(VDIR))
    assert {p.name: p.stat().st_mtime_ns for p in VDIR.iterdir()} == before


def test_vs_reference_series_by_phase():
    ref = series("jw_psmin_10242.npz")
    port = ref.copy()
    port[3] += 10.0
    port[9] -= 300.0
    port[15] += 40.0
    gap = C.vs_reference_series(port, ref)
    assert gap["days_0_7"] == pytest.approx(10.0)
    assert gap["days_8_10"] == pytest.approx(300.0)
    assert gap["days_11_15"] == pytest.approx(40.0)
    assert len(gap["by_day"]) == 16
    assert C.vs_reference_series(ref, ref)["days_11_15"] == 0.0


def test_the_reference_fails_three_jw06_checks_on_the_generated_480km_mesh():
    """mpas_tpu's own series of the jw480 preset (generate_mesh(4), not the
    x1.2562 grid file the TPU series ran on) fails the onset, day-9 and
    monotone-deepening checks; the finer presets have no such series."""
    failed = {k for k, ok in jw.same_mesh_verdicts("jw480").items() if not ok}
    assert failed == {"jw06_day7_gap_pa", "jw06_day9_gap_pa",
                      "deepening_step_max_pa"}
    assert jw.same_mesh_verdicts("jw120") == {}
    assert len(jw.SAME_MESH_PS_MIN["jw480"]) == jw.DAYS + 1


def test_same_mesh_series_is_the_references_first_day():
    """The first day of SAME_MESH_PS_MIN["jw480"] is what
    tests/validation_reference.py gives (mpas_tpu, float32, on the CPU)."""
    ps = validation_reference.jw_ps_min(days=1)
    np.testing.assert_allclose(ps, jw.SAME_MESH_PS_MIN["jw480"][:2], atol=1.0)


def test_digitized_jw06_table_matches_the_golden_csv():
    d = np.loadtxt(REPO / "tests" / "golden" / "jw06_psmin_digitized.csv",
                   delimiter=",")
    np.testing.assert_array_equal(np.array(C.JW06_PSMIN_DIGITIZED), d)


@pytest.mark.parametrize("levels", [4, 5, 6])
def test_mountain_wave_namelist_matches_the_tool(levels):
    nl, X = mountain_wave.make_namelist(levels)
    ref, X_ref = mountain_wave_run.make_namelist(levels)
    assert isinstance(ref, JNamelist) and X == X_ref
    assert as_mpas_tpu(nl.to_dict()) == ref.to_dict()


class FakeModel:
    """What timed_loop uses of a Model: step, step_count, device and dt."""

    def __init__(self):
        self.step_count = 0
        self.device = torch.device("cpu")
        self.namelist = types.SimpleNamespace(config_dt=300.0)

    def step(self, n=1):
        self.step_count += n


def test_timed_loop_records_and_hooks_where_the_tools_do():
    m, hooks, logged = FakeModel(), [], []
    recs, timing = common.timed_loop(
        m, 30, 12, lambda mm: mm.step_count,
        hook=lambda mm, step: hooks.append((step, mm.step_count)),
        hook_every=4, log=logged.append)
    assert recs == logged == [12, 24, 30]
    assert hooks == [(s, s) for s in range(0, 30, 4)]
    assert m.step_count == 30
    assert timing["ms_per_step"] >= 0.0 and timing["wall_s"] >= 0.0
    assert timing["sim_days_per_wall_hour"] > 0.0


def test_cli_runs_a_cut_preset_on_the_cpu(tmp_path, capsys):
    rc = cli.main(["supercell", "--device", "cpu", "--levels", "2",
                   "--steps", "2", "--out", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == 0 and len(out) == 2 and len(line["records"]) == 1
    assert line["preset"] == "supercell" and line["cells"] == 162
    assert line["steps"] == 2 and line["levels"] == 24 and not line["full"]
    assert line["checks"] == [] and line["failed"] == []
    assert "checks_skipped" in line
    with np.load(tmp_path / "supercell_state.npz") as d:
        assert d["wmax_series"].shape == (1,)
        assert d["scalars"].shape == (6, 24, 162)


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["jw480", "--steps", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_convergence_on_three_series(tmp_path, capsys):
    for src, cells in (("jw_psmin_series.npz", 2562),
                       ("jw_psmin_10242.npz", 10242),
                       ("jw_psmin_40962.npz", 40962)):
        shutil.copy(VDIR / src, tmp_path / f"jw_psmin_{cells}.npz")
    assert cli.main(["convergence", "--out", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["failed"] == [] and len(line["checks"]) == 25
    d = dict(np.load(tmp_path / "jw_psmin_40962.npz"))
    d["ps_min"] = flat(d["ps_min"])
    np.savez(tmp_path / "jw_psmin_40962.npz", **d)
    assert cli.main(["convergence", "--out", str(tmp_path)]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "finer_deeper_day8_pa" in line["failed"]
