"""`python -m mpas_tpu_torch` (mpas_tpu_torch.__main__.main) on the CPU.

  - a run with radiation every 2 steps, a history every 2 steps and a
    checkpoint every 2 steps returns 0, and its history file matches the
    one `python -m mpas_tpu` writes on the same flags at 1e-10 (4 float64
    steps on the 162-cell generated mesh, 6 levels);
  - 2 steps, a restart from the checkpoint and 2 more steps give the
    history of 4 straight steps, bit for bit;
  - the same with --shards 2 (the stacked back end in one process): its
    history matches `python -m mpas_tpu --shards 2`'s at 1e-10 and the
    single-device one's, its checkpoint is mpas_tpu's 2-shard layout, and
    its restart is bit-equal;
  - what the port refuses it refuses with a clear message: --shards N
    under another number of processes, --device cuda without a card, bad
    --levels / --radt-steps;
  - every examples/namelist.* file loads through the port's Namelist.

The generated mesh is cached under $HOME, which each test points at its own
temporary directory."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mpas_tpu import __main__ as j_cli
from mpas_tpu.config import Namelist as JNamelist

from mpas_tpu_torch import __main__ as t_cli
from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.mesh.netcdf_io import read_netcdf

from test_torch_ops import assert_close

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["--grid", "generate:2", "--levels", "6", "--dtype", "float64",
         "--steps", "4", "--physics", "--radt-steps", "2", "--history-every",
         "2", "--checkpoint-every", "2", "--output-full-3d", "--quiet"]


def run(cli, tmp, *extra, device=True):
    """Run a CLI's main in `tmp`; returns (exit code, history path,
    checkpoint path)."""
    out, ck = str(tmp / "out.nc"), str(tmp / "ck.npz")
    argv = FLAGS + ["--output", out, "--checkpoint-path", ck, *extra]
    if device:
        argv += ["--device", "cpu"]
    return cli.main(argv), out, ck


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def test_cli_matches_jax_cli(home):
    (home / "t").mkdir()
    (home / "j").mkdir()
    rc, t_out, t_ck = run(t_cli, home / "t")
    assert rc == 0
    rc_j, j_out, _ = run(j_cli, home / "j", device=False)
    assert rc_j == 0
    a, b = read_netcdf(j_out), read_netcdf(t_out)
    assert set(a) == set(b) and a["_dims"] == b["_dims"]
    assert b["_dims"]["Time"] == 2 and b["_dims"]["nCells"] == 162
    np.testing.assert_array_equal(b["xtime"], [2.0, 4.0])
    for k in a:
        if k != "_dims":
            assert a[k].shape == b[k].shape, k
            assert_close(a[k], b[k], rtol=1e-10)
    with np.load(t_ck) as f:
        assert int(f["__step_count__"]) == 4
        # the radiation heating went into the state the run ended with
        assert np.abs(f["rt_diabatic_tend"]).max() > 0.0


def test_cli_restart_is_exact(home):
    straight, half = home / "straight", home / "half"
    straight.mkdir()
    half.mkdir()
    rc, ref, _ = run(t_cli, straight)
    assert rc == 0
    two = [a if a != "4" else "2" for a in FLAGS]
    out, ck = str(half / "a.nc"), str(half / "ck.npz")
    assert t_cli.main(two + ["--output", out, "--checkpoint-path", ck,
                             "--device", "cpu"]) == 0
    out2 = str(half / "b.nc")
    assert t_cli.main(two + ["--output", out2, "--checkpoint-path",
                             str(half / "ck2.npz"), "--restart", ck,
                             "--device", "cpu"]) == 0
    a, b = read_netcdf(ref), read_netcdf(out2)
    np.testing.assert_array_equal(b["xtime"], [4.0])
    for k in ("u", "v", "w", "theta", "rho", "pressure", "pressure_p",
              "surface_pressure"):
        assert np.array_equal(a[k][-1], b[k][-1]), k


def same_history(a, b, rtol):
    a, b = read_netcdf(a), read_netcdf(b)
    assert set(a) == set(b) and a["_dims"] == b["_dims"]
    for k in a:
        if k != "_dims":
            assert a[k].shape == b[k].shape, k
            assert_close(a[k], b[k], rtol=rtol)


def test_cli_shards_matches_jax_cli(home):
    for d in ("t", "j", "single"):
        (home / d).mkdir()
    rc, t_out, t_ck = run(t_cli, home / "t", "--shards", "2")
    assert rc == 0
    rc_j, j_out, j_ck = run(j_cli, home / "j", "--shards", "2", device=False)
    assert rc_j == 0
    same_history(j_out, t_out, 1e-10)
    # the decomposition does not change the answer
    assert run(t_cli, home / "single")[0] == 0
    same_history(str(home / "single" / "out.nc"), t_out, 1e-10)
    with np.load(t_ck) as f, np.load(j_ck) as g:
        assert int(f["__n_shards__"]) == int(g["__n_shards__"]) == 2
        assert int(f["__step_count__"]) == 4
        assert set(f.files) == set(g.files)
        for k in f.files:
            assert f[k].shape == g[k].shape, k


def test_cli_sharded_restart_is_exact(home):
    straight, half = home / "straight", home / "half"
    straight.mkdir()
    half.mkdir()
    rc, ref, _ = run(t_cli, straight, "--shards", "2")
    assert rc == 0
    two = [a if a != "4" else "2" for a in FLAGS] + ["--shards", "2",
                                                     "--device", "cpu"]
    ck = str(half / "ck.npz")
    assert t_cli.main(two + ["--output", str(half / "a.nc"),
                             "--checkpoint-path", ck]) == 0
    out2 = str(half / "b.nc")
    assert t_cli.main(two + ["--output", out2, "--checkpoint-path",
                             str(half / "ck2.npz"), "--restart", ck]) == 0
    a, b = read_netcdf(ref), read_netcdf(out2)
    for k in ("u", "v", "w", "theta", "rho", "pressure", "pressure_p",
              "surface_pressure"):
        assert np.array_equal(a[k][-1], b[k][-1]), k
    # a 2-shard checkpoint does not restore into a single-device run
    with pytest.raises(ValueError, match="shards"):
        t_cli.main(two[:-4] + ["--device", "cpu", "--output",
                               str(half / "c.nc"), "--restart", ck])


def test_cli_refuses_shards(capsys, monkeypatch):
    """--shards N must match the number of processes it runs in."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit) as e:
        t_cli.main(["--shards", "2", "--device", "cpu"])
    assert e.value.code == 2
    assert "one process per shard" in capsys.readouterr().err


@pytest.mark.parametrize("flags,message", [
    (["--levels", "2"], "--levels must be >= 3"),
    (["--physics", "--radt-steps", "0"], "--radt-steps must be >= 1")])
def test_cli_refuses_bad_flags(capsys, flags, message):
    with pytest.raises(SystemExit):
        t_cli.main(flags + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def test_cli_cuda_without_a_card_raises(home):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--grid", "generate:2", "--levels", "4", "--steps", "1",
                    "--output", str(home / "x.nc"), "--quiet"])
    assert not (home / "x.nc").exists()


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "examples").glob("namelist.*")))
def test_example_namelists_load(name):
    path = str(REPO / "examples" / name)
    nl = Namelist.from_file(path)
    assert dataclasses.asdict(nl) == dataclasses.asdict(
        JNamelist.from_file(path))
    assert nl != Namelist()
