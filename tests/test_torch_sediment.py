"""physics/sediment.py (Kernel 5's wrapper and its plain version) on the
CPU: the plain version bit-equal to `kessler.sediment` species by species,
the wrapper's refusals, one call of it per scheme update, the schemes
against mpas_tpu at the substep counts a run sizes, and the fall-law
constants written into csrc/sediment.cu against the physics modules'. The
kernel itself is held against the plain version on the card
(tests/test_torch_gpu.py)."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpas_tpu.physics import kessler as JK
from mpas_tpu.physics import wsm6 as JW

from mpas_tpu_torch import cuda_build
from mpas_tpu_torch.physics import kessler as TK
from mpas_tpu_torch.physics import sediment as K5
from mpas_tpu_torch.physics import wsm6 as TW

from test_torch_ops import assert_close
from test_torch_physics import DT, both, columns

FALL = {"rain": TK._fall_velocity, "snow": TW._snow_fall_velocity,
        "graupel": TW._graupel_fall_velocity}
SPECIES_OF = {"rain": "qr", "snow": "qs", "graupel": "qg"}
LAW_SETS = [("rain",), ("snow",), ("graupel",), ("rain", "snow"),
            ("snow", "graupel"), ("rain", "snow", "graupel"),
            ("graupel", "rain", "rain")]
# each scheme's inputs before (rho, exner, p, dz)
SCHEME_INPUTS = {"kessler": ("theta", "qv", "qc", "qr"),
                 "wsm6lite": ("theta", "qv", "qc", "qr", "qi", "qs"),
                 "wsm6full": ("theta", "qv", "qc", "qr", "qi", "qs", "qg")}


def inputs(laws, dtype, seed=0):
    """(qs, rho, dz) as torch tensors of `dtype` from `columns`: each law's
    own species, every species active across the freezing level."""
    c = columns(285.0, seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return [t(c[SPECIES_OF[law]]) for law in laws], t(c["rho"]), t(c["dz"])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("laws", LAW_SETS, ids="-".join)
@pytest.mark.parametrize("nfall", [1, 7])
def test_plain_is_kessler_sediment_species_by_species(laws, dtype, nfall):
    """Bit-equal to `kessler.sediment` with each law, and so is the wrapper
    on the CPU; nothing is written into an input."""
    qs, rho, dz = inputs(laws, dtype)
    before = [t.clone() for t in (*qs, rho, dz)]
    want = [TK.sediment(q, rho, dz, DT, nfall, FALL[law])
            for q, law in zip(qs, laws)]
    K5.launches = 0
    for fn in (K5.sediment_species_plain, K5.sediment_species):
        q_new, acc = fn(qs, laws, rho, dz, DT, nfall)
        assert len(q_new) == len(acc) == len(laws)
        for (wq, wa), q, a in zip(want, q_new, acc):
            assert q.dtype == a.dtype == dtype
            assert torch.equal(q, wq) and torch.equal(a, wa)
            assert float(a.min()) > 0.0          # it reached the ground
    assert K5.launches == 0                      # the CPU launches nothing
    for b, t in zip(before, (*qs, rho, dz)):
        assert torch.equal(b, t)


def _bad(case):
    """The wrapper's arguments with one thing wrong."""
    qs, rho, dz = inputs(("rain", "snow"), torch.float64)
    args = dict(qs=qs, laws=("rain", "snow"), rho=rho, dz=dz, dt=DT, nfall=4)
    if case == "dz_shape":
        args["dz"] = dz[:, :-1]
    elif case == "q_shape":
        args["qs"] = [qs[0], qs[1][:-1]]
    elif case == "rho_1d":
        args["rho"] = rho[0]
    elif case == "nfall_0":
        args["nfall"] = 0
    elif case == "nfall_negative":
        args["nfall"] = -3
    elif case == "nfall_fraction":
        args["nfall"] = 2.5
    elif case == "unknown_law":
        args["laws"] = ("rain", "hail")
    elif case == "laws_short":
        args["laws"] = ("rain",)
    elif case == "no_species":
        args["qs"], args["laws"] = [], ()
    elif case == "four_species":
        args["qs"] = qs * 2
        args["laws"] = ("rain", "snow") * 2
    return args


@pytest.mark.parametrize("case", [
    "dz_shape", "q_shape", "rho_1d", "nfall_0", "nfall_negative",
    "nfall_fraction", "unknown_law", "laws_short", "no_species",
    "four_species"])
def test_wrapper_rejects_bad_arguments(case):
    with pytest.raises(ValueError, match="sediment_species"):
        K5.sediment_species(**_bad(case))


@pytest.mark.parametrize("scheme,laws", [
    ("kessler", [("rain",)]), ("wsm6lite", [("rain", "snow")]),
    ("wsm6full", [("rain", "snow", "graupel")])])
def test_one_call_per_scheme_update(monkeypatch, scheme, laws):
    """Each scheme sediments all its species through one call, with the
    laws of its own species list."""
    seen = []
    real = K5.sediment_species

    def spy(qs, lw, *args):
        seen.append(tuple(lw))
        return real(qs, lw, *args)

    monkeypatch.setattr(TK, "sediment_species", spy)
    monkeypatch.setattr(TW, "sediment_species", spy)
    names = SCHEME_INPUTS[scheme]
    _, t_in = both(columns(285.0), names + ("rho", "exner", "p", "dz"))
    fn = TK.kessler if scheme == "kessler" else getattr(TW, scheme)
    fn(*t_in, DT, 4)
    assert seen == laws


@pytest.mark.parametrize("scheme", ["kessler", "wsm6lite", "wsm6full"])
@pytest.mark.parametrize("t_sfc", [300.0, 262.0])
def test_schemes_match_at_the_sized_substeps(scheme, t_sfc):
    """The three schemes against mpas_tpu at the substep count a run sizes
    from dt 300 s and the columns' layers (fall_substeps), float64, at the
    tolerance of the schemes' tests at nfall 4."""
    c = columns(t_sfc, seed=7)
    nfall = TK.fall_substeps(300.0, float(c["dz"].min()),
                             TW.max_fall_speed(full=scheme == "wsm6full"))
    assert nfall == JK.fall_substeps(300.0, float(c["dz"].min())) > 4
    names = SCHEME_INPUTS[scheme]
    j_in, t_in = both(c, names + ("rho", "exner", "p", "dz"))
    J, T = (JK, TK) if scheme == "kessler" else (JW, TW)
    assert_close(getattr(J, scheme)(*j_in, 300.0, nfall),
                 getattr(T, scheme)(*t_in, 300.0, nfall))


def test_kernel_constants_are_the_physics_modules():
    """csrc/sediment.cu writes the fall laws' constants out; they must be
    the ones the plain laws use."""
    src = (Path(cuda_build.CSRC) / "sediment.cu").read_text()
    found = dict(re.findall(r"constexpr double (\w+) = ([0-9.e+-]+);", src))
    want = {"MAX_VT": TK.MAX_VT, "MAX_VT_SNOW": TW.MAX_VT_SNOW,
            "MAX_VT_GRAUPEL": TW.MAX_VT_GRAUPEL,
            "GRAUPEL_VCOEF": TW.GRAUPEL_VCOEF,
            "GRAUPEL_PIRN": TW.GRAUPEL_PIRN, "RAIN_COEF": 36.34,
            "RAIN_SCALE": 0.001, "RAIN_EXPONENT": 0.1364,
            "SNOW_COEF": 11.72, "SNOW_EXPONENT": 0.25,
            "GRAUPEL_EXPONENT": 0.2, "RHO_MIN": 1e-12}
    assert {k: float(found[k]) for k in want} == want
    # the literals of the plain laws are the ones listed above
    for fn, lits in ((TK._fall_velocity, ("36.34", "0.001", "0.1364")),
                     (TW._snow_fall_velocity, ("11.72", "0.25")),
                     (TW._graupel_fall_velocity, ("0.2",)),
                     (TK.density_factor, ("1e-12",))):
        body = inspect.getsource(fn)
        assert all(lit in body for lit in lits), fn.__name__
    assert tuple(re.findall(r"enum Law : int \{ (.*) \};", src)[0]
                 .replace(" = ", "=").split(", ")) == tuple(
        f"{law.upper()}={i}" for i, law in enumerate(K5.LAWS))
