"""mpas_tpu_torch's numpy copies against mpas_tpu: the mesh, its coefficients,
the vertical grid and the initial state of every case (JW, mountain wave,
squall line) are equal array for array; the namelist has the same names and defaults; the package imports no JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mpas_tpu import config as j_config
from mpas_tpu import constants as j_constants
from mpas_tpu.core.vertical import make_vertical_grid as j_vgrid
from mpas_tpu.init import mountain_wave as j_mw
from mpas_tpu.init import squall as j_sq
from mpas_tpu.init.jw import init_jw as j_init_jw
from mpas_tpu.mesh import coefficients as j_coef
from mpas_tpu.mesh.generator import generate_mesh as j_generate

from mpas_tpu_torch import config as t_config
from mpas_tpu_torch import constants as t_constants
from mpas_tpu_torch.core.vertical import make_vertical_grid as t_vgrid
from mpas_tpu_torch.init import mountain_wave as t_mw
from mpas_tpu_torch.init import squall as t_sq
from mpas_tpu_torch.init.jw import init_jw as t_init_jw
from mpas_tpu_torch.mesh import coefficients as t_coef
from mpas_tpu_torch.mesh.generator import generate_mesh as t_generate

REPO = Path(__file__).resolve().parents[1]


def assert_same(a, b, what=""):
    """Every array field of two dataclasses / dicts is array_equal."""
    if dataclasses.is_dataclass(a):
        a, b = vars(a), vars(b)
    assert set(a) == set(b), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y),
                                  equal_nan=True), f"{what}.{k}"
        else:
            assert x == y, f"{what}.{k}"


# the port's own namelist keys (the radiation on Model.step's alarm), which
# mpas_tpu's namelist lacks, with their defaults
PORT_ONLY = {"config_radt_lw_scheme": "off", "config_radt_sw_scheme": "off",
             "config_radtlw_interval": 1800.0,
             "config_radtsw_interval": 1800.0}


def as_mpas_tpu(d: dict) -> dict:
    """A port namelist's dict as mpas_tpu's namelist takes it: the port's
    own keys, which must hold their defaults, left out."""
    d = dict(d)
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return d


@pytest.fixture(scope="module")
def meshes():
    return (j_generate(levels=3, lloyd_iterations=2),
            t_generate(levels=3, lloyd_iterations=2))


@pytest.fixture(scope="module")
def deriv_twos(meshes):
    return j_coef.compute_deriv_two(meshes[0]), t_coef.compute_deriv_two(meshes[1])


def test_namelist_names_and_defaults():
    """The port's namelist is mpas_tpu's, name for name and default for
    default, plus its own radiation keys (radiation on Model.step's
    alarm), off by default."""
    j = dataclasses.asdict(j_config.Namelist())
    assert as_mpas_tpu(dataclasses.asdict(t_config.Namelist())) == j
    assert (as_mpas_tpu(dataclasses.asdict(t_config.REFERENCE_NAMELIST))
            == dataclasses.asdict(j_config.REFERENCE_NAMELIST))


def test_constants_equal():
    names = [n for n in dir(j_constants) if not n.startswith("_")
             and isinstance(getattr(j_constants, n), (int, float))]
    assert names
    for n in names:
        assert getattr(t_constants, n) == getattr(j_constants, n), n


def test_generated_mesh_equal(meshes):
    assert_same(meshes[0], meshes[1], "mesh")


@pytest.mark.parametrize("name", [
    "compute_deriv_two", "compute_reconstruct_coefficients",
    "compute_reconstruct_coefficients_rbf", "compute_deformation_weights",
    "compute_mesh_scaling"])
def test_coefficients_equal(meshes, name):
    a = getattr(j_coef, name)(meshes[0])
    b = getattr(t_coef, name)(meshes[1])
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b, strict=True):
        assert np.array_equal(x, y), name


def test_advection_coefficients_equal(meshes, deriv_twos):
    a = j_coef.compute_advection_coefficients(meshes[0], deriv_twos[0], 0.25)
    b = t_coef.compute_advection_coefficients(meshes[1], deriv_twos[1], 0.25)
    assert_same(a, b, "adv")


@pytest.mark.parametrize("nlev,ztop", [(8, 30000.0), (41, 30000.0),
                                       (26, 45000.0)])
def test_vertical_grid_equal(nlev, ztop):
    assert_same(j_vgrid(nlev, ztop), t_vgrid(nlev, ztop), "vgrid")


@pytest.mark.parametrize("pert", [0.0, 1.0])
def test_jw_init_equal(meshes, deriv_twos, pert):
    kw = dict(config_nvertlevels=8, config_ztop=30000.0,
              config_jw_u_perturbation=pert)
    sj, ij = j_init_jw(meshes[0], j_vgrid(8, 30000.0),
                       j_config.Namelist(**kw), deriv_twos[0])
    st, it = t_init_jw(meshes[1], t_vgrid(8, 30000.0),
                       t_config.Namelist(**kw), deriv_twos[1])
    assert_same(sj, st, "static")
    assert_same(ij, it, "init")


SMALL_PLANET = dict(config_coriolis=False, config_vertical_stretch=1.0,
                    config_sphere_radius=6371229.0 / 200.0,
                    config_nvertlevels=16, config_ztop=20000.0,
                    config_zd=14000.0, config_xnutr=0.3)


@pytest.fixture(scope="module")
def small_planet():
    """Level-3 meshes of the reduced planet and their deriv_two, both
    packages."""
    r = SMALL_PLANET["config_sphere_radius"]
    mj = j_generate(levels=3, lloyd_iterations=3, sphere_radius=r)
    mt = t_generate(levels=3, lloyd_iterations=3, sphere_radius=r)
    return (mj, j_coef.compute_deriv_two(mj)), (mt, t_coef.compute_deriv_two(mt))


@pytest.mark.parametrize("changes", [
    dict(), dict(config_mtn_h0=500.0, config_mtn_halfwidth=20000.0,
                 config_mtn_wavelength=80000.0, config_mtn_u0=10.0)],
    ids=["defaults", "wide_mountain"])
def test_mountain_wave_init_equal(small_planet, changes):
    kw = dict(SMALL_PLANET, config_init_case=21, **changes)
    (mj, dj), (mt, dt) = small_planet
    sj, ij = j_mw.init_mountain_wave(mj, j_vgrid(16, 20000.0, 1.0),
                                     j_config.Namelist(**kw), dj)
    st, it = t_mw.init_mountain_wave(mt, t_vgrid(16, 20000.0, 1.0),
                                     t_config.Namelist(**kw), dt)
    assert np.abs(sj["zgrid"][:, 0]).max() > 100.0       # there is a mountain
    assert_same(sj, st, "static")
    assert_same(ij, it, "init")
    nl = t_config.Namelist(**kw)
    assert np.array_equal(j_mw.schar_mountain(mj, nl),
                          t_mw.schar_mountain(mt, nl))
    x = np.linspace(-2e4, 2e4, 64)
    z = np.array([500.0, 4000.0])
    assert np.array_equal(j_mw.linear_schar_solution(x, z, nl),
                          t_mw.linear_schar_solution(x, z, nl))


@pytest.mark.parametrize("changes", [
    dict(config_moisture=True), dict(config_moisture=False),
    dict(config_moisture=True, config_sq_bubble_dtheta=0.0,
         config_sq_shear_u=0.0)], ids=["moist", "dry", "no_bubble_no_shear"])
def test_squall_init_equal(small_planet, changes):
    kw = dict(SMALL_PLANET, config_init_case=22, **changes)
    (mj, dj), (mt, dt) = small_planet
    sj, ij = j_sq.init_squall(mj, j_vgrid(16, 20000.0, 1.0),
                              j_config.Namelist(**kw), dj)
    st, it = t_sq.init_squall(mt, t_vgrid(16, 20000.0, 1.0),
                              t_config.Namelist(**kw), dt)
    assert (ij["qv"].max() > 0.01) == kw["config_moisture"]
    assert_same(sj, st, "static")
    assert_same(ij, it, "init")
    z = np.linspace(0.0, 18000.0, 50)
    nl = t_config.Namelist(**kw)
    for a, b in zip(j_sq.wk_sounding(z, nl), t_sq.wk_sounding(z, nl),
                    strict=True):
        assert np.array_equal(a, b)


def test_package_imports_no_jax():
    """Importing mpas_tpu_torch and every submodule loads neither jax nor
    mpas_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mpas_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "mpas_tpu_torch.__path__, 'mpas_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mpas_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 50, names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
