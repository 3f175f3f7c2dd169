"""Physical and numerical constants for the MPAS-Atmosphere dycore (a copy of
mpas_tpu.constants).

Names follow the MPAS convention so the code is auditable against the
reference (see the Regent reference's constants.rg and MPAS constants.F); values are
the standard MPAS ones.
"""

import math

pii = 3.141592653589793

# --- planetary / thermodynamic constants (constants.rg:27-39) ---
sphere_radius = 6371229.0        # Earth radius [m]
omega = 7.29212e-5               # rotation rate [s-1]
gravity = 9.80616                # [m s-2]
rgas = 287.0                     # gas constant, dry air [J kg-1 K-1]
rv = 461.6                       # gas constant, water vapor
cp = 7.0 * rgas / 2.0            # 1004.5
cv = cp - rgas                   # 717.5
cvpm = -cv / cp
rvord = rv / rgas
rcv = rgas / (cp - rgas)         # R/cv
p0 = 1.0e5                       # reference pressure [Pa]
t00 = 273.15
seconds_per_day = 86400.0
prandtl = 1.0

# --- radiation-physics constants (constants.rg:71-152, mpas_atmphys_constants) ---
R_d = rgas
R_v = 461.6
ep_1 = R_v / R_d - 1.0
ep_2 = R_d / R_v
cpv = 4.0 * R_v
rdg = R_d / gravity
rcp = R_d / cp
stbolt = 5.67051e-8
mwdry = 28.966
mwco2 = 44.0
tmelt = 273.16
daysperyear = 365
solcon_0 = 1370.0
amd = 28.9644
amo = 48.0000
degrad = 3.1415926 / 180.0
dpd = 360.0 / 365.0

rho_a = 1.28
rho_r = 1000.0
rho_s = 100.0
rho_w = 1000.0

svp1 = 0.6112
svp2 = 17.67
svp3 = 29.65
svpt0 = 273.15

xlv = 2.50e6
xlf = 3.50e5
xls = xlv + xlf
xlv0 = 3.15e6
xlv1 = 2370.0
xls0 = 2.905e6
xls1 = 259.532

karman = 0.4
eomeg = 7.29210e-5
cliq = 4190.0
cice = 2106.0
epsilon_small = 1.0e-15
psat = 610.78

# saturation-table dimensions (constants.rg:94-97)
min_tp_h2o = 160.0
max_tp_h2o = 349.999999
ntemp = 192
plenest = 250

nAerLevels = 29
nOznLevels = 59
nAerosols = 12
naer = 10
naer_all = 12
nMonths = 12
cam_abs_dim1 = 4
