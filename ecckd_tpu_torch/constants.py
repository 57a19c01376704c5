"""Physical constants of the ecCKD gas-optics model.

Values match the reference implementation (rte-ecckd
src/gas_optics_ecckd.f90:51-53) and the JAX package's
``ecckd_tpu/constants.py`` digit for digit, so that optical depths and
Planck sources agree to working precision.
"""

GRAVITY = 9.80665
"""Acceleration due to gravity [m s-2]."""

DRY_AIR_MOLAR_MASS = 28.970
"""Dry-air molar mass [g mol-1]."""

PI = 3.14159265359
"""pi as spelled in the reference (gas_optics_ecckd.f90:53); used for the
flux -> intensity conversion of Planck sources.  Deliberately NOT
``math.pi``: the LW pi*B round trip (solvers/lw.py) depends on the
division and the 2*PI multiplication using this same constant."""

MOLES_PER_PA = 1.0 / (GRAVITY * 0.001 * DRY_AIR_MOLAR_MASS)
"""Moles of dry air per m^2 per Pa of pressure thickness
(``global_weight`` in gas_optics_ecckd.f90:107)."""

# Concentration-dependence codes stored in ckd-definition files
# (gas_optics_ecckd.f90:54-57).
CONC_NONE = 0  # composite gas: no concentration dependence
CONC_LINEAR = 1  # tau linear in vmr
CONC_LUT = 2  # look-up-table in log(vmr) (h2o)
CONC_RELATIVE_LINEAR = 3  # tau linear in (vmr - reference vmr)

# Specific heat of dry air at constant pressure [J kg-1 K-1]; used only by the
# heating-rate diagnostic (an extension; the reference computes fluxes only).
CP_DRY_AIR = 1004.64
SECONDS_PER_DAY = 86400.0
