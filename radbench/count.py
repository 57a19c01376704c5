"""The work a call of the merged LW + SW solve needs, and the least time
an H100 could take for it: the yardstick of the roofline metrics.

The count is of the function, not of a kernel: it reads the ckd files'
gases and g-points and the call's shapes, so a change that splits, fuses
or renames kernels leaves it as it is.  Float operations count an add,
multiply, compare or select as 1 (an FMA as 2) and each accurate library
call at the operations of its CUDA implementation: expm1f 20, logf 15, a
division 8, sqrtf 6.

* Per (column, layer): the interpolation point 41; per table gas its
  weight 3, per look-up-table gas its index 30; LW 2 Planck points of 12.
* Per (column, layer, g-point): a table gas 12 (bilinear 9, weight,
  clamp, sum), a look-up-table gas 25; LW 2 Planck values of 12 and per
  angle the layer sources 42 and one step of the down and up sweeps with
  their g-sums 6; SW the Rayleigh sum and two-stream 136 and the direct
  and adding sweeps 43.

Bytes: each input read once and each output written once, float32: the
levels' pressure and temperature, the layers' temperature, the profile
and per-column gases, the surface temperature, the surface emissivity and
albedo per g-point, mu0 and the TSI scale per column, each model's tables
(its gases' rows over the (p, T) grid and the first temperature column),
the Planck table, the solar and Rayleigh arrays, and four (ncol, nlay + 1)
flux outputs.

Peaks: NVIDIA's data sheet for the H100 SXM, 67 TFLOP/s in float32
outside the tensor cores and 3.35 TB/s of HBM3, at 700 W.
"""
from __future__ import annotations

from radbench.reference.ckd import NONE, Ckd

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
OPS = dict(dense=12, lut=25, planck=12, lw_sources=42, lw_sweep=6,
           sw_optics=136, sw_sweep=43, point=41, dense_w=3, lut_w=30,
           planck_point=12)
F32 = 4


def lwsw_work(lw: Ckd, sw: Ckd, gases: dict, ncol: int, nlay: int,
              n_angles: int) -> dict:
    """Operations and bytes of one call of the merged solve on ``ncol``
    columns of ``nlay`` layers.  ``gases``: name -> the number of values
    per column the batch gives (nlay for a profile, 1 for a row), in the
    order the program is given them."""
    per_layer = OPS["point"]
    per_lg = 0
    table_bytes = 0
    n_pt = lw.temperature.size
    for ckd in (lw, sw):
        nd, nl = ckd.gas_counts(gases)
        per_layer += nd * OPS["dense_w"] + nl * OPS["lut_w"]
        gas_ops = nd * OPS["dense"] + nl * OPS["lut"]
        rows = sum(len(g.mf_grid) if g.mf_grid is not None else 1
                   for g in ckd.contributions(gases))
        table_bytes += (rows * n_pt * ckd.ngpt + ckd.temperature.shape[0]) * F32
        if ckd.shortwave:
            per_lg += ckd.ngpt * (gas_ops + OPS["sw_optics"]
                                  + OPS["sw_sweep"])
            table_bytes += 2 * ckd.ngpt * F32
        else:
            per_layer += 2 * OPS["planck_point"]
            sweeps = n_angles * (OPS["lw_sources"] + OPS["lw_sweep"])
            per_lg += ckd.ngpt * (gas_ops + 2 * OPS["planck"] + sweeps)
            table_bytes += ckd.planck_function.size * F32
    used = set()
    for ckd in (lw, sw):
        used |= {g.name for g in ckd.contributions(gases)
                 if g.code != NONE}
    gas_values = sum(n for name, n in gases.items() if name in used)
    per_column = (2 * (nlay + 1) + nlay      # plev, tlev, tlay
                  + gas_values + 1           # gases, tsfc
                  + lw.ngpt + sw.ngpt + 2    # emissivity, albedo, mu0, TSI
                  + 4 * (nlay + 1))          # the four flux profiles
    ops = ncol * nlay * (per_layer + per_lg)
    nbytes = ncol * per_column * F32 + table_bytes
    return {"ops": ops, "bytes": nbytes}


def least_seconds(work: dict) -> float:
    """The larger of operations over the float32 peak and bytes over the
    HBM rate."""
    return max(work["ops"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_HBM_BYTES)
