// Device code shared by the port's three flux kernels: lwsw.cu (merged
// LW + SW), lw.cu (LW only) and sw.cu (SW only).  The port's counterpart of
// the JAX package's single homes in ecckd_tpu/ops/pallas/common.py: the
// gas optics of one band, the Planck source, the LW layer sources, the
// g = 0 two-stream and the staged sweeps of both solvers live here once;
// staged.cuh builds the three kernels' common body from them.
//
// Every function takes the inputs of ONE band: the shared per-column
// atmosphere (Atmos), the band's own (p, T) interpolation grid (Grid), its
// gas plan and flat table (Band), and its solver terms (LwSolve or
// SwSolve).  The merged kernel passes the LW model's grid to both bands
// (their grids are equal there); the single-band kernels pass their own
// model's grid.
//
// Layout.  Lane = g-point in a warp-uniform loop over chunks of 32
// g-points, so any ngpt works (padded lanes compute on g-point 0 and
// contribute 0 to the sums).  An LW band whose g-points are a template
// constant above 32 (lw_rrtmgp's 36; at most 64) takes no second chunk
// at compute type float (PAIRS): its optics lay a warp's (layer, g-point)
// pairs over the lanes, 32 pairs a step, and its sweeps give each lane
// g-points lane and lane + 32 (the second where it exists), whose
// recurrences run side by side in one walk over the layers and add before
// the g-sum; or, where the plan gives a set one LW sweep warp per g-chunk
// (Tile.lw_warps: the merged kernel at one angle on the split route), each
// warp walks its own chunk (lw_sweeps_chunk) into accumulators of its own,
// and the set adds the two chunks' level sums in chunk order.  The double
// instantiations keep the chunked loop: with the pairs their split-route
// build and its checked build (-DECCKD_CHECK_RING)
// fused one multiply-add of the SW path differently (the SW fluxes 3e-16
// apart), which the checked build's bit-for-bit comparison refuses.
// Tables are flattened in natural (gas,
// [mole fraction,] p, T, g) order with g fastest, so the warp's gather at
// one grid corner is one coalesced 128-byte read.  Per-column pointers
// start at the launch's first column.
//
// Table mode.  The optics are templates on the table's element type T:
// float interpolates the f32 table exactly (the JAX package's bf16x3
// mode); __nv_bfloat16 is the fast mode (its bf16 mode): bf16 table
// entries and bf16-rounded corner weights, f32 sums, as the TPU's one bf16
// MXU pass of the one-hot contraction computes; double interpolates the
// f64 table exactly.  Each kernel library holds the float and bf16
// instantiations, the merged one also the double one, with one entry
// point each.
//
// Compute type.  T also sets the type R = Real<T> that every value is
// computed, staged, summed and written in: float for the float and bf16
// tables, double for the double one (rte-rrtmgp's default working
// precision).  The structs below are templates on R (float under their
// plain names), and the library calls, floors and guards are R's: expm1,
// log and sqrt in double, the thin-layer threshold sqrt(eps) and the
// resonance guard eps * tau^2 at R's epsilon, and the two-stream's tau
// floor (tau_floor) as far below double's epsilon as 1e-8 lies below
// float's.  At R = float every expression is the one the kernels computed
// before R existed.
//
// Shapes.  The optics and sweeps take a band's g-points and its dense and
// LUT gas counts (Shape<NG, ND, NL>) and the grid's temperature points NT
// as template constants where a kernel instantiates them (0: read at run
// time): each table corner, Planck row and staging row is then one base
// plus an immediate offset, and the gas loops unroll.  Table rows are
// reached through 32-bit element indices (one wide multiply-add each).
//
// Accuracy.  Built without fast-math: expm1f/expf/logf/sqrtf and the
// divides are the IEEE-accurate calls (a fast exp cost ~3e-4 in flux on
// the TPU); only the Planck source's division by pi is a product with
// 1/pi.  The floors of common.two_stream_g0 (tau >= tau_floor, 1e-8 at
// float; the eps*tau^2 guard on D) and the thin-layer threshold sqrt(eps)
// are kept.  The
// per-gas, per-g-point clamp max(w*k, 0) is the reference's
// (optical_depth.py), so no table sign precondition applies.
//
// Each kernel library is one translation unit that includes this header
// once; the structs below are mirrored by ctypes in ops/cuda/binding.py.

#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int MAX_SLICES = 16;
constexpr int KIND_DENSE = 0;
constexpr int VMR_NONE = 0;
constexpr int VMR_PROFILE = 1;

// The compute type of table element type T (see "Compute type").
template <typename T>
struct ComputeOf {
  using type = float;
};
template <>
struct ComputeOf<double> {
  using type = double;
};
template <typename T>
using Real = typename ComputeOf<T>::type;

// The constants and library calls at compute type R: the float ones are
// the calls the kernels made before R existed.
template <typename R>
__device__ __forceinline__ R inv_pi() {
  return (R)(1.0 / 3.14159265359);
}
template <typename R>
__device__ __forceinline__ R moles_per_pa() {
  return (R)(1.0 / (9.80665 * 0.001 * 28.970));
}
template <typename R>
__device__ __forceinline__ R epsilon() {
  return std::is_same<R, float>::value ? (R)FLT_EPSILON : (R)DBL_EPSILON;
}
// The floor of two_stream_g0's scattering algebra: 1e-8 at float; at
// double the same multiple of the type's epsilon, 1e-8 * 2^-29 (at 1e-8 a
// double solve reads 1.6e-9 of the SW flux scale against the reference
// from the layers it floors, against 5.5e-14 without).
template <typename R>
__device__ __forceinline__ R tau_floor() {
  return std::is_same<R, float>::value
             ? (R)1e-8
             : (R)(1e-8 * (DBL_EPSILON / FLT_EPSILON));
}
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float r_floor(float x) { return floorf(x); }
__device__ __forceinline__ double r_floor(double x) { return floor(x); }
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }
__device__ __forceinline__ float r_log(float x) { return logf(x); }
__device__ __forceinline__ double r_log(double x) { return log(x); }
__device__ __forceinline__ float r_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double r_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float r_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double r_expm1(double x) { return expm1(x); }

// An int kept in a staged word (the layer parameters' table rows and
// Planck points): its bits in a float, the low word of a double.
__device__ __forceinline__ float int_word(int i, float) {
  return __int_as_float(i);
}
__device__ __forceinline__ double int_word(int i, double) {
  return __hiloint2double(0, i);
}
__device__ __forceinline__ int word_int(float x) { return __float_as_int(x); }
__device__ __forceinline__ int word_int(double x) { return __double2loint(x); }

}  // namespace

// The structs at compute type R; under their plain names (GasSlice, ...)
// at float.
template <typename R>
struct GasSliceT {
  int kind;      // KIND_DENSE or 1 (LUT)
  int row0;      // first (p*n_t + t) row of this gas's table in Band::table
  int vmr_kind;  // VMR_NONE (composite), VMR_PROFILE or 2 (per column)
  int vmr_idx;   // row in vmr_prof / vmr_scal
  int n_mf;      // LUT mole-fraction axis length
  R a, b;        // dense weight = simple_w * (a*vmr + b)
  R mf0, log_mf0, d_log, v_hi;  // LUT axis; v_hi = n_mf - 1.001
};

// One model's gas plan and flat table.  The dense gases come first
// (s[0, ndense)), then the LUT gases.
template <typename R>
struct BandT {
  const void* table;  // (rows, ngpt), g fastest: R, or __nv_bfloat16
                      // in the fast mode
  int ngpt;
  int nslice;
  int ndense;
  GasSliceT<R> s[MAX_SLICES];
};

// One model's (pressure, temperature) interpolation grid.
template <typename R>
struct GridT {
  const R* t_first;  // (n_p) first temperature-grid column
  int n_p, n_t;
  R log_p0, d_log_p, p_hi, dt, t_hi;
};

// Per-column inputs the bands of one solve share, row-major, column
// outermost.
template <typename R>
struct AtmosT {
  const R* plev;      // (ncol, nlay+1)
  const R* tlay;      // (ncol, nlay)
  const R* vmr_prof;  // (ncol, n_prof, nlay)
  const R* vmr_scal;  // (ncol, n_scal)
  int ncol, nlay, n_prof, n_scal;
};

// What the LW solve of one band takes beyond its gas optics.
template <typename R>
struct LwSolveT {
  const R* tlev;    // (ncol, nlay+1)
  const R* tsfc;    // (ncol)
  const R* emis;    // (ncol, ngpt)
  const R* planck;  // (n_planck, ngpt)
  R* up;            // (ncol, nlay+1), each level written once
  R* dn;
  int n_planck, n_ang;
  R planck_t0, planck_dt;
  R sec[4];
  R w2pi[4];
};

// What the SW solve of one band takes beyond its gas optics.
template <typename R>
struct SwSolveT {
  const R* alb;        // (ncol, ngpt)
  const R* mu0;        // (ncol)
  const R* tsi_scale;  // (ncol)
  const R* solar;      // (ngpt)
  const R* ray;        // (ngpt)
  R* up;               // (ncol, nlay+1), each level written once
  R* dn;
};

using GasSlice = GasSliceT<float>;
using Band = BandT<float>;
using Grid = GridT<float>;
using Atmos = AtmosT<float>;
using LwSolve = LwSolveT<float>;
using SwSolve = SwSolveT<float>;

namespace {

// A band's g-points, dense gases and LUT gases as template constants, 0
// to read them at run time; NG = -1: a band the kernel does not solve.
template <int NG_, int ND_ = 0, int NL_ = 0>
struct Shape {
  static constexpr int NG = NG_, ND = ND_, NL = NL_;
};
using NoBand = Shape<-1>;

// A template constant where a kernel instantiates it (> 0), else the
// run-time value.
template <int N>
__device__ __forceinline__ int fixed_or(int runtime) {
  return N > 0 ? N : runtime;
}

template <typename R>
struct FracIdx {
  int i0;
  R w1;
};

// idx = clip(raw, 0, hi); i0 = floor(idx); w1 = idx - i0 (ops/interp.py).
template <typename R>
__device__ __forceinline__ FracIdx<R> frac_index(R raw, R hi) {
  const R idx = r_min(r_max(raw, (R)0), hi);
  const R f = r_floor(idx);
  return {static_cast<int>(f), idx - f};
}

// Lane-uniform interpolation point of layer j of column c.
template <typename R>
struct LayerPoint {
  int ip, it;
  R wp, wt;
  R simple_w;  // moles of dry air per m^2
};

// Entry: the table's element type.  The fast mode rounds the corner weights
// to bf16, so a weight one f32 ulp off can land a whole bf16 step away:
// there t0 is formed without FMA contraction, as the plain version's
// separate products and sum form it (ops/cuda/common.py interp_points),
// so both compute the same float32 weights.  The exact mode keeps its
// code (float and double alike).
template <typename Entry, typename R = Real<Entry>>
__device__ __forceinline__ LayerPoint<R> layer_point(const AtmosT<R>& A,
                                                     const GridT<R>& G, int c,
                                                     int j) {
  const R* pl = A.plev + (size_t)c * (A.nlay + 1);
  const R p0 = pl[j], p1 = pl[j + 1];
  const R log_p = r_log((R)0.5 * (p1 + p0));
  const FracIdx<R> P = frac_index((log_p - G.log_p0) / G.d_log_p, G.p_hi);
  // Pressure-dependent temperature origin (gas_optics_ecckd.f90:131-132).
  R t0;
  if constexpr (std::is_same<Entry, __nv_bfloat16>::value)
    t0 = __fadd_rn(__fmul_rn(1.0f - P.w1, G.t_first[P.i0]),
                   __fmul_rn(P.w1, G.t_first[P.i0 + 1]));
  else
    t0 = ((R)1 - P.w1) * G.t_first[P.i0] + P.w1 * G.t_first[P.i0 + 1];
  const FracIdx<R> T =
      frac_index((A.tlay[(size_t)c * A.nlay + j] - t0) / G.dt, G.t_hi);
  return {P.i0, T.i0, P.w1, T.w1, moles_per_pa<R>() * (p1 - p0)};
}

template <typename R>
__device__ __forceinline__ R vmr_of(const AtmosT<R>& A,
                                    const GasSliceT<R>& S, int c, int j) {
  if (S.vmr_kind == VMR_PROFILE)
    return A.vmr_prof[((size_t)c * A.n_prof + S.vmr_idx) * A.nlay + j];
  return A.vmr_scal[(size_t)c * A.n_scal + S.vmr_idx];
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The Planck source (ops/planck.py) at one temperature, split into its
// g-independent part, computed once per layer or level (PlanckAt), and its
// per-g value (planck_value): linear interpolation with top-end
// extrapolation, below the table B = (T/T0)*row0, times 1/pi.
template <typename R>
struct PlanckAt {
  int off;  // i0 * ngpt, or -1 below the table
  R w;      // w1, or T/T0 below the table
};

template <typename R>
__device__ __forceinline__ PlanckAt<R> planck_at(const LwSolveT<R>& W,
                                                 int ng, R temp) {
  const R idx = (temp - W.planck_t0) / W.planck_dt;
  const int i0 = static_cast<int>(
      r_min(r_max(r_floor(idx), (R)0), (R)(W.n_planck - 2)));
  if (idx >= (R)0) return {i0 * ng, idx - (R)i0};
  return {-1, temp / W.planck_t0};
}

// The value at g-point g of the Planck table planck.
template <typename R>
__device__ __forceinline__ R planck_value(const R* planck, int g, int ng,
                                          int off, R w) {
  const R* q = planck + (unsigned)(max(off, 0) + g);
  const R x = q[0], y = q[ng];
  const R b = off >= 0 ? ((R)1 - w) * x + w * y : w * x;
  return b * inv_pi<R>();
}

// The Planck source's change over 1 K at temperature temp, per kelvin
// (ops/planck.py planck_source_jac), split as the source is: its
// g-independent part (PlanckDiffAt) and its per-g value
// (planck_diff_value).  The table's first difference over one step,
// E_k = B_k - B_(k-1) with E_0 = B_0 dt / T0, interpolated at
// (temp - T0) / dt + 1 and held at E_0 and E_(n-1) beyond the ends, over
// dt, times 1/pi: on a 1 K table the source at temp + 1 K less that at
// temp, from adjacent entries, without the cancellation of the two.
template <typename R>
struct PlanckDiffAt {
  int off;  // m * ngpt: E_m and E_(m+1) are interpolated
  R w;      // the weight of E_(m+1)
};

template <typename R>
__device__ __forceinline__ PlanckDiffAt<R> planck_diff_at(
    const LwSolveT<R>& W, int ng, R temp) {
  const R pos = (temp - W.planck_t0) / W.planck_dt + (R)1;
  const R m = r_min(r_max(r_floor(pos), (R)0), (R)(W.n_planck - 2));
  return {static_cast<int>(m) * ng, r_min(r_max(pos - m, (R)0), (R)1)};
}

template <typename R>
__device__ __forceinline__ R planck_diff_value(const LwSolveT<R>& W, int g,
                                               int ng, PlanckDiffAt<R> d) {
  const R* q = W.planck + (unsigned)(d.off + g);
  const R b0 = q[0], b1 = q[ng];
  const R before = q[d.off > 0 ? -ng : 0];
  const R e0 = d.off > 0 ? b0 - before : b0 * (W.planck_dt / W.planck_t0);
  return (((R)1 - d.w) * e0 + d.w * (b1 - b0)) / W.planck_dt * inv_pi<R>();
}

// common.lw_layer_sources: transmittance and linear-in-tau path sources at
// slant optical depth ts; thin-layer series below thresh.
template <typename R>
__device__ __forceinline__ void lw_layer_sources(R ts, R lay, R lev_dec,
                                                 R lev_inc, R thresh, R& tr,
                                                 R& src_dn, R& src_up) {
  const R omt = -r_expm1(-ts);
  tr = (R)1 - omt;
  const R fact = ts > thresh ? omt / r_max(ts, thresh) - tr
                             : ts * ((R)0.5 - ts * ((R)1 / (R)3));
  src_dn = omt * lev_inc + (R)2 * fact * (lay - lev_inc);
  src_up = omt * lev_dec + (R)2 * fact * (lay - lev_dec);
}

// common.two_stream_g0: g = 0 two-stream coefficients rescaled by tau
// (u = Rayleigh optical depth <= tau).
template <typename R>
__device__ __forceinline__ void two_stream_g0(R tau, R u, R mu0, R inv_mu0,
                                              R& r_dif, R& t_dif, R& r_dir,
                                              R& t_dir, R& t) {
  const R eps = epsilon<R>();
  const R taus = r_max(tau, tau_floor<R>());
  const R ktau =
      r_sqrt(r_max((taus - u) * ((R)4 * taus - u), (R)1e-12 * (taus * taus)));
  const R em1 = -r_expm1(-ktau);
  const R m1 = em1 * ((R)2 - em1);  // 1 - e^2
  const R e = (R)1 - em1;           // e^-ktau
  const R e2 = (R)1 - m1;           // e^-2ktau
  const R tm1 = -r_expm1(-tau * inv_mu0);  // 1 - t, true tau
  t = (R)1 - tm1;
  const R km = ktau * mu0;
  const R tau2 = taus * taus;
  R d = tau2 - km * km;
  d = r_abs(d) >= eps * tau2 ? d : eps * tau2;
  const R g1t = (R)2 * taus - (R)1.25 * u;
  const R al = taus - (R)0.25 * u;
  const R a = ktau * ((R)1 + e2) + g1t * m1;
  const R p = (R)1 / (a * d);
  const R inv_a = d * p;
  r_dif = ((R)0.75 * u) * m1 * inv_a;
  t_dif = ((R)2 * ktau) * e * inv_a;
  const R q = em1 * em1 + ((R)2 * e) * tm1;
  const R s = em1 * em1 - tm1 * ((R)1 + e2);
  const R u_p = u * p;
  const R half_kt = (R)0.5 * ktau;
  const R t_m1 = t * m1;
  r_dir = u_p * (al * (taus * m1 - km * q) + half_kt * (taus * q - km * m1));
  t_dir = -u_p *
          (al * (taus * t_m1 + km * s) + half_kt * (taus * s + km * t_m1));
  r_dir = r_min(r_max(r_dir, (R)0), (R)1 - t);
  t_dir = r_min(r_max(t_dir, (R)0), (R)1 - t - r_dir);
}

// ---- Per-column staging ---------------------------------------------------
//
// Each kernel splits a column's solve into optics, parallel over the
// column's layers, and sweeps, serial over them, that meet in one staging
// area per column (of words of the compute type R, float or double; each
// row holds ngpt words, g fastest; "floats" below are such words), in
// shared memory or, for columns too deep for it, in a device memory slice;
// the merged kernel may split it, the LW rows in the slice and the rest in
// shared memory, SW rows first (ops/cuda/staged.py stage_plan sizes it):
//   LW rows (ngpt_lw each): at 1 angle tr, src_dn, src_up (nlay each); at
//     2-4 angles tau, B(layer) (nlay each) and B(level) (nlay+1);
//   SW rows (ngpt_sw each): r_dif, t_dif (nlay each); r_dir (nlay+1),
//     then r_dir * direct, then the source of the stack below each level;
//     t_dir (nlay), then t_dir * direct; t (nlay+1), then the albedo of
//     the stack below each level;
//   the g-summed level fluxes: up and down (nlay+1 each) per LW angle,
//     then SW up and down;
//   the layer parameters (below): in the layer's first row of the band
//     solved last (SW's r_dif, else LW's tr / tau) when they fit there,
//     which the layer's optics overwrite only after reading them.

constexpr int SW_RDIF = 0;  // SW row blocks, in units of nlay (+ offsets)

__device__ __forceinline__ int sw_row_tdif(int nlay) { return nlay; }
__device__ __forceinline__ int sw_row_src(int nlay) { return 2 * nlay; }
__device__ __forceinline__ int sw_row_srcdn(int nlay) { return 3 * nlay + 1; }
__device__ __forceinline__ int sw_row_alb(int nlay) { return 4 * nlay + 1; }

// Layer parameters.  What the optics of a layer need that does not depend
// on the g-point is computed once per layer, with lanes over layers,
// before the optics (staged.cuh: by the parameter stage's warps over all
// of a column's layers, or by each optics warp over its own): per layer,
// in order,
//   the table corner ip * n_t + it (int bits), wp, wt, simple_w;
//   with an LW band: the Planck points (PlanckAt, off as int bits) of the
//   layer temperature and of the layer's lower level j + 1;
//   for each gas of the LW band, then of the SW band: a dense gas's weight
//   simple_w * (a * vmr + b); a LUT gas's first table row at its lower
//   mole-fraction point (int bits), its weight w1 and simple_w * vmr.
// The same float operations as the layer's point and gas weights always
// took, on the same floats.  The band's Shape S gives the dense and LUT
// gas counts as constants where a kernel instantiates them (the dense
// gases come first, Band), so the gas loops unroll without a kind branch
// and their loads issue together.
template <class S, typename R>
__device__ __forceinline__ int band_params(const AtmosT<R>& A,
                                           const GridT<R>& G,
                                           const BandT<R>& B,
                                           const LayerPoint<R>& L, int c,
                                           int j, R* p) {
  const int nd = fixed_or<S::ND>(B.ndense);
  const int ns = S::ND > 0 ? S::ND + S::NL : B.nslice;
#pragma unroll
  for (int s = 0; s < nd; ++s) {
    const GasSliceT<R>& D = B.s[s];
    p[s] = D.vmr_kind == VMR_NONE
               ? L.simple_w * D.b
               : L.simple_w * (D.a * vmr_of(A, D, c, j) + D.b);
  }
  int k = nd;
#pragma unroll
  for (int s = nd; s < ns; ++s, k += 3) {
    const GasSliceT<R>& U = B.s[s];
    const R vmr = vmr_of(A, U, c, j);
    const FracIdx<R> V = frac_index(
        (r_log(r_max(vmr, U.mf0)) - U.log_mf0) / U.d_log, U.v_hi);
    p[k] = int_word(U.row0 + V.i0 * G.n_p * G.n_t, R());
    p[k + 1] = V.w1;
    p[k + 2] = L.simple_w * vmr;
  }
  return k;
}

template <typename R>
__device__ __forceinline__ void planck_params(const LwSolveT<R>& W, int ng,
                                              R temp, R* p) {
  const PlanckAt<R> q = planck_at(W, ng, temp);
  p[0] = int_word(q.off, R());
  p[1] = q.w;
}

// The parameters of layer j of column c for the bands the kernel solves
// (SL: the LW band's Shape, SS: the SW band's, NoBand for one it does not
// solve; BL / BS are then null) into p.
template <typename T, class SL, class SS, typename R = Real<T>>
__device__ void layer_params(const AtmosT<R>& A, const GridT<R>& G,
                             const BandT<R>* BL, const BandT<R>* BS,
                             const LwSolveT<R>* W, int c, int j, R* p) {
  const LayerPoint<R> L = layer_point<T>(A, G, c, j);
  p[0] = int_word(L.ip * G.n_t + L.it, R());
  p[1] = L.wp;
  p[2] = L.wt;
  p[3] = L.simple_w;
  int k = 4;
  if constexpr (SL::NG >= 0) {
    const int ng = fixed_or<SL::NG>(BL->ngpt);
    planck_params(*W, ng, A.tlay[(size_t)c * A.nlay + j], p + 4);
    planck_params(*W, ng, W->tlev[(size_t)c * (A.nlay + 1) + j + 1], p + 6);
    k = 8 + band_params<SL>(A, G, *BL, L, c, j, p + 8);
  }
  if constexpr (SS::NG >= 0) band_params<SS>(A, G, *BS, L, c, j, p + k);
}

// The layer's bi-linear corner weights: Corners<T>(wp, wt)(tb, d_t, d_p)
// interpolates the block at tb (d_t: the next temperature, d_p: the next
// pressure) on the table of element type T: exactly, in T, for float and
// double.
template <typename T>
struct Corners {
  T pw0, pw1, tw0, tw1;
  __device__ __forceinline__ Corners(T wp, T wt)
      : pw0((T)1 - wp), pw1(wp), tw0((T)1 - wt), tw1(wt) {}
  __device__ __forceinline__ T operator()(const T* tb, int d_t,
                                          int d_p) const {
    const T* tp = tb + d_p;
    return tw0 * (pw0 * tb[0] + pw1 * tp[0]) +
           tw1 * (pw0 * tb[d_t] + pw1 * tp[d_t]);
  }
};

// The fast mode (ops/cuda/common.py's _bilinear_fast): sum over the four
// corners of bf16(wp * wt) * k, each corner product rounded itself, the
// bf16 entries widened to f32 and summed in f32.  Scalar 2-byte loads: a
// row of 27 or 36 bf16 g-points is not 4-byte aligned at every g.
template <>
struct Corners<__nv_bfloat16> {
  float w00, w10, w01, w11;  // bf16(wp_i * wt_j)
  __device__ __forceinline__ Corners(float wp, float wt) {
    const float pw0 = 1.0f - wp, tw0 = 1.0f - wt;
    w00 = bf16_round(pw0 * tw0);
    w10 = bf16_round(wp * tw0);
    w01 = bf16_round(pw0 * wt);
    w11 = bf16_round(wp * wt);
  }
  __device__ __forceinline__ float operator()(const __nv_bfloat16* tb,
                                              int d_t, int d_p) const {
    const __nv_bfloat16* tp = tb + d_p;
    return w00 * __bfloat162float(tb[0]) + w10 * __bfloat162float(tp[0]) +
           w01 * __bfloat162float(tb[d_t]) + w11 * __bfloat162float(tp[d_t]);
  }
};

// Total gas optical depth of one g-point from the layer parameters p of
// band B (p at the band's gas weights): idx is the element index of the
// layer's (p, T) corner row at the g-point.  Dense gases then LUT gases,
// each clamped at zero before accumulation (gas_optics_ecckd.f90:233-238).
template <typename T, class S, int NT, typename R = Real<T>>
__device__ __forceinline__ R gas_tau_params(const BandT<R>& B,
                                            const GridT<R>& G, int idx,
                                            const Corners<T>& w,
                                            const R* p) {
  const T* table = static_cast<const T*>(B.table);
  const int ng = fixed_or<S::NG>(B.ngpt), d_p = fixed_or<NT>(G.n_t) * ng;
  const int nd = fixed_or<S::ND>(B.ndense);
  const int ns = S::ND > 0 ? S::ND + S::NL : B.nslice;
  R tau = (R)0;
  for (int s = 0; s < nd; ++s)
    tau += r_max(
        p[s] * w(table + (unsigned)(idx + B.s[s].row0 * ng), ng, d_p), (R)0);
  const int d_v = G.n_p * d_p;
  for (int s = nd, k = nd; s < ns; ++s, k += 3) {
    const T* tb = table + (unsigned)(idx + word_int(p[k]) * ng);
    const R w1 = p[k + 1];
    const R lo = w(tb, ng, d_p);
    const R hi = w(tb + d_v, ng, d_p);
    const R coeff = ((R)1 - w1) * lo + w1 * hi;
    tau += r_max(p[k + 2] * coeff, (R)0);
  }
  return tau;
}

// lw_optics for an LW band of S::NG g-points in (32, 64] ("Layout"): the
// warp's (layer, g-point) pairs over the lanes, pair (j, g) at lane
// ((j - ja) NG + g) mod 32, so a step's stores fill consecutive words.  A
// lane's layer changes from step to step, so each pair computes its upper
// level's Planck value itself, from the layer above's parameters (its
// lower level's points), or for the warp's first layer from tlev: the
// same float operations on the same floats as a value carried down.  The
// parameters never share the LW rows here (ops/cuda/staged.py stage_plan
// keeps them in the SW rows or a place of their own), and the warp reads
// only its own layers'.
template <typename T, class S, int NT, typename R = Real<T>>
__device__ __forceinline__ void lw_optics_pairs(const AtmosT<R>& A,
                                                const GridT<R>& G,
                                                const BandT<R>& B,
                                                const LwSolveT<R>& W, int c,
                                                int ja, int jb, int lane,
                                                const R* prm, int prm_stride,
                                                R* lw_st) {
  constexpr int NG = S::NG;
  static_assert(NG > 32 && NG <= 64, "pairs of one or two g-chunks");
  const int nlay = A.nlay, n = (jb - ja) * NG;
  const R thresh = r_sqrt(epsilon<R>());
  const PlanckAt<R> top =
      planck_at(W, NG, W.tlev[(size_t)c * (nlay + 1) + ja]);
  for (int q0 = 0; q0 < n; q0 += 32) {
    const int q = q0 + lane;
    if (q >= n) break;
    const int j = ja + q / NG, g = q % NG;
    const R* p = prm + j * prm_stride;
    const Corners<T> w(p[1], p[2]);
    const R tau =
        gas_tau_params<T, S, NT>(B, G, word_int(p[0]) * NG + g, w, p + 8);
    const R b_lay = planck_value(W.planck, g, NG, word_int(p[4]), p[5]);
    const R b_bot = planck_value(W.planck, g, NG, word_int(p[6]), p[7]);
    PlanckAt<R> upper = top;
    if (j > ja) {
      const R* pa = p - prm_stride;
      upper = {word_int(pa[6]), pa[7]};
    }
    const R b_top = planck_value(W.planck, g, NG, upper.off, upper.w);
    R* st = lw_st + j * NG + g;
    if (W.n_ang == 1) {
      R tr, sdn, sup;
      lw_layer_sources(tau * W.sec[0], b_lay, b_top, b_bot, thresh, tr, sdn,
                       sup);
      st[0] = tr;
      st[nlay * NG] = sdn;
      st[2 * nlay * NG] = sup;
    } else {
      st[0] = tau;
      st[nlay * NG] = b_lay;
      st[2 * nlay * NG] = b_top;
      if (j == nlay - 1) st[(2 * nlay + 1) * NG] = b_bot;  // row 3 nlay
    }
  }
}

// The LW optics of layers [ja, jb) of column c from their parameters
// (layer j's at prm + j * prm_stride): at 1 angle the rows tr, src_dn,
// src_up of lw_st, at 2-4 angles tau, B(layer) and B(level).  Each level's
// Planck value is computed once: the layer's lower level from its
// parameters, carried as the next layer's upper one.  One warp, lane =
// g-point (a band wider than a warp: lw_optics_pairs).  The parameters may
// share the rows stored here: every store follows the warp's last read of
// them.
// Whether an LW band of NG g-points (a template constant, else 0) takes
// the pairs layout at compute type R ("Layout"); ops/cuda/staged.py pairs
// mirrors it for the plan.
template <int NG, typename R>
constexpr bool PAIRS = NG > 32 && std::is_same<R, float>::value;

template <typename T, class S, int NT, typename R = Real<T>>
__device__ __forceinline__ void lw_optics(const AtmosT<R>& A,
                                          const GridT<R>& G,
                                          const BandT<R>& B,
                                          const LwSolveT<R>& W, int c,
                                          int ja, int jb, int lane,
                                          const R* prm, int prm_stride,
                                          R* lw_st) {
  if constexpr (PAIRS<S::NG, R>) {
    lw_optics_pairs<T, S, NT>(A, G, B, W, c, ja, jb, lane, prm, prm_stride,
                              lw_st);
    return;
  }
  const int nlay = A.nlay, ng = fixed_or<S::NG>(B.ngpt);
  const R thresh = r_sqrt(epsilon<R>());
  const PlanckAt<R> top =
      planck_at(W, ng, W.tlev[(size_t)c * (nlay + 1) + ja]);
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    R b_top = planck_value(W.planck, g, ng, top.off, top.w);
    for (int j = ja; j < jb; ++j) {
      const R* p = prm + j * prm_stride;
      const Corners<T> w(p[1], p[2]);
      const R tau = gas_tau_params<T, S, NT>(
          B, G, word_int(p[0]) * ng + g, w, p + 8);
      const R b_lay = planck_value(W.planck, g, ng, word_int(p[4]), p[5]);
      const R b_bot = planck_value(W.planck, g, ng, word_int(p[6]), p[7]);
      R* st = lw_st + j * ng + g;
      if (W.n_ang == 1) {
        R tr, sdn, sup;
        lw_layer_sources(tau * W.sec[0], b_lay, b_top, b_bot, thresh, tr, sdn,
                         sup);
        __syncwarp();
        if (act) {
          st[0] = tr;
          st[nlay * ng] = sdn;
          st[2 * nlay * ng] = sup;
        }
      } else {
        __syncwarp();
        if (act) {
          st[0] = tau;
          st[nlay * ng] = b_lay;
          st[2 * nlay * ng] = b_top;
          if (j == nlay - 1) st[(2 * nlay + 1) * ng] = b_bot;  // row 3 nlay
        }
      }
      b_top = b_bot;
    }
  }
}

// The SW optics of layers [ja, jb) of column c from their parameters (the
// SW band's gas weights at + prm_sw): the rows r_dif, t_dif, r_dir, t_dir
// and t of sw_st.  As lw_optics, every store follows the warp's last read
// of the layer's parameters.
template <typename T, class Sh, int NT, typename R = Real<T>>
__device__ __forceinline__ void sw_optics(const AtmosT<R>& A,
                                          const GridT<R>& G,
                                          const BandT<R>& B,
                                          const SwSolveT<R>& S, int c,
                                          int ja, int jb, int lane,
                                          const R* prm, int prm_stride,
                                          int prm_sw, R* sw_st) {
  const int nlay = A.nlay, ng = fixed_or<Sh::NG>(B.ngpt);
  const R mu0 = S.mu0[c];
  const R inv_mu0 = (R)1 / mu0;
  for (int j = ja; j < jb; ++j) {
    const R* p = prm + j * prm_stride;
    const Corners<T> w(p[1], p[2]);
    const R simple_w = p[3];
    for (int g0 = 0; g0 < ng; g0 += 32) {
      const bool act = g0 + lane < ng;
      const int g = act ? g0 + lane : 0;
      const R tau_ray = simple_w * S.ray[g];
      const R tau = gas_tau_params<T, Sh, NT>(B, G, word_int(p[0]) * ng + g,
                                              w, p + prm_sw) +
                    tau_ray;
      R r_dif, t_dif, r_dir, t_dir, t;
      two_stream_g0(tau, tau_ray, mu0, inv_mu0, r_dif, t_dif, r_dir, t_dir,
                    t);
      __syncwarp();
      if (!act) continue;
      R* st = sw_st + j * ng + g;
      st[SW_RDIF * ng] = r_dif;
      st[sw_row_tdif(nlay) * ng] = t_dif;
      st[sw_row_src(nlay) * ng] = r_dir;
      st[sw_row_srcdn(nlay) * ng] = t_dir;
      st[sw_row_alb(nlay) * ng] = t;
    }
  }
}

// The g-sums of K values at once (K a power of two, <= 32): each halving
// step keeps half of the values and adds the other half from the partner
// lane, so lanes [k * 32 / K, (k + 1) * 32 / K) end with the sum over all
// 32 lanes of value k, in K - 1 + log2(32 / K) shuffles instead of
// 5 K.  Returns this lane's sum; it is value lane / (32 / K)'s.
template <int K, typename R>
__device__ __forceinline__ R warp_sums(R (&v)[K], int lane) {
#pragma unroll
  for (int n = K, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool hi = lane & off;
#pragma unroll
    for (int q = 0; q < n / 2; ++q) {
      const R keep = hi ? v[q + n / 2] : v[q];
      const R send = hi ? v[q] : v[q + n / 2];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  R u = v[0];
#pragma unroll
  for (int off = 16 / K; off > 0; off >>= 1)
    u += __shfl_xor_sync(0xffffffffu, u, off);
  return u;
}

// Layers per step of the staged sweeps: a step loads its SWEEP_K layers'
// coefficients first (each row block at one base plus immediate offsets,
// predicated on the layer existing), runs the recurrence through them,
// then g-sums the SWEEP_K levels together, so neither the loads nor the
// shuffles wait on one layer at a time.
constexpr int SWEEP_K = 4;

// lw_sweeps_staged for an LW band of NG g-points in (32, 64] ("Layout"):
// lane l carries g-points l and l + 32 (the second where l + 32 < NG,
// its loads predicated on it), both recurrences in one walk over the
// layers, K layers a step as below; the lane adds its two radiances
// before the step's g-sums.
template <int NG, typename R>
__device__ __forceinline__ void lw_sweeps_pairs(const LwSolveT<R>& W,
                                                int nlay, int c, int lane,
                                                int a, const R* st,
                                                R* __restrict__ up,
                                                R* __restrict__ dn) {
  constexpr int K = SWEEP_K;
  static_assert(NG > 32 && NG <= 64, "pairs of one or two g-chunks");
  const R thresh = r_sqrt(epsilon<R>());
  const R sec = W.sec[a], w2pi = W.w2pi[a];
  const PlanckAt<R> sfc = planck_at(W, NG, W.tsfc[c]);
  const int g1 = lane + 32;
  const bool act1 = g1 < NG;
  const int gs[2] = {lane, act1 ? g1 : 0};
  R e[2], b_sfc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    e[h] = W.emis[(size_t)c * NG + gs[h]];
    b_sfc[h] = planck_value(W.planck, gs[h], NG, sfc.off, sfc.w);
  }
  // Transmittance and source of layer j at g-point gs[h] in one
  // direction: staged at 1 angle, from the staged tau and Planck terms
  // otherwise.
  auto layer = [&](int h, int j, bool down, R& tr, R& src) {
    const R* r0 = st + j * NG + gs[h];
    const int o = nlay * NG;
    if (W.n_ang == 1) {
      tr = r0[0];
      src = r0[down ? o : 2 * o];
    } else {
      R sdn, sup;
      lw_layer_sources(r0[0] * sec, r0[o], r0[2 * o], r0[2 * o + NG],
                       thresh, tr, sdn, sup);
      src = down ? sdn : sup;
    }
  };
  R rad[2] = {(R)0, (R)0};
  for (int j0 = 0; j0 < nlay; j0 += K) {
    R tr[2][K] = {}, src[2][K] = {}, r[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + k < nlay) {
        layer(0, j0 + k, true, tr[0][k], src[0][k]);
        if (act1) layer(1, j0 + k, true, tr[1][k], src[1][k]);
      }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < nlay) {
        rad[0] = tr[0][k] * rad[0] + src[0][k];
        rad[1] = tr[1][k] * rad[1] + src[1][k];
      }
      r[k] = rad[0] + (act1 ? rad[1] : (R)0);
    }
    const R sum = warp_sums(r, lane);
    const int k = lane / (32 / K);
    if (lane % (32 / K) == 0 && j0 + k < nlay) dn[j0 + k + 1] += w2pi * sum;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rad[h] = e[h] * b_sfc[h] + ((R)1 - e[h]) * rad[h];
  R last[1] = {rad[0] + (act1 ? rad[1] : (R)0)};
  const R sum = warp_sums(last, lane);
  if (lane == 0) up[nlay] += w2pi * sum;
  for (int j0 = nlay - 1; j0 >= 0; j0 -= K) {
    R tr[2][K] = {}, src[2][K] = {}, r[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 - k >= 0) {
        layer(0, j0 - k, false, tr[0][k], src[0][k]);
        if (act1) layer(1, j0 - k, false, tr[1][k], src[1][k]);
      }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 - k >= 0) {
        rad[0] = tr[0][k] * rad[0] + src[0][k];
        rad[1] = tr[1][k] * rad[1] + src[1][k];
      }
      r[k] = rad[0] + (act1 ? rad[1] : (R)0);
    }
    const R sum = warp_sums(r, lane);
    const int k = lane / (32 / K);
    if (lane % (32 / K) == 0 && j0 - k >= 0) up[j0 - k] += w2pi * sum;
  }
}

// The LW sweeps of column c at Gauss angle a from its staged rows st (ng
// g-points a row) over the g-chunks that start at g_lo, g_lo + 32, ...
// below g_hi, g-summed into this angle's level accumulators up / dn (lane
// 0 adds, over the chunks in order).  Padded lanes compute on g-point
// g_pad and contribute 0.  With JAC (the merged kernel's Jacobian
// instantiation: one angle, one g-chunk) the up pass also carries RTE's
// surface-temperature Jacobian, J = emis * dB_sfc at the surface (the
// source's change over 1 K, computed beside it) and J(j) = tr(j) J(j + 1)
// above, g-summed with the radiances in the same steps, into jac.
template <typename R, bool JAC = false>
__device__ __forceinline__ void lw_sweeps_chunks(const LwSolveT<R>& W,
                                                 int ng, int nlay, int c,
                                                 int lane, int a, int g_lo,
                                                 int g_hi, int g_pad,
                                                 const R* st,
                                                 R* __restrict__ up,
                                                 R* __restrict__ dn,
                                                 R* __restrict__ jac =
                                                     nullptr) {
  constexpr int K = SWEEP_K;
  const R thresh = r_sqrt(epsilon<R>());
  const R sec = W.sec[a], w2pi = W.w2pi[a];
  const PlanckAt<R> sfc = planck_at(W, ng, W.tsfc[c]);
  PlanckDiffAt<R> dsfc;
  if constexpr (JAC) dsfc = planck_diff_at(W, ng, W.tsfc[c]);
  for (int g0 = g_lo; g0 < g_hi; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : g_pad;
    // The row blocks at this g-point: tr / tau, src_dn / B(layer),
    // src_up / B(level).
    const R* const r0 = st + g;
    const R* const r1 = r0 + nlay * ng;
    const R* const r2 = r1 + nlay * ng;
    const R e = W.emis[(size_t)c * ng + g];
    const R b_sfc = planck_value(W.planck, g, ng, sfc.off, sfc.w);
    // Transmittance and source of layer j in one direction: staged at 1
    // angle, from the staged tau and Planck terms otherwise.
    auto layer = [&](int j, bool down, R& tr, R& src) {
      const int o = j * ng;
      if (W.n_ang == 1) {
        tr = r0[o];
        src = (down ? r1 : r2)[o];
      } else {
        R sdn, sup;
        lw_layer_sources(r0[o] * sec, r1[o], r2[o], r2[o + ng], thresh, tr,
                         sdn, sup);
        src = down ? sdn : sup;
      }
    };
    R rad = (R)0;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      R tr[K] = {}, src[K] = {}, r[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < nlay) layer(j0 + k, true, tr[k], src[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 + k < nlay) rad = tr[k] * rad + src[k];
        r[k] = act ? rad : (R)0;
      }
      const R sum = warp_sums(r, lane);
      const int k = lane / (32 / K);
      if (lane % (32 / K) == 0 && j0 + k < nlay) dn[j0 + k + 1] += w2pi * sum;
    }
    rad = e * b_sfc + ((R)1 - e) * rad;
    // The up pass g-sums NV values a level: the radiance and, with JAC, J
    // (value k < K of a step: the radiance at level j0 - k; K + k: J there).
    constexpr int NV = 1 + JAC;
    R jv = (R)0;
    if constexpr (JAC) jv = e * planck_diff_value(W, g, ng, dsfc);
    R last[NV] = {act ? rad : (R)0};
    if constexpr (JAC) last[1] = act ? jv : (R)0;
    const R sum = warp_sums(last, lane);
    if constexpr (JAC) {
      if (lane % 16 == 0) (lane == 0 ? up : jac)[nlay] += w2pi * sum;
    } else {
      if (lane == 0) up[nlay] += w2pi * sum;
    }
    for (int j0 = nlay - 1; j0 >= 0; j0 -= K) {
      R tr[K] = {}, src[K] = {}, r[NV * K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 - k >= 0) layer(j0 - k, false, tr[k], src[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 - k >= 0) {
          rad = tr[k] * rad + src[k];
          if constexpr (JAC) jv = tr[k] * jv;
        }
        r[k] = act ? rad : (R)0;
        if constexpr (JAC) r[K + k] = act ? jv : (R)0;
      }
      const R sum = warp_sums(r, lane);
      const int k = lane / (32 / (NV * K));
      if constexpr (JAC) {
        if (lane % (16 / K) == 0 && j0 - k % K >= 0)
          (k < K ? up : jac)[j0 - k % K] += w2pi * sum;
      } else {
        if (lane % (32 / K) == 0 && j0 - k >= 0) up[j0 - k] += w2pi * sum;
      }
    }
  }
}

// The LW sweeps of column c at Gauss angle a from its staged rows st,
// g-summed into this angle's level accumulators up / dn (lane 0 adds, over
// g-chunks in order; a band wider than a warp: lw_sweeps_pairs).
template <int NG, typename R>
__device__ __forceinline__ void lw_sweeps_staged(const LwSolveT<R>& W,
                                                 const BandT<R>& B, int nlay,
                                                 int c, int lane, int a,
                                                 const R* st,
                                                 R* __restrict__ up,
                                                 R* __restrict__ dn) {
  if constexpr (PAIRS<NG, R>) {
    lw_sweeps_pairs<NG>(W, nlay, c, lane, a, st, up, dn);
    return;
  }
  const int ng = fixed_or<NG>(B.ngpt);
  lw_sweeps_chunks(W, ng, nlay, c, lane, a, 0, ng, 0, st, up, dn);
}

// lw_sweeps_staged's g-chunk h alone, for an LW band of NG g-points in
// (32, 64] whose chunks a set sweeps on warps of their own (one warp per
// chunk: csrc/staged.cuh): a lane per g-point, as the chunked loop walks
// chunk h; its padded lanes compute on the chunk's first g-point, in the
// row segment its own lanes read.
template <int NG, typename R>
__device__ __forceinline__ void lw_sweeps_chunk(const LwSolveT<R>& W,
                                                int nlay, int c, int lane,
                                                int a, int h, const R* st,
                                                R* __restrict__ up,
                                                R* __restrict__ dn) {
  static_assert(NG > 32 && NG <= 64, "one or two g-chunks");
  const int g_lo = 32 * h;
  lw_sweeps_chunks(W, NG, nlay, c, lane, a, g_lo, g_lo + 32, g_lo, st, up,
                   dn);
}

// The SW sweeps of column c from its staged rows st (rewritten in place):
// direct beam, adding up, adding down, g-summed into up / dn.  The adding
// denominator is recomputed in the down pass from the staged albedo, the
// same float operation on the same floats as in the up pass.
template <int NG, typename R>
__device__ __forceinline__ void sw_sweeps_staged(const SwSolveT<R>& W,
                                                 const BandT<R>& B, int nlay,
                                                 int c, int lane, R* st,
                                                 R* __restrict__ up,
                                                 R* __restrict__ dn) {
  constexpr int K = SWEEP_K;
  const int ng = fixed_or<NG>(B.ngpt);
  const R mu0 = W.mu0[c];
  const R scale = W.tsi_scale[c];
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    // The row blocks at this g-point (common.cuh "Per-column staging"),
    // row j of each at [j * ng].
    R* const rdif = st + g;
    R* const tdif = rdif + sw_row_tdif(nlay) * ng;
    R* const src_r = rdif + sw_row_src(nlay) * ng;
    R* const srcdn = rdif + sw_row_srcdn(nlay) * ng;
    R* const alb_r = rdif + sw_row_alb(nlay) * ng;
    // Direct beam: r_dir and t_dir become the layer sources.
    R direct = mu0 * scale * W.solar[g];
    R top[1] = {act ? direct : (R)0};
    const R top_sum = warp_sums(top, lane);
    if (lane == 0) dn[0] += top_sum;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      const int o = j0 * ng;
      R r_dir[K] = {}, t_dir[K] = {}, t[K] = {}, r[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < nlay) {
          r_dir[k] = src_r[o + k * ng];
          t_dir[k] = srcdn[o + k * ng];
          t[k] = alb_r[o + k * ng];
        }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 + k < nlay) {
          r_dir[k] = r_dir[k] * direct;
          t_dir[k] = t_dir[k] * direct;
          direct = t[k] * direct;
        }
        r[k] = act ? direct : (R)0;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (act && j0 + k < nlay) {
          src_r[o + k * ng] = r_dir[k];
          srcdn[o + k * ng] = t_dir[k];
        }
      const R sum = warp_sums(r, lane);
      const int k = lane / (32 / K);
      if (lane % (32 / K) == 0 && j0 + k < nlay) dn[j0 + k + 1] += sum;
    }
    // Upward adding pass (common.sw_adding_up_step): the albedo and the
    // source below each level replace t and the layer's upward source.
    R albedo = W.alb[(size_t)c * ng + g];
    R src = albedo * direct;
    if (act) {
      alb_r[nlay * ng] = albedo;
      src_r[nlay * ng] = src;
    }
    for (int j0 = nlay - 1; j0 >= 0; j0 -= K) {
      const int o = j0 * ng;
      R r_dif[K] = {}, t_dif[K] = {}, su[K] = {}, sd[K] = {};
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 - k >= 0) {
          r_dif[k] = rdif[o - k * ng];
          t_dif[k] = tdif[o - k * ng];
          su[k] = src_r[o - k * ng];
          sd[k] = srcdn[o - k * ng];
        }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 - k >= 0) {
          const R denom = (R)1 / ((R)1 - r_dif[k] * albedo);
          const R src_new =
              su[k] + t_dif[k] * denom * (src + albedo * sd[k]);
          albedo = r_dif[k] + t_dif[k] * t_dif[k] * albedo * denom;
          src = src_new;
        }
        su[k] = src;
        sd[k] = albedo;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (act && j0 - k >= 0) {
          src_r[o - k * ng] = su[k];
          alb_r[o - k * ng] = sd[k];
        }
    }
    R toa[1] = {act ? src : (R)0};
    const R toa_sum = warp_sums(toa, lane);
    if (lane == 0) up[0] += toa_sum;
    // Downward adding pass (common.sw_adding_dn_step).
    R dif = (R)0;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      const int o = j0 * ng;
      R r_dif[K] = {}, t_dif[K] = {}, sd[K] = {}, alb[K] = {},
        src_next[K] = {}, denom[K];
      R v[2 * K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 + k < nlay) {
          r_dif[k] = rdif[o + k * ng];
          t_dif[k] = tdif[o + k * ng];
          sd[k] = srcdn[o + k * ng];
          alb[k] = alb_r[o + (k + 1) * ng];
          src_next[k] = src_r[o + (k + 1) * ng];
        }
        denom[k] = (R)1 / ((R)1 - r_dif[k] * alb[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        R upv = (R)0;
        if (j0 + k < nlay) {
          dif = (t_dif[k] * dif + r_dif[k] * src_next[k] + sd[k]) * denom[k];
          upv = dif * alb[k] + src_next[k];
        }
        v[k] = act ? dif : (R)0;
        v[K + k] = act ? upv : (R)0;
      }
      // v[k]: diffuse down at level j0 + k + 1; v[K + k]: up there.
      const R sum = warp_sums(v, lane);
      const int k = lane / (16 / K);
      if (lane % (16 / K) == 0 && j0 + k % K < nlay)
        (k < K ? dn : up)[j0 + k % K + 1] += sum;
    }
  }
}

}  // namespace

extern "C" const char* ecckd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
