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
// contribute 0 to the sums).  Tables are flattened in natural (gas,
// [mole fraction,] p, T, g) order with g fastest, so the warp's gather at
// one grid corner is one coalesced 128-byte read.  Per-column pointers
// start at the launch's first column.
//
// Table mode.  The optics are templates on the table's element type T:
// float interpolates the f32 table exactly (the JAX package's bf16x3
// mode); __nv_bfloat16 is the fast mode (its bf16 mode): bf16 table
// entries and bf16-rounded corner weights, f32 sums, as the TPU's one bf16
// MXU pass of the one-hot contraction computes.  Each kernel library
// holds both instantiations, with one entry point each.
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
// 1/pi.  The floors of common.two_stream_g0 (tau >= 1e-8, the eps*tau^2
// guard on D) and the thin-layer threshold sqrt(eps_f32) are kept.  The
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
constexpr float INV_PI_F = (float)(1.0 / 3.14159265359);
constexpr float MOLES_PER_PA_F = (float)(1.0 / (9.80665 * 0.001 * 28.970));

}  // namespace

struct GasSlice {
  int kind;      // KIND_DENSE or 1 (LUT)
  int row0;      // first (p*n_t + t) row of this gas's table in Band::table
  int vmr_kind;  // VMR_NONE (composite), VMR_PROFILE or 2 (per column)
  int vmr_idx;   // row in vmr_prof / vmr_scal
  int n_mf;      // LUT mole-fraction axis length
  float a, b;    // dense weight = simple_w * (a*vmr + b)
  float mf0, log_mf0, d_log, v_hi;  // LUT axis; v_hi = n_mf - 1.001
};

// One model's gas plan and flat table.  The dense gases come first
// (s[0, ndense)), then the LUT gases.
struct Band {
  const void* table;  // (rows, ngpt), g fastest: float, or __nv_bfloat16
                      // in the fast mode
  int ngpt;
  int nslice;
  int ndense;
  GasSlice s[MAX_SLICES];
};

// One model's (pressure, temperature) interpolation grid.
struct Grid {
  const float* t_first;  // (n_p) first temperature-grid column
  int n_p, n_t;
  float log_p0, d_log_p, p_hi, dt, t_hi;
};

// Per-column inputs the bands of one solve share, float32, row-major,
// column outermost.
struct Atmos {
  const float* plev;      // (ncol, nlay+1)
  const float* tlay;      // (ncol, nlay)
  const float* vmr_prof;  // (ncol, n_prof, nlay)
  const float* vmr_scal;  // (ncol, n_scal)
  int ncol, nlay, n_prof, n_scal;
};

// What the LW solve of one band takes beyond its gas optics.
struct LwSolve {
  const float* tlev;    // (ncol, nlay+1)
  const float* tsfc;    // (ncol)
  const float* emis;    // (ncol, ngpt)
  const float* planck;  // (n_planck, ngpt)
  float* up;            // (ncol, nlay+1), each level written once
  float* dn;
  int n_planck, n_ang;
  float planck_t0, planck_dt;
  float sec[4];
  float w2pi[4];
};

// What the SW solve of one band takes beyond its gas optics.
struct SwSolve {
  const float* alb;        // (ncol, ngpt)
  const float* mu0;        // (ncol)
  const float* tsi_scale;  // (ncol)
  const float* solar;      // (ngpt)
  const float* ray;        // (ngpt)
  float* up;               // (ncol, nlay+1), each level written once
  float* dn;
};

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

struct FracIdx {
  int i0;
  float w1;
};

// idx = clip(raw, 0, hi); i0 = floor(idx); w1 = idx - i0 (ops/interp.py).
__device__ __forceinline__ FracIdx frac_index(float raw, float hi) {
  const float idx = fminf(fmaxf(raw, 0.0f), hi);
  const float f = floorf(idx);
  return {static_cast<int>(f), idx - f};
}

// Lane-uniform interpolation point of layer j of column c.
struct LayerPoint {
  int ip, it;
  float wp, wt;
  float simple_w;  // moles of dry air per m^2
};

// Entry: the table's element type.  The fast mode rounds the corner weights
// to bf16, so a weight one f32 ulp off can land a whole bf16 step away:
// there t0 is formed without FMA contraction, as the plain version's
// separate products and sum form it (ops/cuda/common.py interp_points),
// so both compute the same float32 weights.  The exact mode keeps its
// code.
template <typename Entry>
__device__ __forceinline__ LayerPoint layer_point(const Atmos& A,
                                                  const Grid& G, int c,
                                                  int j) {
  const float* pl = A.plev + (size_t)c * (A.nlay + 1);
  const float p0 = pl[j], p1 = pl[j + 1];
  const float log_p = logf(0.5f * (p1 + p0));
  const FracIdx P = frac_index((log_p - G.log_p0) / G.d_log_p, G.p_hi);
  // Pressure-dependent temperature origin (gas_optics_ecckd.f90:131-132).
  const float t0 =
      std::is_same<Entry, float>::value
          ? (1.0f - P.w1) * G.t_first[P.i0] + P.w1 * G.t_first[P.i0 + 1]
          : __fadd_rn(__fmul_rn(1.0f - P.w1, G.t_first[P.i0]),
                      __fmul_rn(P.w1, G.t_first[P.i0 + 1]));
  const FracIdx T =
      frac_index((A.tlay[(size_t)c * A.nlay + j] - t0) / G.dt, G.t_hi);
  return {P.i0, T.i0, P.w1, T.w1, MOLES_PER_PA_F * (p1 - p0)};
}

__device__ __forceinline__ float vmr_of(const Atmos& A, const GasSlice& S,
                                        int c, int j) {
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
struct PlanckAt {
  int off;  // i0 * ngpt, or -1 below the table
  float w;  // w1, or T/T0 below the table
};

__device__ __forceinline__ PlanckAt planck_at(const LwSolve& W, int ng,
                                              float temp) {
  const float idx = (temp - W.planck_t0) / W.planck_dt;
  const int i0 = static_cast<int>(
      fminf(fmaxf(floorf(idx), 0.0f), (float)(W.n_planck - 2)));
  if (idx >= 0.0f) return {i0 * ng, idx - (float)i0};
  return {-1, temp / W.planck_t0};
}

// The value at g-point g of the Planck table planck.
__device__ __forceinline__ float planck_value(const float* planck, int g,
                                              int ng, int off, float w) {
  const float* q = planck + (unsigned)(max(off, 0) + g);
  const float x = q[0], y = q[ng];
  const float b = off >= 0 ? (1.0f - w) * x + w * y : w * x;
  return b * INV_PI_F;
}

// common.lw_layer_sources: transmittance and linear-in-tau path sources at
// slant optical depth ts; thin-layer series below thresh.
__device__ __forceinline__ void lw_layer_sources(float ts, float lay,
                                                 float lev_dec, float lev_inc,
                                                 float thresh, float& tr,
                                                 float& src_dn,
                                                 float& src_up) {
  const float omt = -expm1f(-ts);
  tr = 1.0f - omt;
  const float fact = ts > thresh ? omt / fmaxf(ts, thresh) - tr
                                 : ts * (0.5f - ts * (1.0f / 3.0f));
  src_dn = omt * lev_inc + 2.0f * fact * (lay - lev_inc);
  src_up = omt * lev_dec + 2.0f * fact * (lay - lev_dec);
}

// common.two_stream_g0: g = 0 two-stream coefficients rescaled by tau
// (u = Rayleigh optical depth <= tau).
__device__ __forceinline__ void two_stream_g0(float tau, float u, float mu0,
                                              float inv_mu0, float& r_dif,
                                              float& t_dif, float& r_dir,
                                              float& t_dir, float& t) {
  const float eps = FLT_EPSILON;
  const float taus = fmaxf(tau, 1e-8f);
  const float ktau =
      sqrtf(fmaxf((taus - u) * (4.0f * taus - u), 1e-12f * (taus * taus)));
  const float em1 = -expm1f(-ktau);
  const float m1 = em1 * (2.0f - em1);  // 1 - e^2
  const float e = 1.0f - em1;           // e^-ktau
  const float e2 = 1.0f - m1;           // e^-2ktau
  const float tm1 = -expm1f(-tau * inv_mu0);  // 1 - t, true tau
  t = 1.0f - tm1;
  const float km = ktau * mu0;
  const float tau2 = taus * taus;
  float d = tau2 - km * km;
  d = fabsf(d) >= eps * tau2 ? d : eps * tau2;
  const float g1t = 2.0f * taus - 1.25f * u;
  const float al = taus - 0.25f * u;
  const float a = ktau * (1.0f + e2) + g1t * m1;
  const float p = 1.0f / (a * d);
  const float inv_a = d * p;
  r_dif = (0.75f * u) * m1 * inv_a;
  t_dif = (2.0f * ktau) * e * inv_a;
  const float q = em1 * em1 + (2.0f * e) * tm1;
  const float s = em1 * em1 - tm1 * (1.0f + e2);
  const float u_p = u * p;
  const float half_kt = 0.5f * ktau;
  const float t_m1 = t * m1;
  r_dir = u_p * (al * (taus * m1 - km * q) + half_kt * (taus * q - km * m1));
  t_dir = -u_p *
          (al * (taus * t_m1 + km * s) + half_kt * (taus * s + km * t_m1));
  r_dir = fminf(fmaxf(r_dir, 0.0f), 1.0f - t);
  t_dir = fminf(fmaxf(t_dir, 0.0f), 1.0f - t - r_dir);
}

// ---- Per-column staging ---------------------------------------------------
//
// Each kernel splits a column's solve into optics, parallel over the
// column's layers, and sweeps, serial over them, that meet in one staging
// area per column (float32; each row holds ngpt floats, g fastest), in
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
template <class S>
__device__ __forceinline__ int band_params(const Atmos& A, const Grid& G,
                                           const Band& B, const LayerPoint& L,
                                           int c, int j, float* p) {
  const int nd = fixed_or<S::ND>(B.ndense);
  const int ns = S::ND > 0 ? S::ND + S::NL : B.nslice;
#pragma unroll
  for (int s = 0; s < nd; ++s) {
    const GasSlice& D = B.s[s];
    p[s] = D.vmr_kind == VMR_NONE
               ? L.simple_w * D.b
               : L.simple_w * (D.a * vmr_of(A, D, c, j) + D.b);
  }
  int k = nd;
#pragma unroll
  for (int s = nd; s < ns; ++s, k += 3) {
    const GasSlice& U = B.s[s];
    const float vmr = vmr_of(A, U, c, j);
    const FracIdx V = frac_index(
        (logf(fmaxf(vmr, U.mf0)) - U.log_mf0) / U.d_log, U.v_hi);
    p[k] = __int_as_float(U.row0 + V.i0 * G.n_p * G.n_t);
    p[k + 1] = V.w1;
    p[k + 2] = L.simple_w * vmr;
  }
  return k;
}

__device__ __forceinline__ void planck_params(const LwSolve& W, int ng,
                                              float temp, float* p) {
  const PlanckAt q = planck_at(W, ng, temp);
  p[0] = __int_as_float(q.off);
  p[1] = q.w;
}

// The parameters of layer j of column c for the bands the kernel solves
// (SL: the LW band's Shape, SS: the SW band's, NoBand for one it does not
// solve; BL / BS are then null) into p.
template <typename T, class SL, class SS>
__device__ void layer_params(const Atmos& A, const Grid& G, const Band* BL,
                             const Band* BS, const LwSolve* W, int c, int j,
                             float* p) {
  const LayerPoint L = layer_point<T>(A, G, c, j);
  p[0] = __int_as_float(L.ip * G.n_t + L.it);
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
// pressure) on the table of element type T.
template <typename T>
struct Corners;

template <>
struct Corners<float> {
  float pw0, pw1, tw0, tw1;
  __device__ __forceinline__ Corners(float wp, float wt)
      : pw0(1.0f - wp), pw1(wp), tw0(1.0f - wt), tw1(wt) {}
  __device__ __forceinline__ float operator()(const float* tb, int d_t,
                                              int d_p) const {
    const float* tp = tb + d_p;
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
template <typename T, class S, int NT>
__device__ __forceinline__ float gas_tau_params(const Band& B, const Grid& G,
                                                int idx,
                                                const Corners<T>& w,
                                                const float* p) {
  const T* table = static_cast<const T*>(B.table);
  const int ng = fixed_or<S::NG>(B.ngpt), d_p = fixed_or<NT>(G.n_t) * ng;
  const int nd = fixed_or<S::ND>(B.ndense);
  const int ns = S::ND > 0 ? S::ND + S::NL : B.nslice;
  float tau = 0.0f;
  for (int s = 0; s < nd; ++s)
    tau += fmaxf(
        p[s] * w(table + (unsigned)(idx + B.s[s].row0 * ng), ng, d_p), 0.0f);
  const int d_v = G.n_p * d_p;
  for (int s = nd, k = nd; s < ns; ++s, k += 3) {
    const T* tb = table + (unsigned)(idx + __float_as_int(p[k]) * ng);
    const float w1 = p[k + 1];
    const float lo = w(tb, ng, d_p);
    const float hi = w(tb + d_v, ng, d_p);
    const float coeff = (1.0f - w1) * lo + w1 * hi;
    tau += fmaxf(p[k + 2] * coeff, 0.0f);
  }
  return tau;
}

// The LW optics of layers [ja, jb) of column c from their parameters
// (layer j's at prm + j * prm_stride): at 1 angle the rows tr, src_dn,
// src_up of lw_st, at 2-4 angles tau, B(layer) and B(level).  Each level's
// Planck value is computed once: the layer's lower level from its
// parameters, carried as the next layer's upper one.  One warp, lane =
// g-point.  The parameters may share the rows stored here: every store
// follows the warp's last read of them.
template <typename T, class S, int NT>
__device__ __forceinline__ void lw_optics(const Atmos& A, const Grid& G,
                                          const Band& B, const LwSolve& W,
                                          int c, int ja, int jb, int lane,
                                          const float* prm, int prm_stride,
                                          float* lw_st) {
  const int nlay = A.nlay, ng = fixed_or<S::NG>(B.ngpt);
  const float thresh = sqrtf(FLT_EPSILON);
  const PlanckAt top = planck_at(W, ng, W.tlev[(size_t)c * (nlay + 1) + ja]);
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    float b_top = planck_value(W.planck, g, ng, top.off, top.w);
    for (int j = ja; j < jb; ++j) {
      const float* p = prm + j * prm_stride;
      const Corners<T> w(p[1], p[2]);
      const float tau = gas_tau_params<T, S, NT>(
          B, G, __float_as_int(p[0]) * ng + g, w, p + 8);
      const float b_lay =
          planck_value(W.planck, g, ng, __float_as_int(p[4]), p[5]);
      const float b_bot =
          planck_value(W.planck, g, ng, __float_as_int(p[6]), p[7]);
      float* st = lw_st + j * ng + g;
      if (W.n_ang == 1) {
        float tr, sdn, sup;
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
template <typename T, class Sh, int NT>
__device__ __forceinline__ void sw_optics(const Atmos& A, const Grid& G,
                                          const Band& B, const SwSolve& S,
                                          int c, int ja, int jb, int lane,
                                          const float* prm, int prm_stride,
                                          int prm_sw, float* sw_st) {
  const int nlay = A.nlay, ng = fixed_or<Sh::NG>(B.ngpt);
  const float mu0 = S.mu0[c];
  const float inv_mu0 = 1.0f / mu0;
  for (int j = ja; j < jb; ++j) {
    const float* p = prm + j * prm_stride;
    const Corners<T> w(p[1], p[2]);
    const float simple_w = p[3];
    for (int g0 = 0; g0 < ng; g0 += 32) {
      const bool act = g0 + lane < ng;
      const int g = act ? g0 + lane : 0;
      const float tau_ray = simple_w * S.ray[g];
      const float tau = gas_tau_params<T, Sh, NT>(
                            B, G, __float_as_int(p[0]) * ng + g, w,
                            p + prm_sw) +
                        tau_ray;
      float r_dif, t_dif, r_dir, t_dir, t;
      two_stream_g0(tau, tau_ray, mu0, inv_mu0, r_dif, t_dif, r_dir, t_dir,
                    t);
      __syncwarp();
      if (!act) continue;
      float* st = sw_st + j * ng + g;
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
template <int K>
__device__ __forceinline__ float warp_sums(float (&v)[K], int lane) {
#pragma unroll
  for (int n = K, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool hi = lane & off;
#pragma unroll
    for (int q = 0; q < n / 2; ++q) {
      const float keep = hi ? v[q + n / 2] : v[q];
      const float send = hi ? v[q] : v[q + n / 2];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float u = v[0];
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

// The LW sweeps of column c at Gauss angle a from its staged rows st,
// g-summed into this angle's level accumulators up / dn (lane 0 adds, over
// g-chunks in order).
template <int NG>
__device__ __forceinline__ void lw_sweeps_staged(const LwSolve& W,
                                                 const Band& B, int nlay,
                                                 int c, int lane, int a,
                                                 const float* st,
                                                 float* __restrict__ up,
                                                 float* __restrict__ dn) {
  constexpr int K = SWEEP_K;
  const int ng = fixed_or<NG>(B.ngpt);
  const float thresh = sqrtf(FLT_EPSILON);
  const float sec = W.sec[a], w2pi = W.w2pi[a];
  const PlanckAt sfc = planck_at(W, ng, W.tsfc[c]);
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    // The row blocks at this g-point: tr / tau, src_dn / B(layer),
    // src_up / B(level).
    const float* const r0 = st + g;
    const float* const r1 = r0 + nlay * ng;
    const float* const r2 = r1 + nlay * ng;
    const float e = W.emis[(size_t)c * ng + g];
    const float b_sfc = planck_value(W.planck, g, ng, sfc.off, sfc.w);
    // Transmittance and source of layer j in one direction: staged at 1
    // angle, from the staged tau and Planck terms otherwise.
    auto layer = [&](int j, bool down, float& tr, float& src) {
      const int o = j * ng;
      if (W.n_ang == 1) {
        tr = r0[o];
        src = (down ? r1 : r2)[o];
      } else {
        float sdn, sup;
        lw_layer_sources(r0[o] * sec, r1[o], r2[o], r2[o + ng], thresh, tr,
                         sdn, sup);
        src = down ? sdn : sup;
      }
    };
    float rad = 0.0f;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      float tr[K] = {}, src[K] = {}, r[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < nlay) layer(j0 + k, true, tr[k], src[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 + k < nlay) rad = tr[k] * rad + src[k];
        r[k] = act ? rad : 0.0f;
      }
      const float sum = warp_sums(r, lane);
      const int k = lane / (32 / K);
      if (lane % (32 / K) == 0 && j0 + k < nlay) dn[j0 + k + 1] += w2pi * sum;
    }
    rad = e * b_sfc + (1.0f - e) * rad;
    float last[1] = {act ? rad : 0.0f};
    const float sum = warp_sums(last, lane);
    if (lane == 0) up[nlay] += w2pi * sum;
    for (int j0 = nlay - 1; j0 >= 0; j0 -= K) {
      float tr[K] = {}, src[K] = {}, r[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 - k >= 0) layer(j0 - k, false, tr[k], src[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 - k >= 0) rad = tr[k] * rad + src[k];
        r[k] = act ? rad : 0.0f;
      }
      const float sum = warp_sums(r, lane);
      const int k = lane / (32 / K);
      if (lane % (32 / K) == 0 && j0 - k >= 0) up[j0 - k] += w2pi * sum;
    }
  }
}

// The SW sweeps of column c from its staged rows st (rewritten in place):
// direct beam, adding up, adding down, g-summed into up / dn.  The adding
// denominator is recomputed in the down pass from the staged albedo, the
// same float operation on the same floats as in the up pass.
template <int NG>
__device__ __forceinline__ void sw_sweeps_staged(const SwSolve& W,
                                                 const Band& B, int nlay,
                                                 int c, int lane, float* st,
                                                 float* __restrict__ up,
                                                 float* __restrict__ dn) {
  constexpr int K = SWEEP_K;
  const int ng = fixed_or<NG>(B.ngpt);
  const float mu0 = W.mu0[c];
  const float scale = W.tsi_scale[c];
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    // The row blocks at this g-point (common.cuh "Per-column staging"),
    // row j of each at [j * ng].
    float* const rdif = st + g;
    float* const tdif = rdif + sw_row_tdif(nlay) * ng;
    float* const src_r = rdif + sw_row_src(nlay) * ng;
    float* const srcdn = rdif + sw_row_srcdn(nlay) * ng;
    float* const alb_r = rdif + sw_row_alb(nlay) * ng;
    // Direct beam: r_dir and t_dir become the layer sources.
    float direct = mu0 * scale * W.solar[g];
    float top[1] = {act ? direct : 0.0f};
    const float top_sum = warp_sums(top, lane);
    if (lane == 0) dn[0] += top_sum;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      const int o = j0 * ng;
      float r_dir[K] = {}, t_dir[K] = {}, t[K] = {}, r[K];
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
        r[k] = act ? direct : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (act && j0 + k < nlay) {
          src_r[o + k * ng] = r_dir[k];
          srcdn[o + k * ng] = t_dir[k];
        }
      const float sum = warp_sums(r, lane);
      const int k = lane / (32 / K);
      if (lane % (32 / K) == 0 && j0 + k < nlay) dn[j0 + k + 1] += sum;
    }
    // Upward adding pass (common.sw_adding_up_step): the albedo and the
    // source below each level replace t and the layer's upward source.
    float albedo = W.alb[(size_t)c * ng + g];
    float src = albedo * direct;
    if (act) {
      alb_r[nlay * ng] = albedo;
      src_r[nlay * ng] = src;
    }
    for (int j0 = nlay - 1; j0 >= 0; j0 -= K) {
      const int o = j0 * ng;
      float r_dif[K] = {}, t_dif[K] = {}, su[K] = {}, sd[K] = {};
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
          const float denom = 1.0f / (1.0f - r_dif[k] * albedo);
          const float src_new =
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
    float toa[1] = {act ? src : 0.0f};
    const float toa_sum = warp_sums(toa, lane);
    if (lane == 0) up[0] += toa_sum;
    // Downward adding pass (common.sw_adding_dn_step).
    float dif = 0.0f;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      const int o = j0 * ng;
      float r_dif[K] = {}, t_dif[K] = {}, sd[K] = {}, alb[K] = {},
            src_next[K] = {}, denom[K];
      float v[2 * K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 + k < nlay) {
          r_dif[k] = rdif[o + k * ng];
          t_dif[k] = tdif[o + k * ng];
          sd[k] = srcdn[o + k * ng];
          alb[k] = alb_r[o + (k + 1) * ng];
          src_next[k] = src_r[o + (k + 1) * ng];
        }
        denom[k] = 1.0f / (1.0f - r_dif[k] * alb[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float upv = 0.0f;
        if (j0 + k < nlay) {
          dif = (t_dif[k] * dif + r_dif[k] * src_next[k] + sd[k]) * denom[k];
          upv = dif * alb[k] + src_next[k];
        }
        v[k] = act ? dif : 0.0f;
        v[K + k] = act ? upv : 0.0f;
      }
      // v[k]: diffuse down at level j0 + k + 1; v[K + k]: up there.
      const float sum = warp_sums(v, lane);
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
