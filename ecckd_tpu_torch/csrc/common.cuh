// Device code shared by the port's three flux kernels: lwsw.cu (merged
// LW + SW), lw.cu (LW only) and sw.cu (SW only).  The port's counterpart of
// the JAX package's single homes in ecckd_tpu/ops/pallas/common.py: the
// gas optics of one band, the Planck source, the LW layer sources, the
// g = 0 two-stream and the column bodies of both solvers live here once.
//
// Every function takes the inputs of ONE band: the shared per-column
// atmosphere (Atmos), the band's own (p, T) interpolation grid (Grid), its
// gas plan and flat table (Band), and its solver terms (LwSolve or
// SwSolve).  The merged kernel passes the LW model's grid to both bands
// (their grids are equal there); the single-band kernels pass their own
// model's grid.
//
// Layout.  One warp per (column, band); lane = g-point, in a warp-uniform
// loop over chunks of 32 g-points so any ngpt works (padded lanes compute
// on g-point 0 and contribute 0 to the sums).  Tables are flattened in
// natural (gas, [mole fraction,] p, T, g) order with g fastest, so the
// warp's gather at one grid corner is one coalesced 128-byte read.
// Per-column pointers start at the launch's first column; scratch is laid
// out (row, column, g) over the launch's columns.
//
// Table mode.  gas_tau and the column bodies are templates on the table's
// element type T: float interpolates the f32 table exactly (the JAX
// package's bf16x3 mode); __nv_bfloat16 is the fast mode (its bf16 mode):
// bf16 table entries and bf16-rounded corner weights, f32 sums, as the
// TPU's one bf16 MXU pass of the one-hot contraction computes.  Each
// kernel library holds both instantiations, with one entry point each.
//
// Accuracy.  Built without fast-math: expm1f/expf/logf/sqrtf and the
// divides are the IEEE-accurate calls (a fast exp cost ~3e-4 in flux on
// the TPU).  The floors of common.two_stream_g0 (tau >= 1e-8, the
// eps*tau^2 guard on D) and the thin-layer threshold sqrt(eps_f32) are
// kept.  The per-gas, per-g-point clamp max(w*k, 0) is the reference's
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
constexpr int WARPS_PER_BLOCK = 4;
constexpr int KIND_DENSE = 0;
constexpr int VMR_NONE = 0;
constexpr int VMR_PROFILE = 1;
constexpr float PI_F = (float)3.14159265359;
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

// One model's gas plan and flat table.
struct Band {
  const void* table;  // (rows, ngpt), g fastest: float, or __nv_bfloat16
                      // in the fast mode
  int ngpt;
  int nslice;
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
  float* up;            // (ncol, nlay+1), zeroed by the caller (accumulated)
  float* dn;
  float* scratch;       // (rows, ncol, ngpt): 2*nlay rows (1 angle), else
                        // 3*nlay+1
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
  float* up;               // (ncol, nlay+1), zeroed by the caller
  float* dn;
  float* scratch;          // (6*nlay+2, ncol, ngpt)
};

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// Bi-linear (p, T) interpolation of the table block starting at tb
// (already offset to the lower corner and the g-point).
__device__ __forceinline__ float bilinear(const float* tb, int n_t, int ng,
                                          float pw1, float tw1) {
  const float pw0 = 1.0f - pw1, tw0 = 1.0f - tw1;
  return tw0 * (pw0 * tb[0] + pw1 * tb[(size_t)n_t * ng]) +
         tw1 * (pw0 * tb[ng] + pw1 * tb[(size_t)(n_t + 1) * ng]);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The fast mode's bi-linear interpolation (ops/cuda/common.py's
// _bilinear_fast): sum over the four corners of bf16(wp * wt) * k, each
// corner product rounded itself (the factored form above would round
// other values), the bf16 entries widened to f32 and summed in f32.
// Scalar 2-byte loads: a row of 27 or 36 bf16 g-points is not 4-byte
// aligned at every g.
__device__ __forceinline__ float bilinear(const __nv_bfloat16* tb, int n_t,
                                          int ng, float pw1, float tw1) {
  const float pw0 = 1.0f - pw1, tw0 = 1.0f - tw1;
  return bf16_round(pw0 * tw0) * __bfloat162float(tb[0]) +
         bf16_round(pw1 * tw0) * __bfloat162float(tb[(size_t)n_t * ng]) +
         bf16_round(pw0 * tw1) * __bfloat162float(tb[ng]) +
         bf16_round(pw1 * tw1) * __bfloat162float(tb[(size_t)(n_t + 1) * ng]);
}

// Total gas optical depth of g-point g in layer j of column c for band B:
// dense gases then the LUT gas, each clamped at zero before accumulation
// (gas_optics_ecckd.f90:233-238).  T: the table's element type.
template <typename T>
__device__ float gas_tau(const Atmos& A, const Grid& G, const Band& B,
                         const LayerPoint& L, int c, int j, int g) {
  const T* table = static_cast<const T*>(B.table);
  const int ng = B.ngpt, n_t = G.n_t;
  const size_t corner = (size_t)(L.ip * n_t + L.it);
  float tau = 0.0f;
  for (int s = 0; s < B.nslice; ++s) {
    const GasSlice& S = B.s[s];
    if (S.kind == KIND_DENSE) {
      const float w = S.vmr_kind == VMR_NONE
                          ? L.simple_w * S.b
                          : L.simple_w * (S.a * vmr_of(A, S, c, j) + S.b);
      const T* tb = table + ((size_t)S.row0 + corner) * ng + g;
      tau += fmaxf(w * bilinear(tb, n_t, ng, L.wp, L.wt), 0.0f);
    } else {
      const float vmr = vmr_of(A, S, c, j);
      const FracIdx V = frac_index(
          (logf(fmaxf(vmr, S.mf0)) - S.log_mf0) / S.d_log, S.v_hi);
      const size_t stride_v = (size_t)G.n_p * n_t;
      const T* tb =
          table + ((size_t)S.row0 + V.i0 * stride_v + corner) * ng + g;
      const float lo = bilinear(tb, n_t, ng, L.wp, L.wt);
      const float hi = bilinear(tb + stride_v * ng, n_t, ng, L.wp, L.wt);
      const float coeff = (1.0f - V.w1) * lo + V.w1 * hi;
      tau += fmaxf((L.simple_w * vmr) * coeff, 0.0f);
    }
  }
  return tau;
}

// Planck intensity (ops/planck.py): linear interpolation with top-end
// extrapolation, below-grid scaling B = (T/T0)*row0, divided by PI.
// ngpt is read from the band here, not passed in a register: as a
// register argument it cost the merged kernel 5 % on an H100.
__device__ __forceinline__ float planck_at(const LwSolve& W, const Band& B,
                                           float temp, int g) {
  const int ng = B.ngpt;
  const float idx = (temp - W.planck_t0) / W.planck_dt;
  const int i0 = static_cast<int>(
      fminf(fmaxf(floorf(idx), 0.0f), (float)(W.n_planck - 2)));
  const float w1 = idx - (float)i0;
  float b;
  if (idx >= 0.0f)
    b = (1.0f - w1) * W.planck[(size_t)i0 * ng + g] +
        w1 * W.planck[(size_t)(i0 + 1) * ng + g];
  else
    b = (temp / W.planck_t0) * W.planck[g];
  return b / PI_F;
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

// Scratch cell (row, column, g): one warp's row is ngpt contiguous floats.
__device__ __forceinline__ float* cell(float* base, int row, int ncol, int c,
                                       int ng, int g) {
  return base + ((size_t)row * ncol + c) * ng + g;
}

// The LW solve of column c for one band: gas optics, Planck sources,
// no-scattering sweeps at 1-4 angles, g-summed into W.up / W.dn.
template <typename T>
__device__ void lw_column(const Atmos& A, const Grid& G, const Band& B,
                          const LwSolve& W, int c, int lane) {
  const int nlay = A.nlay, ng = B.ngpt, ncol = A.ncol;
  const float thresh = sqrtf(FLT_EPSILON);
  float* up = W.up + (size_t)c * (nlay + 1);
  float* dn = W.dn + (size_t)c * (nlay + 1);
  const float* tlev = W.tlev + (size_t)c * (nlay + 1);
  const float* tlay = A.tlay + (size_t)c * nlay;
  float* S = W.scratch;
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    const float e = W.emis[(size_t)c * ng + g];
    const float b_sfc = planck_at(W, B, W.tsfc[c], g);
    float b_top = planck_at(W, B, tlev[0], g);
    if (W.n_ang == 1) {
      // Layer pass with the fused down sweep; stage trans and src_up.
      const float sec = W.sec[0], w2pi = W.w2pi[0];
      float rad = 0.0f;
      for (int j = 0; j < nlay; ++j) {
        const LayerPoint L = layer_point<T>(A, G, c, j);
        const float tau = gas_tau<T>(A, G, B, L, c, j, g);
        const float b_bot = planck_at(W, B, tlev[j + 1], g);
        float tr, sdn, sup;
        lw_layer_sources(tau * sec, planck_at(W, B, tlay[j], g), b_top,
                         b_bot, thresh, tr, sdn, sup);
        rad = tr * rad + sdn;
        const float sum = warp_sum(act ? rad : 0.0f);
        if (lane == 0) dn[j + 1] += w2pi * sum;
        if (act) {
          *cell(S, j, ncol, c, ng, g) = tr;
          *cell(S, nlay + j, ncol, c, ng, g) = sup;
        }
        b_top = b_bot;
      }
      rad = e * b_sfc + (1.0f - e) * rad;
      float sum = warp_sum(act ? rad : 0.0f);
      if (lane == 0) up[nlay] += w2pi * sum;
      for (int j = nlay - 1; j >= 0; --j) {
        rad = *cell(S, j, ncol, c, ng, g) * rad +
              *cell(S, nlay + j, ncol, c, ng, g);
        sum = warp_sum(act ? rad : 0.0f);
        if (lane == 0) up[j] += w2pi * sum;
      }
    } else {
      // Stage tau, layer Planck and level Planck; sweep per angle
      // (common.multi_angle_lw_sweeps), recomputing the layer sources in
      // the up sweep instead of staging them per angle.
      for (int j = 0; j < nlay; ++j) {
        const LayerPoint L = layer_point<T>(A, G, c, j);
        const float tau = gas_tau<T>(A, G, B, L, c, j, g);
        const float b_bot = planck_at(W, B, tlev[j + 1], g);
        if (act) {
          *cell(S, j, ncol, c, ng, g) = tau;
          *cell(S, nlay + j, ncol, c, ng, g) = planck_at(W, B, tlay[j], g);
          *cell(S, 2 * nlay + j, ncol, c, ng, g) = b_top;
          if (j == nlay - 1) *cell(S, 3 * nlay, ncol, c, ng, g) = b_bot;
        }
        b_top = b_bot;
      }
      for (int a = 0; a < W.n_ang; ++a) {
        const float sec = W.sec[a], w2pi = W.w2pi[a];
        float rad = 0.0f;
        float tr, sdn, sup, sum;
        for (int j = 0; j < nlay; ++j) {
          lw_layer_sources(*cell(S, j, ncol, c, ng, g) * sec,
                           *cell(S, nlay + j, ncol, c, ng, g),
                           *cell(S, 2 * nlay + j, ncol, c, ng, g),
                           *cell(S, 2 * nlay + j + 1, ncol, c, ng, g), thresh,
                           tr, sdn, sup);
          rad = tr * rad + sdn;
          sum = warp_sum(act ? rad : 0.0f);
          if (lane == 0) dn[j + 1] += w2pi * sum;
        }
        rad = e * b_sfc + (1.0f - e) * rad;
        sum = warp_sum(act ? rad : 0.0f);
        if (lane == 0) up[nlay] += w2pi * sum;
        for (int j = nlay - 1; j >= 0; --j) {
          lw_layer_sources(*cell(S, j, ncol, c, ng, g) * sec,
                           *cell(S, nlay + j, ncol, c, ng, g),
                           *cell(S, 2 * nlay + j, ncol, c, ng, g),
                           *cell(S, 2 * nlay + j + 1, ncol, c, ng, g), thresh,
                           tr, sdn, sup);
          rad = tr * rad + sup;
          sum = warp_sum(act ? rad : 0.0f);
          if (lane == 0) up[j] += w2pi * sum;
        }
      }
    }
  }
}

// The SW solve of column c for one band: gas optics + Rayleigh, the TOA
// source mu0 * tsi_scale * solar, g = 0 two-stream, direct beam, adding up
// and down, g-summed into W.up / W.dn.  The night mask is the caller's.
template <typename T>
__device__ void sw_column(const Atmos& A, const Grid& G, const Band& B,
                          const SwSolve& W, int c, int lane) {
  const int nlay = A.nlay, ng = B.ngpt, ncol = A.ncol;
  float* up = W.up + (size_t)c * (nlay + 1);
  float* dn = W.dn + (size_t)c * (nlay + 1);
  float* S = W.scratch;
  // Scratch rows: r_dif, t_dif, src_up (then denom), src_dn, and the
  // per-level albedo / source of the stack below (nlay+1 each).
  const int R_RDIF = 0, R_TDIF = nlay, R_SRCUP = 2 * nlay, R_SRCDN = 3 * nlay,
            R_ALB = 4 * nlay, R_SRC = 5 * nlay + 1;
  const float mu0 = W.mu0[c];
  const float inv_mu0 = 1.0f / mu0;
  const float scale = W.tsi_scale[c];
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    auto at = [&](int row) { return cell(S, row, ncol, c, ng, g); };
    // Layer pass with the fused direct-beam sweep.
    float direct = mu0 * scale * W.solar[g];
    float sum = warp_sum(act ? direct : 0.0f);
    if (lane == 0) dn[0] += sum;
    const float ray = W.ray[g];
    for (int j = 0; j < nlay; ++j) {
      const LayerPoint L = layer_point<T>(A, G, c, j);
      const float tau_ray = L.simple_w * ray;
      const float tau = gas_tau<T>(A, G, B, L, c, j, g) + tau_ray;
      float r_dif, t_dif, r_dir, t_dir, t;
      two_stream_g0(tau, tau_ray, mu0, inv_mu0, r_dif, t_dif, r_dir, t_dir,
                    t);
      if (act) {
        *at(R_RDIF + j) = r_dif;
        *at(R_TDIF + j) = t_dif;
        *at(R_SRCUP + j) = r_dir * direct;
        *at(R_SRCDN + j) = t_dir * direct;
      }
      direct = t * direct;
      sum = warp_sum(act ? direct : 0.0f);
      if (lane == 0) dn[j + 1] += sum;
    }
    // Upward adding pass (common.sw_adding_up_step).
    float albedo = W.alb[(size_t)c * ng + g];
    float src = albedo * direct;
    if (act) {
      *at(R_ALB + nlay) = albedo;
      *at(R_SRC + nlay) = src;
    }
    for (int j = nlay - 1; j >= 0; --j) {
      const float r_dif = *at(R_RDIF + j), t_dif = *at(R_TDIF + j);
      const float denom = 1.0f / (1.0f - r_dif * albedo);
      const float src_new =
          *at(R_SRCUP + j) + t_dif * denom * (src + albedo * *at(R_SRCDN + j));
      albedo = r_dif + t_dif * t_dif * albedo * denom;
      src = src_new;
      if (act) {
        *at(R_SRCUP + j) = denom;
        *at(R_ALB + j) = albedo;
        *at(R_SRC + j) = src;
      }
    }
    sum = warp_sum(act ? src : 0.0f);
    if (lane == 0) up[0] += sum;
    // Downward adding pass (common.sw_adding_dn_step).
    float dif = 0.0f;
    for (int j = 0; j < nlay; ++j) {
      const float src_next = *at(R_SRC + j + 1);
      dif = (*at(R_TDIF + j) * dif + *at(R_RDIF + j) * src_next +
             *at(R_SRCDN + j)) *
            *at(R_SRCUP + j);
      const float upv = dif * *at(R_ALB + j + 1) + src_next;
      const float sd = warp_sum(act ? dif : 0.0f);
      const float su = warp_sum(act ? upv : 0.0f);
      if (lane == 0) {
        dn[j + 1] += sd;
        up[j + 1] += su;
      }
    }
  }
}

// ---- The tiled merged solve (lwsw.cu): per-column staging ----------------
//
// lwsw.cu splits a column's solve into optics, parallel over the column's
// layers, and sweeps, serial over them, that meet in one staging area per
// column (float32; each row holds ngpt floats, g fastest), in shared
// memory or, for columns too deep for it, in a device memory slice
// (ops/cuda/lwsw.py stage_plan sizes it):
//   LW rows (ngpt_lw each): at 1 angle tr, src_dn, src_up (nlay each); at
//     2-4 angles tau, B(layer) (nlay each) and B(level) (nlay+1);
//   SW rows (ngpt_sw each): r_dif, t_dif (nlay each); r_dir (nlay+1),
//     then r_dir * direct, then the source of the stack below each level;
//     t_dir (nlay), then t_dir * direct; t (nlay+1), then the albedo of
//     the stack below each level;
//   the g-summed level fluxes: up and down (nlay+1 each) per LW angle,
//     then SW up and down;
//   the layer parameters (below): in layer j's r_dif row when they fit
//     there, which the layer's optics overwrite only after reading them.
// The arithmetic per (layer, g) is lw_column's / sw_column's above; only
// where each value waits between the phases, and the order of the g-sums,
// differ.

constexpr int SW_RDIF = 0;  // SW row blocks, in units of nlay (+ offsets)

__device__ __forceinline__ int sw_row_tdif(int nlay) { return nlay; }
__device__ __forceinline__ int sw_row_src(int nlay) { return 2 * nlay; }
__device__ __forceinline__ int sw_row_srcdn(int nlay) { return 3 * nlay + 1; }
__device__ __forceinline__ int sw_row_alb(int nlay) { return 4 * nlay + 1; }

// Layer parameters.  What the optics of a layer need that does not depend
// on the g-point is computed once per layer, with lanes over layers,
// before the optics: per layer, in order,
//   the table corner ip * n_t + it (int bits), wp, wt, simple_w;
//   for each gas of the LW band, then of the SW band: a dense gas's weight
//   simple_w * (a * vmr + b); a LUT gas's first table row at its lower
//   mole-fraction point (int bits), its weight w1 and simple_w * vmr.
// The same float operations as layer_point / gas_tau, on the same floats.
__device__ __forceinline__ int band_params(const Atmos& A, const Grid& G,
                                          const Band& B, const LayerPoint& L,
                                          int c, int j, float* p) {
  int k = 0;
  for (int s = 0; s < B.nslice; ++s) {
    const GasSlice& S = B.s[s];
    if (S.kind == KIND_DENSE) {
      p[k++] = S.vmr_kind == VMR_NONE
                   ? L.simple_w * S.b
                   : L.simple_w * (S.a * vmr_of(A, S, c, j) + S.b);
    } else {
      const float vmr = vmr_of(A, S, c, j);
      const FracIdx V = frac_index(
          (logf(fmaxf(vmr, S.mf0)) - S.log_mf0) / S.d_log, S.v_hi);
      p[k] = __int_as_float(S.row0 + V.i0 * G.n_p * G.n_t);
      p[k + 1] = V.w1;
      p[k + 2] = L.simple_w * vmr;
      k += 3;
    }
  }
  return k;
}

template <typename T>
__device__ void lwsw_layer_params(const Atmos& A, const Grid& G,
                                  const Band& BL, const Band& BS, int c,
                                  int j, float* p) {
  const LayerPoint L = layer_point<T>(A, G, c, j);
  p[0] = __int_as_float(L.ip * G.n_t + L.it);
  p[1] = L.wp;
  p[2] = L.wt;
  p[3] = L.simple_w;
  const int k = band_params(A, G, BL, L, c, j, p + 4);
  band_params(A, G, BS, L, c, j, p + 4 + k);
}

// bilinear's weights, formed once per layer: Corners<T>(wp, wt)(tb, d_t,
// d_p) interpolates the block at tb (d_t: the next temperature, d_p: the
// next pressure) with the same arithmetic as bilinear.
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

template <>
struct Corners<__nv_bfloat16> {
  float w00, w10, w01, w11;  // bf16(wp_i * wt_j), as bilinear rounds them
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

// gas_tau of one g-point from the layer parameters p of band B: cb is the
// table at the layer's (p, T) corner row and the g-point.
template <typename T>
__device__ __forceinline__ float gas_tau_params(const Band& B, const Grid& G,
                                                const T* cb,
                                                const Corners<T>& w,
                                                const float* p) {
  const int ng = B.ngpt, d_p = G.n_t * ng, d_v = G.n_p * G.n_t * ng;
  float tau = 0.0f;
  int k = 0;
  for (int s = 0; s < B.nslice; ++s) {
    if (B.s[s].kind == KIND_DENSE) {
      tau += fmaxf(p[k] * w(cb + B.s[s].row0 * ng, ng, d_p), 0.0f);
      k += 1;
    } else {
      const T* tb = cb + __float_as_int(p[k]) * ng;
      const float w1 = p[k + 1];
      const float lo = w(tb, ng, d_p);
      const float hi = w(tb + d_v, ng, d_p);
      const float coeff = (1.0f - w1) * lo + w1 * hi;
      tau += fmaxf(p[k + 2] * coeff, 0.0f);
      k += 3;
    }
  }
  return tau;
}

// planck_at split into its g-independent point and its per-g value.
struct PlanckPoint {
  int i0;
  float w1, scale;
  bool below;
};

__device__ __forceinline__ PlanckPoint planck_point(const LwSolve& W,
                                                    float temp) {
  const float idx = (temp - W.planck_t0) / W.planck_dt;
  const int i0 = static_cast<int>(
      fminf(fmaxf(floorf(idx), 0.0f), (float)(W.n_planck - 2)));
  return {i0, idx - (float)i0, temp / W.planck_t0, !(idx >= 0.0f)};
}

// pg: the Planck table at the g-point.
__device__ __forceinline__ float planck_gpt(const float* pg, int ng,
                                            const PlanckPoint& q) {
  const float b = q.below ? q.scale * pg[0]
                          : (1.0f - q.w1) * pg[q.i0 * ng] +
                                q.w1 * pg[(q.i0 + 1) * ng];
  return b / PI_F;
}

// Optics of layer j of column c for both bands of a merged solve from its
// layer parameters prm (the SW band's from prm + prm_sw): the LW rows of
// lw_st and the SW rows of sw_st at layer j.  One warp, lane = g-point.
// The parameters may share the SW rows of layer j: every store here
// follows the last parameter read.
template <typename T>
__device__ void lwsw_layer_optics(const Atmos& A, const Grid& G,
                                  const Band& BL, const Band& BS,
                                  const LwSolve& W, const SwSolve& S, int c,
                                  int j, int lane, const float* prm,
                                  int prm_sw, float* lw_st, float* sw_st) {
  const int nlay = A.nlay;
  const int corner = __float_as_int(prm[0]);
  const Corners<T> w(prm[1], prm[2]);
  const float simple_w = prm[3];
  const float* tlev = W.tlev + (size_t)c * (nlay + 1);
  const PlanckPoint q_top = planck_point(W, tlev[j]);
  const PlanckPoint q_bot = planck_point(W, tlev[j + 1]);
  const PlanckPoint q_lay = planck_point(W, A.tlay[(size_t)c * nlay + j]);
  const int ngl = BL.ngpt;
  for (int g0 = 0; g0 < ngl; g0 += 32) {
    const bool act = g0 + lane < ngl;
    const int g = act ? g0 + lane : 0;
    const float tau = gas_tau_params<T>(
        BL, G, static_cast<const T*>(BL.table) + (corner * ngl + g), w,
        prm + 4);
    const float* pg = W.planck + g;
    const float b_top = planck_gpt(pg, ngl, q_top);
    const float b_bot = planck_gpt(pg, ngl, q_bot);
    const float b_lay = planck_gpt(pg, ngl, q_lay);
    if (!act) continue;
    if (W.n_ang == 1) {
      float tr, sdn, sup;
      lw_layer_sources(tau * W.sec[0], b_lay, b_top, b_bot,
                       sqrtf(FLT_EPSILON), tr, sdn, sup);
      lw_st[j * ngl + g] = tr;
      lw_st[(nlay + j) * ngl + g] = sdn;
      lw_st[(2 * nlay + j) * ngl + g] = sup;
    } else {
      lw_st[j * ngl + g] = tau;
      lw_st[(nlay + j) * ngl + g] = b_lay;
      lw_st[(2 * nlay + j) * ngl + g] = b_top;
      if (j == nlay - 1) lw_st[3 * nlay * ngl + g] = b_bot;
    }
  }
  const int ngs = BS.ngpt;
  const float mu0 = S.mu0[c];
  const float inv_mu0 = 1.0f / mu0;
  for (int g0 = 0; g0 < ngs; g0 += 32) {
    const bool act = g0 + lane < ngs;
    const int g = act ? g0 + lane : 0;
    const float tau_ray = simple_w * S.ray[g];
    const float tau =
        gas_tau_params<T>(BS, G,
                          static_cast<const T*>(BS.table) + (corner * ngs + g),
                          w, prm + prm_sw) +
        tau_ray;
    float r_dif, t_dif, r_dir, t_dir, t;
    two_stream_g0(tau, tau_ray, mu0, inv_mu0, r_dif, t_dif, r_dir, t_dir, t);
    __syncwarp();  // every lane has read prm before any lane overwrites it
    if (!act) continue;
    sw_st[(SW_RDIF + j) * ngs + g] = r_dif;
    sw_st[(sw_row_tdif(nlay) + j) * ngs + g] = t_dif;
    sw_st[(sw_row_src(nlay) + j) * ngs + g] = r_dir;
    sw_st[(sw_row_srcdn(nlay) + j) * ngs + g] = t_dir;
    sw_st[(sw_row_alb(nlay) + j) * ngs + g] = t;
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
// coefficients first, runs the recurrence through them, then g-sums the
// SWEEP_K levels together, so neither the loads nor the shuffles wait on
// one layer at a time.
constexpr int SWEEP_K = 4;

// The LW sweeps of column c at Gauss angle a from its staged rows st,
// g-summed into this angle's level accumulators up / dn (lane 0 adds, over
// g-chunks in lw_column's order).
__device__ __forceinline__ void lw_sweeps_staged(const LwSolve& W,
                                                 const Band& B, int nlay,
                                                 int c, int lane, int a,
                                                 const float* st,
                                                 float* __restrict__ up,
                                                 float* __restrict__ dn) {
  constexpr int K = SWEEP_K;
  const int ng = B.ngpt;
  const float thresh = sqrtf(FLT_EPSILON);
  const float sec = W.sec[a], w2pi = W.w2pi[a];
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    const float* const stg = st + g;
    auto at = [&](int row) { return stg[row * ng]; };
    const float e = W.emis[(size_t)c * ng + g];
    const float b_sfc = planck_at(W, B, W.tsfc[c], g);
    // Transmittance and source of layer j in one direction: staged at 1
    // angle, from the staged tau and Planck terms otherwise.
    auto layer = [&](int j, bool down, float& tr, float& src) {
      if (W.n_ang == 1) {
        tr = at(j);
        src = at((down ? nlay : 2 * nlay) + j);
      } else {
        float sdn, sup;
        lw_layer_sources(at(j) * sec, at(nlay + j), at(2 * nlay + j),
                         at(2 * nlay + j + 1), thresh, tr, sdn, sup);
        src = down ? sdn : sup;
      }
    };
    float rad = 0.0f;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      float tr[K], src[K], r[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        layer(min(j0 + k, nlay - 1), true, tr[k], src[k]);
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
      float tr[K], src[K], r[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        layer(max(j0 - k, 0), false, tr[k], src[k]);
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
__device__ __forceinline__ void sw_sweeps_staged(const SwSolve& W,
                                                 const Band& B, int nlay,
                                                 int c, int lane, float* st,
                                                 float* __restrict__ up,
                                                 float* __restrict__ dn) {
  constexpr int K = SWEEP_K;
  const int ng = B.ngpt;
  const int R_TDIF = sw_row_tdif(nlay), R_SRC = sw_row_src(nlay),
            R_SRCDN = sw_row_srcdn(nlay), R_ALB = sw_row_alb(nlay);
  const float mu0 = W.mu0[c];
  const float scale = W.tsi_scale[c];
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    float* const stg = st + g;
    auto at = [&](int row) { return stg + row * ng; };
    // Direct beam: r_dir and t_dir become the layer sources.
    float direct = mu0 * scale * W.solar[g];
    float top[1] = {act ? direct : 0.0f};
    const float top_sum = warp_sums(top, lane);
    if (lane == 0) dn[0] += top_sum;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      float r_dir[K], t_dir[K], t[K], r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = min(j0 + k, nlay - 1);
        r_dir[k] = *at(R_SRC + j);
        t_dir[k] = *at(R_SRCDN + j);
        t[k] = *at(R_ALB + j);
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
          *at(R_SRC + j0 + k) = r_dir[k];
          *at(R_SRCDN + j0 + k) = t_dir[k];
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
      *at(R_ALB + nlay) = albedo;
      *at(R_SRC + nlay) = src;
    }
    for (int j0 = nlay - 1; j0 >= 0; j0 -= K) {
      float r_dif[K], t_dif[K], su[K], sd[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = max(j0 - k, 0);
        r_dif[k] = *at(SW_RDIF + j);
        t_dif[k] = *at(R_TDIF + j);
        su[k] = *at(R_SRC + j);
        sd[k] = *at(R_SRCDN + j);
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
          *at(R_SRC + j0 - k) = su[k];
          *at(R_ALB + j0 - k) = sd[k];
        }
    }
    float toa[1] = {act ? src : 0.0f};
    const float toa_sum = warp_sums(toa, lane);
    if (lane == 0) up[0] += toa_sum;
    // Downward adding pass (common.sw_adding_dn_step).
    float dif = 0.0f;
    for (int j0 = 0; j0 < nlay; j0 += K) {
      float r_dif[K], t_dif[K], sd[K], alb[K], src_next[K], denom[K];
      float v[2 * K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = min(j0 + k, nlay - 1);
        r_dif[k] = *at(SW_RDIF + j);
        t_dif[k] = *at(R_TDIF + j);
        sd[k] = *at(R_SRCDN + j);
        alb[k] = *at(R_ALB + j + 1);
        src_next[k] = *at(R_SRC + j + 1);
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

// Blocks of WARPS_PER_BLOCK warps covering `warps` warps.
inline int blocks_for(long long warps) {
  return (int)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

}  // namespace

extern "C" const char* ecckd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
