// Merged longwave + shortwave flux kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ecckd_tpu/ops/pallas/lwsw.py::_lwsw_kernel
// (wrapper lwsw_fluxes_fused): for every column, both ckd models' gas
// optical depths on ONE shared (pressure, temperature) interpolation grid,
// SW Rayleigh, Planck sources at layers/levels/surface, the LW
// no-scattering solve at 1-4 Gauss angles (linear-in-tau sources) and the
// SW g = 0 two-stream + adding solve, reduced to four broadband
// (ncol, nlay+1) flux profiles.
//
// It computes what the TPU kernel computes, not how: the one-hot matrix
// contractions, bf16x3 splits, lane-blocked layer layout and pressure /
// mole-fraction windows there exist only because the TPU has no fast
// gather.  Here every table entry is gathered directly.
//
// Layout.  One warp per (column, band): even warps run the LW solve of a
// column, odd warps its SW solve.  Lane = g-point, in a warp-uniform loop
// over chunks of 32 g-points so any ngpt works (padded lanes compute on
// g-point 0 and contribute 0 to the sums).  Tables are flattened in
// natural (gas, [mole fraction,] p, T, g) order with g fastest, so the
// warp's gather at one grid corner is one coalesced 128-byte read.
//
// What bounds it on this card.  Per layer and g-point a band gathers
// 4 table values per dense gas and 8 for the h2o LUT (the 0.7-2.7 MB
// tables stay resident in the 50 MB L2), then runs a few expm1f/expf/
// divides.  The backward sweeps need per-layer coefficients of the forward
// pass, which go through device memory: the scratch round trip (LW 2
// floats, SW 6 floats per layer and g-point at 1 angle) is the dominant
// DRAM traffic.  The design keeps it coalesced by laying scratch out as
// (row, column, g) and fuses the forward sweeps (LW down radiance, SW
// direct beam) into the layer pass so their coefficients never leave
// registers; holding the backward coefficients on chip is later work.
//
// Accuracy.  Built without fast-math: expm1f/expf/logf/sqrtf and the
// divides are the IEEE-accurate calls (a fast exp cost ~3e-4 in flux on
// the TPU).  The floors of common.two_stream_g0 (tau >= 1e-8, the
// eps*tau^2 guard on D) and the thin-layer threshold sqrt(eps_f32) are
// kept.  The per-gas, per-g-point clamp max(w*k, 0) is the reference's
// (optical_depth.py), so no table sign precondition applies.
//
// Host interface (ctypes): ecckd_lwsw_launch(const LwswArgs*, stream)
// returns cudaGetLastError() after the launch; ecckd_lwsw_args_size()
// lets the wrapper check its struct mirror (ops/cuda/lwsw.py), and
// ecckd_cuda_error_string() names an error code.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

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

struct Band {
  const float* table;  // (rows, ngpt), g fastest
  int ngpt;
  int nslice;
  GasSlice s[MAX_SLICES];
};

struct LwswArgs {
  // Per-column inputs, float32, row-major, column-major outermost.
  const float* plev;       // (ncol, nlay+1)
  const float* tlay;       // (ncol, nlay)
  const float* tlev;       // (ncol, nlay+1)
  const float* tsfc;       // (ncol)
  const float* emis;       // (ncol, ng_lw)
  const float* alb;        // (ncol, ng_sw)
  const float* mu0;        // (ncol)
  const float* tsi_scale;  // (ncol)
  const float* vmr_prof;   // (ncol, n_prof, nlay)
  const float* vmr_scal;   // (ncol, n_scal)
  // Model arrays.
  const float* t_first;    // (n_p) first temperature-grid column
  const float* planck;     // (n_planck, ng_lw)
  const float* solar;      // (ng_sw)
  const float* ray;        // (ng_sw)
  // Outputs, (ncol, nlay+1), zeroed by the caller (accumulated).
  float* lw_up;
  float* lw_dn;
  float* sw_up;
  float* sw_dn;
  // Scratch, (rows, ncol, ngpt).
  float* lw_scratch;       // 2*nlay rows (1 angle) or 3*nlay+1
  float* sw_scratch;       // 6*nlay+2 rows
  Band lw;
  Band sw;
  int ncol, nlay, n_prof, n_scal, n_p, n_t, n_planck, n_ang;
  float log_p0, d_log_p, p_hi, dt, t_hi, planck_t0, planck_dt;
  float sec[4];
  float w2pi[4];
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

__device__ __forceinline__ LayerPoint layer_point(const LwswArgs& A, int c,
                                                  int j) {
  const float* pl = A.plev + (size_t)c * (A.nlay + 1);
  const float p0 = pl[j], p1 = pl[j + 1];
  const float log_p = logf(0.5f * (p1 + p0));
  const FracIdx P = frac_index((log_p - A.log_p0) / A.d_log_p, A.p_hi);
  // Pressure-dependent temperature origin (gas_optics_ecckd.f90:131-132).
  const float t0 =
      (1.0f - P.w1) * A.t_first[P.i0] + P.w1 * A.t_first[P.i0 + 1];
  const FracIdx T =
      frac_index((A.tlay[(size_t)c * A.nlay + j] - t0) / A.dt, A.t_hi);
  return {P.i0, T.i0, P.w1, T.w1, MOLES_PER_PA_F * (p1 - p0)};
}

__device__ __forceinline__ float vmr_of(const LwswArgs& A, const GasSlice& S,
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

// Total gas optical depth of g-point g in layer j of column c for band B:
// dense gases then the LUT gas, each clamped at zero before accumulation
// (gas_optics_ecckd.f90:233-238).
__device__ float gas_tau(const LwswArgs& A, const Band& B,
                         const LayerPoint& L, int c, int j, int g) {
  const int ng = B.ngpt, n_t = A.n_t;
  const size_t corner = (size_t)(L.ip * n_t + L.it);
  float tau = 0.0f;
  for (int s = 0; s < B.nslice; ++s) {
    const GasSlice& S = B.s[s];
    if (S.kind == KIND_DENSE) {
      const float w = S.vmr_kind == VMR_NONE
                          ? L.simple_w * S.b
                          : L.simple_w * (S.a * vmr_of(A, S, c, j) + S.b);
      const float* tb = B.table + ((size_t)S.row0 + corner) * ng + g;
      tau += fmaxf(w * bilinear(tb, n_t, ng, L.wp, L.wt), 0.0f);
    } else {
      const float vmr = vmr_of(A, S, c, j);
      const FracIdx V = frac_index(
          (logf(fmaxf(vmr, S.mf0)) - S.log_mf0) / S.d_log, S.v_hi);
      const size_t stride_v = (size_t)A.n_p * n_t;
      const float* tb =
          B.table + ((size_t)S.row0 + V.i0 * stride_v + corner) * ng + g;
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
__device__ __forceinline__ float planck_at(const LwswArgs& A, float temp,
                                           int g) {
  const int ng = A.lw.ngpt;
  const float idx = (temp - A.planck_t0) / A.planck_dt;
  const int i0 = static_cast<int>(
      fminf(fmaxf(floorf(idx), 0.0f), (float)(A.n_planck - 2)));
  const float w1 = idx - (float)i0;
  float b;
  if (idx >= 0.0f)
    b = (1.0f - w1) * A.planck[(size_t)i0 * ng + g] +
        w1 * A.planck[(size_t)(i0 + 1) * ng + g];
  else
    b = (temp / A.planck_t0) * A.planck[g];
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

__device__ void lw_column(const LwswArgs& A, int c, int lane) {
  const int nlay = A.nlay, ng = A.lw.ngpt, ncol = A.ncol;
  const float thresh = sqrtf(FLT_EPSILON);
  float* up = A.lw_up + (size_t)c * (nlay + 1);
  float* dn = A.lw_dn + (size_t)c * (nlay + 1);
  const float* tlev = A.tlev + (size_t)c * (nlay + 1);
  const float* tlay = A.tlay + (size_t)c * nlay;
  float* S = A.lw_scratch;
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    const float e = A.emis[(size_t)c * ng + g];
    const float b_sfc = planck_at(A, A.tsfc[c], g);
    float b_top = planck_at(A, tlev[0], g);
    if (A.n_ang == 1) {
      // Layer pass with the fused down sweep; stage trans and src_up.
      const float sec = A.sec[0], w2pi = A.w2pi[0];
      float rad = 0.0f;
      for (int j = 0; j < nlay; ++j) {
        const LayerPoint L = layer_point(A, c, j);
        const float tau = gas_tau(A, A.lw, L, c, j, g);
        const float b_bot = planck_at(A, tlev[j + 1], g);
        float tr, sdn, sup;
        lw_layer_sources(tau * sec, planck_at(A, tlay[j], g), b_top, b_bot,
                         thresh, tr, sdn, sup);
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
        const LayerPoint L = layer_point(A, c, j);
        const float tau = gas_tau(A, A.lw, L, c, j, g);
        const float b_bot = planck_at(A, tlev[j + 1], g);
        if (act) {
          *cell(S, j, ncol, c, ng, g) = tau;
          *cell(S, nlay + j, ncol, c, ng, g) = planck_at(A, tlay[j], g);
          *cell(S, 2 * nlay + j, ncol, c, ng, g) = b_top;
          if (j == nlay - 1) *cell(S, 3 * nlay, ncol, c, ng, g) = b_bot;
        }
        b_top = b_bot;
      }
      for (int a = 0; a < A.n_ang; ++a) {
        const float sec = A.sec[a], w2pi = A.w2pi[a];
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

__device__ void sw_column(const LwswArgs& A, int c, int lane) {
  const int nlay = A.nlay, ng = A.sw.ngpt, ncol = A.ncol;
  float* up = A.sw_up + (size_t)c * (nlay + 1);
  float* dn = A.sw_dn + (size_t)c * (nlay + 1);
  float* S = A.sw_scratch;
  // Scratch rows: r_dif, t_dif, src_up (then denom), src_dn, and the
  // per-level albedo / source of the stack below (nlay+1 each).
  const int R_RDIF = 0, R_TDIF = nlay, R_SRCUP = 2 * nlay, R_SRCDN = 3 * nlay,
            R_ALB = 4 * nlay, R_SRC = 5 * nlay + 1;
  const float mu0 = A.mu0[c];
  const float inv_mu0 = 1.0f / mu0;
  const float scale = A.tsi_scale[c];
  for (int g0 = 0; g0 < ng; g0 += 32) {
    const bool act = g0 + lane < ng;
    const int g = act ? g0 + lane : 0;
    auto at = [&](int row) { return cell(S, row, ncol, c, ng, g); };
    // Layer pass with the fused direct-beam sweep.
    float direct = mu0 * scale * A.solar[g];
    float sum = warp_sum(act ? direct : 0.0f);
    if (lane == 0) dn[0] += sum;
    const float ray = A.ray[g];
    for (int j = 0; j < nlay; ++j) {
      const LayerPoint L = layer_point(A, c, j);
      const float tau_ray = L.simple_w * ray;
      const float tau = gas_tau(A, A.sw, L, c, j, g) + tau_ray;
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
    float albedo = A.alb[(size_t)c * ng + g];
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

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    lwsw_kernel(const __grid_constant__ LwswArgs args) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = warp >> 1;
  if (c >= args.ncol) return;  // ragged edge: whole warps retire
  if ((warp & 1) == 0)
    lw_column(args, c, lane);
  else
    sw_column(args, c, lane);
}

}  // namespace

extern "C" int ecckd_lwsw_args_size() { return (int)sizeof(LwswArgs); }

extern "C" const char* ecckd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int ecckd_lwsw_launch(const LwswArgs* args, void* stream) {
  if (args->ncol <= 0) return 0;
  const long long warps = 2LL * args->ncol;
  const int blocks = (int)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  lwsw_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
