// Merged longwave + shortwave flux kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ecckd_tpu/ops/pallas/lwsw.py:61 _lwsw_kernel
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
// What bounds it on this card.  Arithmetic on little data: per column it
// reads ~2.5 KB and writes 4 (nlay+1) floats, and the 0.7-2.7 MB tables
// stay in the 50 MB L2, so bytes bound it at ~0.05 ms at 65,536 x 60;
// per (layer, g-point) a band does ~200 float operations (bilinear
// gathers over 6-8 gases, Planck, accurate expm1f/sqrtf/divides), ~0.7 ms
// at the card's f32 peak (chip_smoke.py phase 8 counts both).  What keeps
// the kernel above that is latency and issue: each slot turns over in
// its optics, then its sweeps, and C = 2 slots keep the optics warps busy
// only while a slot's sweeps take no longer than the other slot's optics;
// every instruction on the optics warps' path (addressing, g-independent
// work repeated per g-point) lengthens the turn.
//
// Design: staged.cuh's body with both bands, LW and SW (sets of one sweep
// warp per LW Gauss angle and one SW sweep warp), instantiated with the
// shipped models' shapes as constants (lw_fsck or lw_rrtmgp with sw_wide:
// g-points, gas counts, 6 temperatures) and at run time for any other.
// The layer parameters of both bands sit in the layer's SW r_dif row
// where they fit and each optics warp computes its own layers' first,
// one pass per optics warp and column; or, with the parameter stage (one
// LW angle, lw_fsck's 32 g-points, C = 2: staged.py stage_plan), off the
// optics warps' path.  With whole columns in shared memory they sit in
// the layer's first LW row, written by the set's LW sweep warp for the
// slot's next column once its LW sweep is done, beside the SW sweep (at
// nlay 60, 12 passes of ~560 warp instructions a column with 5 of 32
// lanes busy become 2 with every lane busy), and the SW optics run before
// the LW optics, which overwrite them.  On the split route (nlay 124-175),
// whose sweeps leave no such room, they sit in a place of their own after
// the accumulators, and each optics warp computes its layers' before it
// waits for the slot, while the slot's sweeps finish.
// C = 2 columns per block where two fit in shared memory, each swept by
// its own set (S = 2; nlay 60: two blocks of 512 threads per SM); where
// only one whole column fits but two without their LW rows do (nlay
// 124-208 at 1 angle), the split route keeps C = 2 with each slot's LW
// rows in a device memory slice (L2-resident); with lw_rrtmgp's 36
// g-points, whose LW optics and sweeps take one pass over a warp's
// (layer, g-point) pairs at float (common.cuh "Layout"), also where whole columns
// would leave one block per SM and split ones keep two (nlay 59-103 at 1
// angle: 7.2-7.4 against 10.1 ms at nlay 60), and on the split route at
// one angle each set sweeps that band's two g-chunks on an LW warp each
// where their accumulators fit beside the plan (Tile.lw_warps); a column
// too deep for shared memory (nlay >~ 250 at these ngpt) is staged whole
// in the slice.
//
// Double precision.  lwsw_f64_kernel is the same body at compute type
// double (common.cuh "Compute type") on the exact f64 table, for callers
// that keep rte-rrtmgp's default working precision: every staged row,
// layer parameter, accumulator and output is a double, so a slot takes
// twice the bytes and staged.py's plan fits half the columns per block.
// The same shapes, routes and parameter stage as at float; no fast mode.
//
// The LW surface-temperature Jacobian.  lwsw_jac_kernel is the float body
// (exact and bf16 tables) with RTE's flux_up_Jac as a fifth output: the
// LW sweep warp carries d rad / d T_sfc up beside the radiance (staged.cuh
// JAC, common.cuh lw_sweeps_chunks) into one more accumulator row.  It is
// instantiated for the shipped lw_fsck + sw_wide shapes at one angle,
// whole in shared memory or split (pick_jac); the launch side
// (ops/cuda/staged.py jac_refusal) keeps every other call off it.

// Host interface (ctypes): ecckd_lwsw_launch(const LwswArgs*, stream)
// (exact f32 table), ecckd_lwsw_launch_fast (the fast mode's bf16 table,
// common.cuh "Table mode") and ecckd_lwsw_launch_f64(const LwswArgs64*,
// stream) (double) each return cudaGetLastError() after the launch;
// ecckd_lwsw_occupancy(const LwswArgs*, fast) and
// ecckd_lwsw_occupancy_f64(const LwswArgs64*) return the blocks per SM of
// a launch configuration (tile.threads, tile.shared_bytes; the route
// (staged.cuh staging_of), the bands' shapes and the grid's n_t pick the
// instantiation), or -1; ecckd_lwsw_args_size() and
// ecckd_lwsw_f64_args_size() let the wrapper check its struct mirrors
// (ops/cuda/binding.py), and ecckd_cuda_error_string() names an error code.
// The Jacobian instantiation: ecckd_lwsw_launch_jac(const LwswJacArgs*,
// stream) and ..._launch_jac_fast, ecckd_lwsw_occupancy_jac(const
// LwswJacArgs*, fast) and ecckd_lwsw_jac_args_size(); a launch of a shape,
// route or angle count it has no instantiation for returns
// cudaErrorInvalidValue.
// The checked build (-DECCKD_CHECK_RING) adds ring_check.cuh's entry points,
// the timed build (-DECCKD_TIME_ROLES) role_clock.cuh's.

#include "staged.cuh"

struct LwswArgs {
  Atmos atm;
  Grid grid;  // the LW model's, equal to the SW model's (mergeable pair)
  Band lw_band;
  Band sw_band;
  LwSolve lw;
  SwSolve sw;
  Tile tile;
};

// LwswArgs at compute type double.
struct LwswArgs64 {
  AtmosT<double> atm;
  GridT<double> grid;
  BandT<double> lw_band;
  BandT<double> sw_band;
  LwSolveT<double> lw;
  SwSolveT<double> sw;
  Tile tile;
};

// LwswArgs and the Jacobian's output, d flux_up / d T_sfc (ncol, nlay+1)
// [W m-2 K-1].
struct LwswJacArgs {
  Atmos atm;
  Grid grid;
  Band lw_band;
  Band sw_band;
  LwSolve lw;
  SwSolve sw;
  Tile tile;
  float* jac;
};

namespace {

template <typename T, class SL, class SS, int NT, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    lwsw_kernel(const __grid_constant__ LwswArgs args) {
  staged_body<T, SL, SS, NT, SHARED ? STAGE_SHARED : STAGE_DEVICE>(
      args.atm, args.grid, &args.lw_band, &args.sw_band, &args.lw, &args.sw,
      args.tile);
}

// The split route (staged.cuh Staging): each slot's LW rows in the
// block's device slice, its SW rows and accumulators in shared memory.
template <typename T, class SL, class SS, int NT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    lwsw_split_kernel(const __grid_constant__ LwswArgs args) {
  staged_body<T, SL, SS, NT, STAGE_SPLIT>(args.atm, args.grid,
                                          &args.lw_band, &args.sw_band,
                                          &args.lw, &args.sw, args.tile);
}

// Threads per SM of the double instantiations in shared memory (whole
// or split; ops/cuda/staged.py F64_SM_THREADS): 80 registers each, where
// 1024 threads at 64 spill 36-244 B (K1 at 65,536 x 60 on an H100: 10.35
// against 11.44 ms; PERF.md §6).  Device staging keeps 1024 at 64
// registers (two blocks of 512: 45.0 against 46.6 ms at nlay 137).
constexpr int F64_SHARED_THREADS = 768;

// Every route at compute type double.
template <class SL, class SS, int NT, int STAGING>
__global__ void __launch_bounds__(
    STAGING == STAGE_DEVICE ? MAX_THREADS : F64_SHARED_THREADS, 1)
    lwsw_f64_kernel(const __grid_constant__ LwswArgs64 args) {
  staged_body<double, SL, SS, NT, STAGING>(args.atm, args.grid,
                                           &args.lw_band, &args.sw_band,
                                           &args.lw, &args.sw, args.tile);
}

// The kernels of table type T: the argument struct and the instantiation
// of a route.
template <typename T>
struct Kernels {
  using Args = LwswArgs;
  template <class SL, class SS, int NT, int STAGING>
  static KernelFn<Args> of() {
    if constexpr (STAGING == STAGE_SPLIT)
      return lwsw_split_kernel<T, SL, SS, NT>;
    else
      return lwsw_kernel<T, SL, SS, NT, STAGING == STAGE_SHARED>;
  }
};

template <>
struct Kernels<double> {
  using Args = LwswArgs64;
  template <class SL, class SS, int NT, int STAGING>
  static KernelFn<Args> of() {
    return lwsw_f64_kernel<SL, SS, NT, STAGING>;
  }
};

// The shipped models' shapes as constants, whole in shared memory or
// split; any other shape, and device staging, at run time.
template <typename T, typename Args = typename Kernels<T>::Args>
KernelFn<Args> pick(const Args* a) {
  using K = Kernels<T>;
  const Staging route = staging_of(a->tile);
  if (route == STAGE_DEVICE)
    return K::template of<Shape<0>, Shape<0>, 0, STAGE_DEVICE>();
  const bool split = route == STAGE_SPLIT;
  if (a->grid.n_t == SHIPPED_NT && has_shape<WideShape>(a->sw_band)) {
    if (has_shape<FsckShape>(a->lw_band))
      return split
                 ? K::template of<FsckShape, WideShape, SHIPPED_NT,
                                  STAGE_SPLIT>()
                 : K::template of<FsckShape, WideShape, SHIPPED_NT,
                                  STAGE_SHARED>();
    if (has_shape<RrtmgpShape>(a->lw_band))
      return split
                 ? K::template of<RrtmgpShape, WideShape, SHIPPED_NT,
                                  STAGE_SPLIT>()
                 : K::template of<RrtmgpShape, WideShape, SHIPPED_NT,
                                  STAGE_SHARED>();
  }
  return split ? K::template of<Shape<0>, Shape<0>, 0, STAGE_SPLIT>()
               : K::template of<Shape<0>, Shape<0>, 0, STAGE_SHARED>();
}

template <typename T, typename Args>
int launch(const Args* args, void* stream) {
  return launch_staged(pick<T>(args), args, stream);
}

// The Jacobian instantiation, whole in shared memory or split.
template <typename T, class SL, class SS, int NT, int STAGING>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    lwsw_jac_kernel(const __grid_constant__ LwswJacArgs args) {
  staged_body<T, SL, SS, NT, STAGING, true>(args.atm, args.grid,
                                            &args.lw_band, &args.sw_band,
                                            &args.lw, &args.sw, args.tile,
                                            args.jac);
}

// The shipped lw_fsck + sw_wide shapes as constants; null for any other
// shape and for device staging.
template <typename T>
KernelFn<LwswJacArgs> pick_jac(const LwswJacArgs* a) {
  const Staging route = staging_of(a->tile);
  if (route == STAGE_DEVICE || a->grid.n_t != SHIPPED_NT ||
      !has_shape<FsckShape>(a->lw_band) || !has_shape<WideShape>(a->sw_band))
    return nullptr;
  if (route == STAGE_SPLIT)
    return lwsw_jac_kernel<T, FsckShape, WideShape, SHIPPED_NT, STAGE_SPLIT>;
  return lwsw_jac_kernel<T, FsckShape, WideShape, SHIPPED_NT, STAGE_SHARED>;
}

// One angle only: the angles' warps would add into one Jacobian row.
template <typename T>
int launch_jac(const LwswJacArgs* args, void* stream) {
  if (args->lw.n_ang != 1) return (int)cudaErrorInvalidValue;
  return launch_staged(pick_jac<T>(args), args, stream);
}

}  // namespace

extern "C" int ecckd_lwsw_args_size() { return (int)sizeof(LwswArgs); }

extern "C" int ecckd_lwsw_launch(const LwswArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int ecckd_lwsw_launch_fast(const LwswArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}

extern "C" int ecckd_lwsw_occupancy(const LwswArgs* args, int fast) {
  return fast ? occupancy_staged(pick<__nv_bfloat16>(args), args)
              : occupancy_staged(pick<float>(args), args);
}

extern "C" int ecckd_lwsw_f64_args_size() { return (int)sizeof(LwswArgs64); }

extern "C" int ecckd_lwsw_launch_f64(const LwswArgs64* args, void* stream) {
  return launch<double>(args, stream);
}

extern "C" int ecckd_lwsw_occupancy_f64(const LwswArgs64* args) {
  return occupancy_staged(pick<double>(args), args);
}

extern "C" int ecckd_lwsw_jac_args_size() { return (int)sizeof(LwswJacArgs); }

extern "C" int ecckd_lwsw_launch_jac(const LwswJacArgs* args, void* stream) {
  return launch_jac<float>(args, stream);
}

extern "C" int ecckd_lwsw_launch_jac_fast(const LwswJacArgs* args,
                                          void* stream) {
  return launch_jac<__nv_bfloat16>(args, stream);
}

extern "C" int ecckd_lwsw_occupancy_jac(const LwswJacArgs* args, int fast) {
  return fast ? occupancy_staged(pick_jac<__nv_bfloat16>(args), args)
              : occupancy_staged(pick_jac<float>(args), args);
}

RING_ENTRY_POINTS(lwsw)
ROLE_CLOCK_ENTRY_POINTS(lwsw)
