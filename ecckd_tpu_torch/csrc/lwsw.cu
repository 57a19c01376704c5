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
// the kernel above that is instruction issue: every instruction that is
// not one of those operations (addressing, g-independent work repeated
// per g-point) costs the same issue slot.
//
// Design: staged.cuh's body with both bands, LW and SW (the layer
// parameters of both bands in the layer's SW r_dif row where they fit,
// one optics pass per band over the warp's layer range, sets of one sweep
// warp per LW Gauss angle and one SW sweep warp), instantiated with the
// shipped models' shapes as constants (lw_fsck or lw_rrtmgp with sw_wide:
// g-points, gas counts, 6 temperatures) and at run time for any other.
// C = 2 columns per block where two fit in shared memory, each swept by
// its own set (S = 2; nlay 60: two blocks of 512 threads per SM); a
// column too deep for shared memory (nlay >~ 250 at these ngpt) is
// staged in a device memory slice.

// Host interface (ctypes): ecckd_lwsw_launch(const LwswArgs*, stream)
// (exact f32 table) and ecckd_lwsw_launch_fast (the fast mode's bf16
// table, common.cuh "Table mode") each return cudaGetLastError() after the
// launch; ecckd_lwsw_occupancy(const LwswArgs*, fast) returns the blocks
// per SM of a launch configuration (tile.threads, tile.shared_bytes; the
// bands' shapes and the grid's n_t pick the instantiation), or -1;
// ecckd_lwsw_args_size() lets the wrapper check its struct mirror
// (ops/cuda/binding.py), and ecckd_cuda_error_string() names an error code.

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

namespace {

template <typename T, class SL, class SS, int NT, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    lwsw_kernel(const __grid_constant__ LwswArgs args) {
  staged_body<T, SL, SS, NT, SHARED>(args.atm, args.grid, &args.lw_band,
                                     &args.sw_band, &args.lw, &args.sw,
                                     args.tile);
}

// The shipped models' shapes as constants; any other, and device
// staging, at run time.
template <typename T>
KernelFn<LwswArgs> pick(const LwswArgs* a) {
  if (!staged_in_shared(a->tile))
    return lwsw_kernel<T, Shape<0>, Shape<0>, 0, false>;
  if (a->grid.n_t == SHIPPED_NT && has_shape<WideShape>(a->sw_band)) {
    if (has_shape<FsckShape>(a->lw_band))
      return lwsw_kernel<T, FsckShape, WideShape, SHIPPED_NT, true>;
    if (has_shape<RrtmgpShape>(a->lw_band))
      return lwsw_kernel<T, RrtmgpShape, WideShape, SHIPPED_NT, true>;
  }
  return lwsw_kernel<T, Shape<0>, Shape<0>, 0, true>;
}

template <typename T>
int launch(const LwswArgs* args, void* stream) {
  return launch_staged(pick<T>(args), args, stream);
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

RING_ENTRY_POINTS(lwsw)
