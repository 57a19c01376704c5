// Longwave flux kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ecckd_tpu/ops/pallas/lw.py:54 _lw_kernel
// (wrapper lw_fluxes_fused): for every column, one LW ckd model's gas
// optical depth (dense bi-linear tables and the h2o look-up-table
// tri-linear, each gas clamped at zero per g-point), the Planck source at
// layers, levels and the surface, linear-in-tau layer sources and the
// down/up no-scattering sweeps at 1-4 Gauss angles, reduced over g-points
// to (ncol, nlay+1) up and down fluxes, on the model's own (p, T) grid.
//
// The TPU kernel's one-hot MXU contractions, bf16x3 splits, lane-blocked
// layers and P/V windows are not carried over: every table entry is
// gathered directly.
//
// What bounds it on this card.  Per (layer, g-point) ~175 float
// operations at one angle (8 gases' bilinear gathers, two Planck values,
// the layer sources with an accurate expm1f and a divide) on ~1 KB per
// column of inputs: operations bound it, 0.35 ms at 65,536 x 60 at the f32
// peak (chip_smoke.py phase 8).  A warp per column walking its layers in
// order (the first design) spent ~980 warp instructions per (column,
// layer) (tools/sass_count.py), most of them 64-bit addressing and
// g-independent work repeated per g-point, with the backward sweep's rows
// in device memory: instruction issue set its pace.
//
// Design: staged.cuh's body with the LW band alone.  Optics warps compute
// the layer parameters once per layer (lanes over layers: interpolation
// point, gas weights, the LUT index, the layer's and lower level's Planck
// points), then each layer's sources for all g-points, gathering every
// table corner and Planck row at an immediate offset from one base (the
// shipped models' 32 and 36 g-points, gas counts and 6 temperatures are
// template constants); each level's Planck value once; the parameters in
// the layer's first LW row (32 g-points) or a place of their own (36).
// S sets of sweep warps, one per Gauss angle each, sweep earlier columns
// from shared memory, S at a time, and write each level once (~370
// instructions per (column, layer) in all).  Columns too deep for shared
// memory (nlay >~ 590 at one angle) are staged in a device slice per
// block.
//
// Host interface (ctypes): ecckd_lw_launch(const LwArgs*, stream) (exact
// f32 table) and ecckd_lw_launch_fast (the fast mode's bf16 table,
// common.cuh "Table mode") each return cudaGetLastError();
// ecckd_lw_occupancy(const LwArgs*, fast) the blocks per SM of the launch
// configuration, or -1; ecckd_lw_args_size() checks the mirror in
// ops/cuda/binding.py.

#include "staged.cuh"

struct LwArgs {
  Atmos atm;
  Grid grid;
  Band band;
  LwSolve lw;
  Tile tile;
};

namespace {

template <typename T, class S, int NT, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    lw_kernel(const __grid_constant__ LwArgs args) {
  staged_body<T, S, NoBand, NT, SHARED>(args.atm, args.grid, &args.band,
                                        nullptr, &args.lw, nullptr,
                                        args.tile);
}

// The shipped models' shapes as constants; any other, and device
// staging, at run time.
template <typename T>
KernelFn<LwArgs> pick(const LwArgs* a) {
  if (!staged_in_shared(a->tile)) return lw_kernel<T, Shape<0>, 0, false>;
  if (a->grid.n_t == SHIPPED_NT) {
    if (has_shape<FsckShape>(a->band))
      return lw_kernel<T, FsckShape, SHIPPED_NT, true>;
    if (has_shape<RrtmgpShape>(a->band))
      return lw_kernel<T, RrtmgpShape, SHIPPED_NT, true>;
  }
  return lw_kernel<T, Shape<0>, 0, true>;
}

template <typename T>
int launch(const LwArgs* args, void* stream) {
  return launch_staged(pick<T>(args), args, stream);
}

}  // namespace

extern "C" int ecckd_lw_args_size() { return (int)sizeof(LwArgs); }

extern "C" int ecckd_lw_launch(const LwArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int ecckd_lw_launch_fast(const LwArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}

extern "C" int ecckd_lw_occupancy(const LwArgs* args, int fast) {
  return fast ? occupancy_staged(pick<__nv_bfloat16>(args), args)
              : occupancy_staged(pick<float>(args), args);
}

RING_ENTRY_POINTS(lw)
