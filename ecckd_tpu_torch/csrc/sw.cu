// Shortwave flux kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ecckd_tpu/ops/pallas/sw.py:39 _sw_kernel
// (wrapper sw_fluxes_fused): for every column, one SW ckd model's gas
// optical depth plus Rayleigh, the TOA source mu0 * tsi_scale * solar, the
// g = 0 two-stream coefficients, the direct beam, and the adding passes up
// and down, reduced over g-points to (ncol, nlay+1) up and down fluxes, on
// the model's own (p, T) grid (a SW model need not share the LW model's).
// Night columns run with mu0 = 1; the wrapper zeroes them after the kernel
// (ops/cuda/sw.py), as sw_fluxes_fused does (sw.py:325).
//
// What bounds it on this card.  Per (layer, g-point) ~220 float
// operations of optics (6 gases' gathers, the two-stream with a sqrtf, two
// accurate expm1f and a divide) and ~43 of sweeps: operations bound it,
// 0.42 ms at 65,536 x 60 at the f32 peak (chip_smoke.py phase 8).  A warp
// per column walking its layers in order (the first design) spent ~1,000
// warp instructions per (column, layer) on it (tools/sass_count.py), with
// 17 device-memory accesses per (layer, g-point) for the adding passes'
// rows: instruction issue set its pace.
//
// Design: staged.cuh's body with the SW band alone.  Optics warps compute
// the layer parameters once per layer (lanes over layers), then each
// layer's two-stream coefficients for all g-points, gathering every table
// corner at an immediate offset from one base (the shipped model's 27
// g-points, gas counts and 6 temperatures are template constants); the
// parameters in the layer's r_dif row.  The serial sweep (~117
// instructions per layer on one warp) would starve behind the optics, so
// S = 3 sets of one SW sweep warp each run the direct beam and both
// adding passes of earlier columns from shared memory, rewriting their
// rows in place, and write each level once (~505 instructions per
// (column, layer) in all).  Columns too deep for shared memory
// (nlay >~ 420) are staged in a device slice per block.
//
// Host interface (ctypes): ecckd_sw_launch(const SwArgs*, stream) (exact
// f32 table) and ecckd_sw_launch_fast (the fast mode's bf16 table,
// common.cuh "Table mode") each return cudaGetLastError();
// ecckd_sw_occupancy(const SwArgs*, fast) the blocks per SM of the launch
// configuration, or -1; ecckd_sw_args_size() checks the mirror in
// ops/cuda/binding.py.

#include "staged.cuh"

struct SwArgs {
  Atmos atm;
  Grid grid;
  Band band;
  SwSolve sw;
  Tile tile;
};

namespace {

template <typename T, class S, int NT, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    sw_kernel(const __grid_constant__ SwArgs args) {
  staged_body<T, NoBand, S, NT, SHARED>(args.atm, args.grid, nullptr,
                                        &args.band, nullptr, &args.sw,
                                        args.tile);
}

// The shipped model's shape as constants; any other, and device staging,
// at run time.
template <typename T>
KernelFn<SwArgs> pick(const SwArgs* a) {
  if (!staged_in_shared(a->tile)) return sw_kernel<T, Shape<0>, 0, false>;
  if (a->grid.n_t == SHIPPED_NT && has_shape<WideShape>(a->band))
    return sw_kernel<T, WideShape, SHIPPED_NT, true>;
  return sw_kernel<T, Shape<0>, 0, true>;
}

template <typename T>
int launch(const SwArgs* args, void* stream) {
  return launch_staged(pick<T>(args), args, stream);
}

}  // namespace

extern "C" int ecckd_sw_args_size() { return (int)sizeof(SwArgs); }

extern "C" int ecckd_sw_launch(const SwArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int ecckd_sw_launch_fast(const SwArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}

extern "C" int ecckd_sw_occupancy(const SwArgs* args, int fast) {
  return fast ? occupancy_staged(pick<__nv_bfloat16>(args), args)
              : occupancy_staged(pick<float>(args), args);
}

RING_ENTRY_POINTS(sw)
