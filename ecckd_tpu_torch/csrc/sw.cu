// Shortwave flux kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ecckd_tpu/ops/pallas/sw.py::_sw_kernel (wrapper
// sw_fluxes_fused): for every column, one SW ckd model's gas optical depth
// plus Rayleigh, the TOA source mu0 * tsi_scale * solar, the g = 0
// two-stream coefficients, the direct beam, and the adding passes up and
// down, reduced over g-points to (ncol, nlay+1) up and down fluxes.  Night
// columns run with mu0 = 1; the wrapper zeroes them after the kernel
// (ops/cuda/sw.py), as sw_fluxes_fused does (sw.py:325).
//
// The column body is common.cuh's sw_column, the same device code the
// merged kernel runs for its SW band, here on the model's own (p, T)
// grid: a SW model need not share the LW model's grid.
//
// Layout.  One warp per column; lane = g-point in chunks of 32.  The layer
// pass is fused with the direct-beam sweep; the adding passes read
// 6*nlay+2 scratch rows laid out (row, column, g).
//
// What bounds it on this card: as lwsw.cu's SW half, the L2 gathers per
// layer and g-point and the DRAM round trip of six scratch floats per
// layer and g-point; the sequential layer recurrences leave little ILP
// per warp, so one warp per column keeps many warps in flight.
//
// Host interface (ctypes): ecckd_sw_launch(const SwArgs*, stream)
// (exact f32 table) and ecckd_sw_launch_fast (the fast mode's bf16
// table, common.cuh "Table mode") each
// return cudaGetLastError(); ecckd_sw_args_size() checks the mirror in
// ops/cuda/sw.py.

#include "common.cuh"

struct SwArgs {
  Atmos atm;
  Grid grid;
  Band band;
  SwSolve sw;
};

namespace {

template <typename T>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    sw_kernel(const __grid_constant__ SwArgs args) {
  const int c = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= args.atm.ncol) return;  // ragged edge: whole warps retire
  sw_column<T>(args.atm, args.grid, args.band, args.sw, c, lane);
}

template <typename T>
int launch(const SwArgs* args, void* stream) {
  if (args->atm.ncol <= 0) return 0;
  sw_kernel<T><<<blocks_for(args->atm.ncol), WARPS_PER_BLOCK * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ecckd_sw_args_size() { return (int)sizeof(SwArgs); }

extern "C" int ecckd_sw_launch(const SwArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int ecckd_sw_launch_fast(const SwArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}
