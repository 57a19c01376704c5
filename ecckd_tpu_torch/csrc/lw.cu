// Longwave flux kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ecckd_tpu/ops/pallas/lw.py::_lw_kernel (wrapper
// lw_fluxes_fused): for every column, one LW ckd model's gas optical depth
// (dense bi-linear tables and the h2o look-up-table tri-linear, each gas
// clamped at zero per g-point), the Planck source at layers, levels and
// the surface, linear-in-tau layer sources and the down/up no-scattering
// sweeps at 1-4 Gauss angles, reduced over g-points to (ncol, nlay+1)
// up and down fluxes.
//
// The TPU kernel's one-hot MXU contractions, bf16x3 splits, lane-blocked
// layers and P/V windows are not carried over: the column body is
// common.cuh's lw_column, the same device code the merged kernel runs for
// its LW band, here on the model's own (p, T) grid.
//
// Layout.  One warp per column; lane = g-point in chunks of 32 (so the
// 36-g-point rrtmgp model runs a second, partly filled chunk).  At 1 angle
// the layer pass is fused with the down sweep and stages transmittance
// and up source (2*nlay scratch rows); at 2-4 angles it stages tau, layer
// and level Planck (3*nlay+1 rows) and each angle sweeps down and up.
//
// What bounds it on this card: as lwsw.cu's LW half, the L2 gathers of the
// table corners per layer and g-point and the DRAM round trip of the
// scratch rows; the dependent per-layer chain leaves little ILP per warp,
// so enough warps in flight (one per column) is what hides latency.
//
// Host interface (ctypes): ecckd_lw_launch(const LwArgs*, stream)
// (exact f32 table) and ecckd_lw_launch_fast (the fast mode's bf16
// table, common.cuh "Table mode") each
// return cudaGetLastError(); ecckd_lw_args_size() checks the mirror in
// ops/cuda/lw.py.

#include "common.cuh"

struct LwArgs {
  Atmos atm;
  Grid grid;
  Band band;
  LwSolve lw;
};

namespace {

template <typename T>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    lw_kernel(const __grid_constant__ LwArgs args) {
  const int c = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= args.atm.ncol) return;  // ragged edge: whole warps retire
  lw_column<T>(args.atm, args.grid, args.band, args.lw, c, lane);
}

template <typename T>
int launch(const LwArgs* args, void* stream) {
  if (args->atm.ncol <= 0) return 0;
  lw_kernel<T><<<blocks_for(args->atm.ncol), WARPS_PER_BLOCK * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ecckd_lw_args_size() { return (int)sizeof(LwArgs); }

extern "C" int ecckd_lw_launch(const LwArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int ecckd_lw_launch_fast(const LwArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}
