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
// gather.  Here every table entry is gathered directly.  The column bodies
// are common.cuh's lw_column / sw_column, which lw.cu and sw.cu run too.
//
// Layout.  One warp per (column, band): even warps run the LW solve of a
// column, odd warps its SW solve; lane = g-point (common.cuh).
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
// Host interface (ctypes): ecckd_lwsw_launch(const LwswArgs*, stream)
// (exact f32 table) and ecckd_lwsw_launch_fast (the fast mode's bf16
// table, common.cuh "Table mode")
// each return cudaGetLastError() after the launch; ecckd_lwsw_args_size()
// lets the wrapper check its struct mirror (ops/cuda/lwsw.py), and
// ecckd_cuda_error_string() names an error code.

#include "common.cuh"

struct LwswArgs {
  Atmos atm;
  Grid grid;  // the LW model's, equal to the SW model's (mergeable pair)
  Band lw_band;
  Band sw_band;
  LwSolve lw;
  SwSolve sw;
};

namespace {

template <typename T>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    lwsw_kernel(const __grid_constant__ LwswArgs args) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = warp >> 1;
  if (c >= args.atm.ncol) return;  // ragged edge: whole warps retire
  if ((warp & 1) == 0)
    lw_column<T>(args.atm, args.grid, args.lw_band, args.lw, c, lane);
  else
    sw_column<T>(args.atm, args.grid, args.sw_band, args.sw, c, lane);
}

template <typename T>
int launch(const LwswArgs* args, void* stream) {
  if (args->atm.ncol <= 0) return 0;
  lwsw_kernel<T><<<blocks_for(2LL * args->atm.ncol), WARPS_PER_BLOCK * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ecckd_lwsw_args_size() { return (int)sizeof(LwswArgs); }

extern "C" int ecckd_lwsw_launch(const LwswArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int ecckd_lwsw_launch_fast(const LwswArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}
