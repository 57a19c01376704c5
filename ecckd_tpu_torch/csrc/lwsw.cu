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
// gather.  Here every table entry is gathered directly.  The arithmetic
// per (layer, g-point) is common.cuh's, which lw.cu and sw.cu run too.
//
// What bounds it on this card.  Arithmetic on little data: per column it
// reads ~2.5 KB and writes 4 (nlay+1) floats, and the 0.7-2.7 MB tables
// stay in the 50 MB L2, so bytes bound it at ~0.05 ms at 65,536 x 60;
// per (layer, g-point) a band does ~200 float operations (bilinear
// gathers over 6-8 gases, Planck, accurate expm1f/sqrtf/divides), ~0.7 ms
// at the card's f32 peak (chip_smoke.py phase 8 counts both).  What keeps
// a kernel far above that is instruction issue and dependent latency: a
// warp that walks one column's layers in order repeats, for every gas
// and g-chunk, work that does not depend on the g-point, waits on each
// layer's gathers in turn, and must send the backward sweeps'
// coefficients (~54 KB per column) through device memory.
//
// Design.  Persistent blocks, each with a ring of C column stagings in
// shared memory (common.cuh "The tiled merged solve"); two warp roles:
//   optics warps take a column's layers, a share each (turning from
//   column to column so the remainder does not always fall on the same
//   warps): first the layer parameters of their layers with lanes over
//   the layers (the interpolation point, the gas weights, the LUT index:
//   what does not depend on g is computed once, lanes parallel), then
//   each layer's LW sources (tau and Planck at 2-4 angles) and SW
//   two-stream coefficients for all g-points, gathering each table corner
//   with 32-bit offsets from one base per layer;
//   sweep warps, one per LW Gauss angle and one for SW, run the serial
//   recurrences of the previous column from shared memory only, g-sum
//   four levels at a time with a transposed warp reduction, and write
//   each output level once.
// Named barriers hand each slot from the optics warps to the sweep warps
// (FULL) and back (FREE), so the sweeps of one column run under the
// optics of the next.  C = 2 where two fit in shared memory (nlay 60:
// two blocks of 512 threads per SM); a column too deep for shared memory
// (nlay >~ 250 at these ngpt) is staged in a device memory slice per
// block instead, through the same generic pointer.  Every warp's body is
// in one kernel; __launch_bounds__ holds 1024 threads per SM to 64
// registers.

// Host interface (ctypes): ecckd_lwsw_launch(const LwswArgs*, stream)
// (exact f32 table) and ecckd_lwsw_launch_fast (the fast mode's bf16
// table, common.cuh "Table mode") each return cudaGetLastError() after the
// launch; ecckd_lwsw_occupancy(const LwswArgs*, fast) returns the blocks
// per SM of a launch configuration (tile.threads, tile.shared_bytes);
// ecckd_lwsw_args_size() lets the wrapper check its struct mirror
// (ops/cuda/lwsw.py), and ecckd_cuda_error_string() names an error code.

#include "common.cuh"

// The staging plan of one launch (ops/cuda/lwsw.py stage_plan).
struct LwswTile {
  float* stage;      // device staging, (blocks, slots, col_floats); null
                     // when staged in shared memory
  int slots;         // C: columns staged per block (a ring)
  int blocks;        // persistent blocks of the launch
  int threads;       // threads per block: the optics warps, then n_ang + 1
                     // sweep warps
  int shared_bytes;  // dynamic shared memory per block; 0: device staging
  int col_floats;    // staging floats per column
  int lw_floats;     // LW rows' floats (the SW rows follow)
  int sw_floats;     // SW rows' floats (the accumulators follow)
  int prm_base;      // the layer parameters' offset in a column's staging:
  int prm_stride;    //   layer j's start at prm_base + j * prm_stride;
  int prm_sw;        //   the SW band's at + prm_sw (common.cuh)
};

struct LwswArgs {
  Atmos atm;
  Grid grid;  // the LW model's, equal to the SW model's (mergeable pair)
  Band lw_band;
  Band sw_band;
  LwSolve lw;  // scratch unused: the staging is `tile`'s
  SwSolve sw;
  LwswTile tile;
};

namespace {

// 1024 threads per SM (two blocks of 512, or one) at 64 registers each.
constexpr int MAX_THREADS = 1024;

// Named barriers (0 is __syncthreads): slot s is FULL once the optics
// warps have staged its column, FREE once the sweep warps are done with
// it; LW_DONE joins the LW sweep warps before they sum their angles.
constexpr int BAR_FULL = 1, BAR_FREE = 3, BAR_LW_DONE = 5;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A persistent block walks the columns blockIdx.x, + gridDim.x, ...; the
// i-th goes to slot i % slots.  The block's last n_ang + 1 warps sweep
// (one LW warp per Gauss angle, then the SW warp); the others, the optics
// warps, stage the next columns meanwhile.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    lwsw_kernel(const __grid_constant__ LwswArgs args) {
  extern __shared__ __align__(16) float smem[];
  const LwswTile& P = args.tile;
  const int nlay = args.atm.nlay, nlev = nlay + 1, ncol = args.atm.ncol;
  const int n_ang = args.lw.n_ang;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_opt = blockDim.x / 32 - n_ang - 1;
  float* slots = P.shared_bytes > 0
                     ? smem
                     : P.stage + (size_t)blockIdx.x * P.slots * P.col_floats;
  int i = 0;
  if (warp < n_opt) {
    // 0. The layer parameters of this warp's layers, lanes over them;
    // 1. their optics, one layer at a time.  Which layers a warp takes
    // turns from column to column, so the remainder of nlay / n_opt
    // falls on other warps each time.
    for (int c = blockIdx.x; c < ncol; c += gridDim.x, ++i) {
      const int s = i % P.slots;
      float* st = slots + (size_t)s * P.col_floats;
      float* prm = st + P.prm_base;
      const int j0 = (warp + n_opt - (int)(((long long)i * nlay) % n_opt)) %
                     n_opt;
      if (i >= P.slots) bar_sync(BAR_FREE + s, blockDim.x);
      for (int j = j0 + lane * n_opt; j < nlay; j += 32 * n_opt)
        lwsw_layer_params<T>(args.atm, args.grid, args.lw_band, args.sw_band,
                             c, j, prm + j * P.prm_stride);
      __syncwarp();
      for (int j = j0; j < nlay; j += n_opt)
        lwsw_layer_optics<T>(args.atm, args.grid, args.lw_band, args.sw_band,
                             args.lw, args.sw, c, j, lane,
                             prm + j * P.prm_stride, P.prm_sw, st,
                             st + P.lw_floats);
      bar_arrive(BAR_FULL + s, blockDim.x);
    }
  } else {
    // 2. Sweeps from the staging: LW at angle a (warp n_opt + a) into its
    // own accumulators, or SW; then the level fluxes, written once.
    const int a = warp - n_opt;
    const bool sw = a == n_ang;
    for (int c = blockIdx.x; c < ncol; c += gridDim.x, ++i) {
      const int s = i % P.slots;
      float* st = slots + (size_t)s * P.col_floats;
      float* acc = st + P.lw_floats + P.sw_floats + 2 * nlev * a;
      bar_sync(BAR_FULL + s, blockDim.x);
      for (int k = lane; k < 2 * nlev; k += 32) acc[k] = 0.0f;
      __syncwarp();
      if (sw) {
        sw_sweeps_staged(args.sw, args.sw_band, nlay, c, lane,
                         st + P.lw_floats, acc, acc + nlev);
        __syncwarp();
        for (int k = lane; k < nlev; k += 32) {
          args.sw.up[(size_t)c * nlev + k] = acc[k];
          args.sw.dn[(size_t)c * nlev + k] = acc[nlev + k];
        }
      } else {
        lw_sweeps_staged(args.lw, args.lw_band, nlay, c, lane, a, st, acc,
                         acc + nlev);
        // The angles' sums, in angle order, split over the LW warps.
        bar_sync(BAR_LW_DONE, 32 * n_ang);
        const float* acc0 = acc - 2 * nlev * a;
        for (int k = lane + 32 * a; k < 2 * nlev; k += 32 * n_ang) {
          float v = 0.0f;
          for (int b = 0; b < n_ang; ++b) v += acc0[2 * nlev * b + k];
          (k < nlev ? args.lw.up : args.lw.dn)[(size_t)c * nlev + k % nlev] =
              v;
        }
      }
      __syncwarp();
      if (c + P.slots * gridDim.x < ncol)
        bar_arrive(BAR_FREE + s, blockDim.x);
    }
  }
}

template <typename T>
cudaError_t configure(const LwswArgs* args) {
  return cudaFuncSetAttribute(lwsw_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              args->tile.shared_bytes);
}

template <typename T>
int launch(const LwswArgs* args, void* stream) {
  if (args->atm.ncol <= 0) return 0;
  // Per launch: the attribute is the current device's.
  const cudaError_t err = configure<T>(args);
  if (err != cudaSuccess) return (int)err;
  lwsw_kernel<T><<<args->tile.blocks, args->tile.threads,
                   args->tile.shared_bytes,
                   static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(const LwswArgs* args) {
  if (configure<T>(args) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lwsw_kernel<T>, args->tile.threads,
          args->tile.shared_bytes) != cudaSuccess)
    return -1;
  return blocks;
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
  return fast ? occupancy<__nv_bfloat16>(args) : occupancy<float>(args);
}
