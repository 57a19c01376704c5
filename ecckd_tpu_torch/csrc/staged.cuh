// The staged, warp-specialized body of the port's three flux kernels:
// lwsw.cu (LW + SW, K1/K2), lw.cu (LW only, K3) and sw.cu (SW only, K4)
// instantiate staged_body for the bands they solve.
//
// Persistent blocks, each with a ring of C column stagings (common.cuh
// "Per-column staging") in shared memory, or for columns too deep for it
// in a device memory slice per block (a run-time instantiation of its
// own).  Two warp roles:
//   optics warps take a column's layers, a contiguous range each (which
//   range turns from column to column, so the larger ranges do not always
//   fall on the same warps): first the layer parameters of their layers
//   with lanes over the layers (what does not depend on g is computed
//   once, lanes parallel), then each layer's LW sources (tau and Planck at
//   2-4 angles) and SW two-stream coefficients for all g-points;
//   sweep warps, in S sets of one per LW Gauss angle and one for SW, run
//   the serial recurrences of earlier columns from the staging only, g-sum
//   four levels at a time with a transposed warp reduction, and write
//   each output level once.  Set k sweeps the columns of the slots
//   s = k (mod S): a sweep is one warp's serial chain, and the sets let
//   S of them run at once under the optics of the next columns.
// Named barriers hand each slot from the optics warps to its set of sweep
// warps (FULL) and back (FREE).  Every warp's body is in one kernel;
// __launch_bounds__ holds 1024 threads per SM to 64 registers.
//
// Built with -DECCKD_CHECK_RING (ops/cuda/ring_check.py), the body also
// checks that hand-over (csrc/ring_check.cuh: slot ledgers, NaN poison,
// jitter, guard words); the RING(...) statements are that build's alone,
// and without the define the body compiles as if they were not there.

#pragma once

#include "common.cuh"

#ifdef ECCKD_CHECK_RING
#include "ring_check.cuh"
#define RING(...) __VA_ARGS__
#else
#define RING(...)
#define RING_ENTRY_POINTS(NAME)
#endif

// The staging plan of one launch (ops/cuda/staged.py stage_plan).
struct Tile {
  float* stage;      // device staging, (blocks, slots, col_floats); null
                     // when staged in shared memory
  int slots;         // C: columns staged per block (a ring)
  int sets;          // S: sets of sweep warps (S divides C)
  int blocks;        // persistent blocks of the launch
  int threads;       // threads per block: the optics warps, then S sets
                     // of sweep warps (one per LW angle, then one SW)
  int shared_bytes;  // dynamic shared memory per block; 0: device staging
  int col_floats;    // staging floats per column
  int lw_floats;     // LW rows' floats (the SW rows follow)
  int sw_floats;     // SW rows' floats (the accumulators follow)
  int prm_base;      // the layer parameters' offset in a column's staging:
  int prm_stride;    //   layer j's start at prm_base + j * prm_stride;
  int prm_sw;        //   the SW band's gas weights at + prm_sw (common.cuh)
};

namespace {

// The shipped models' shapes under the RFMIP gases, which the kernels
// instantiate as constants: lw_fsck and lw_rrtmgp (32 or 36 g-points, 7
// dense gases and h2o's LUT) and sw_wide (27 g-points, 5 and 1), on grids
// of 6 temperatures.
using FsckShape = Shape<32, 7, 1>;
using RrtmgpShape = Shape<36, 7, 1>;
using WideShape = Shape<27, 5, 1>;
constexpr int SHIPPED_NT = 6;

// Whether band B has shape S (g-points and gas counts).
template <class S>
bool has_shape(const Band& B) {
  return B.ngpt == S::NG && B.ndense == S::ND && B.nslice == S::ND + S::NL;
}

// Whether a launch stages its columns in shared memory (else in device
// memory), and so takes a SHARED instantiation.
inline bool staged_in_shared(const Tile& P) { return P.shared_bytes > 0; }

// 1024 threads per SM (blocks of 1024, 512 or 256) at 64 registers each.
constexpr int MAX_THREADS = 1024;
// Named barriers (0 is __syncthreads): slot s is FULL once the optics
// warps have staged its column, FREE once its set of sweep warps is done
// with it; LW_DONE + k joins set k's LW sweep warps before they sum their
// angles.
constexpr int MAX_SLOTS = 4;
constexpr int BAR_FULL = 1, BAR_FREE = BAR_FULL + MAX_SLOTS,
              BAR_LW_DONE = BAR_FREE + MAX_SLOTS;
RING(static_assert(MAX_SLOTS <= RING_MAX_SLOTS, "ring ledgers too small");)
#ifdef ECCKD_PLANT_SKIP_FREE
constexpr int BAR_PLANT = BAR_LW_DONE + MAX_SLOTS;  // the planted fault's
#endif

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One launch's solve.  SL / SS: the LW / SW band's Shape (common.cuh),
// NoBand for a band the kernel does not solve (BL / BS, W / S are then
// null); NT: the grid's temperature points, or 0; SHARED: staged in
// shared memory (its 32-bit addressing), else in the device slice.  A
// persistent block walks the columns blockIdx.x, + gridDim.x, ...; the
// i-th goes to slot i % C and is swept
// by set i % S.  The block's last S (n_ang + 1) warps sweep (per set one
// LW warp per Gauss angle, then the SW warp); the others, the optics
// warps, stage the next columns meanwhile.
template <typename T, class SL, class SS, int NT, bool SHARED>
__device__ __forceinline__ void staged_body(const Atmos& A, const Grid& G,
                                            const Band* BL, const Band* BS,
                                            const LwSolve* W,
                                            const SwSolve* S,
                                            const Tile& P) {
  constexpr bool LW = SL::NG >= 0, SW = SS::NG >= 0;
  extern __shared__ __align__(16) float smem[];
  const int nlay = A.nlay, nlev = nlay + 1, ncol = A.ncol;
  const int n_lw = LW ? W->n_ang : 0, n_set = n_lw + (SW ? 1 : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_opt = blockDim.x / 32 - P.sets * n_set;
  // A slot's barriers join the optics warps and the slot's set.
  const int bar_threads = 32 * (n_opt + n_set);
  float* slots = SHARED
                     ? smem
                     : P.stage + (size_t)blockIdx.x * P.slots * P.col_floats;
  RING(__shared__ unsigned ring_ledger[2 * RING_MAX_SLOTS];
       const int sw_gases = SW ? 3 * BS->nslice - 2 * BS->ndense : 0;
       const RingCheck ring(ring_ledger, slots, P.slots, P.col_floats, n_opt,
                            n_set, P.prm_base, P.prm_stride,
                            P.prm_sw + sw_gases, nlay);)
  if (warp < n_opt) {
    // 0. The layer parameters of this warp's layers, lanes over them;
    // 1. their optics, one layer at a time.
    for (int c = blockIdx.x, i = 0; c < ncol; c += gridDim.x, ++i) {
      const int s = i % P.slots;
      float* st = slots + (size_t)s * P.col_floats;
      const float* prm = st + P.prm_base;
      const int r = (warp + i) % n_opt;
      const int ja = r * nlay / n_opt, jb = (r + 1) * nlay / n_opt;
#ifdef ECCKD_PLANT_SKIP_FREE
      // The planted fault (tools/cuda_sanitize.py --checked): in round 1
      // of slot 0 the optics warps wait for each other (BAR_PLANT) but
      // not for the slot's sweeps, and join FREE only after staging, so
      // they may overwrite the staging that the sweeps still read.  Every
      // barrier keeps its count and order, and the optics warps stay in
      // step: without that, at C = 1 one would stage the slot's next
      // column over layers another still stages, and read that one's
      // rows as its layer parameters (integers).
      const bool late_free = i == P.slots && s == 0;
      if (late_free) bar_sync(BAR_PLANT, 32 * n_opt);
      else if (i >= P.slots) bar_sync(BAR_FREE + s, bar_threads);
#else
      if (i >= P.slots) bar_sync(BAR_FREE + s, bar_threads);
#endif
      RING(ring.freed(i, s, c);)
      for (int j = ja + lane; j < jb; j += 32)
        layer_params<T>(A, G, BL, BS, W, c, j,
                        st + P.prm_base + j * P.prm_stride);
      __syncwarp();
      if constexpr (LW)
        lw_optics<T, SL, NT>(A, G, *BL, *W, c, ja, jb, lane, prm,
                              P.prm_stride, st);
      if constexpr (SW)
        sw_optics<T, SS, NT>(A, G, *BS, *S, c, ja, jb, lane, prm,
                              P.prm_stride, P.prm_sw, st + P.lw_floats);
#ifdef ECCKD_PLANT_SKIP_FREE
      if (late_free) bar_sync(BAR_FREE + s, bar_threads);
#endif
      RING(ring.staging_done(i, s);)
      bar_arrive(BAR_FULL + s, bar_threads);
    }
  } else {
    // 2. Sweeps from the staging, set k: LW at angle a (the set's warp a)
    // into its own accumulators, or SW; then the level fluxes, written
    // once.
    const int set = (warp - n_opt) / n_set, a = (warp - n_opt) % n_set;
    for (int c = blockIdx.x + set * gridDim.x, i = set; c < ncol;
         c += P.sets * gridDim.x, i += P.sets) {
      const int s = i % P.slots;
      float* st = slots + (size_t)s * P.col_floats;
      float* acc = st + P.lw_floats + P.sw_floats + 2 * nlev * a;
      bar_sync(BAR_FULL + s, bar_threads);
      RING(ring.filled(i, s, c);)
      for (int q = lane; q < 2 * nlev; q += 32) acc[q] = 0.0f;
      __syncwarp();
      if (a == n_lw) {
        if constexpr (SW) {
          sw_sweeps_staged<SS::NG>(*S, *BS, nlay, c, lane, st + P.lw_floats,
                                acc, acc + nlev);
          __syncwarp();
          for (int q = lane; q < nlev; q += 32) {
            S->up[(size_t)c * nlev + q] = acc[q];
            S->dn[(size_t)c * nlev + q] = acc[nlev + q];
          }
          RING(ring.poison(st, P.lw_floats, P.lw_floats + P.sw_floats);)
        }
      } else if constexpr (LW) {
        lw_sweeps_staged<SL::NG>(*W, *BL, nlay, c, lane, a, st, acc,
                              acc + nlev);
        // The angles' sums, in angle order, split over the LW warps.
        bar_sync(BAR_LW_DONE + set, 32 * n_lw);
        const float* acc0 = acc - 2 * nlev * a;
        for (int q = lane + 32 * a; q < 2 * nlev; q += 32 * n_lw) {
          float v = 0.0f;
          for (int b = 0; b < n_lw; ++b) v += acc0[2 * nlev * b + q];
          (q < nlev ? W->up : W->dn)[(size_t)c * nlev + q % nlev] = v;
        }
        // Every LW warp of the set is done with the LW rows: one poisons
        // them.
        RING(if (n_lw > 1) bar_sync(BAR_LW_DONE + set, 32 * n_lw);
             if (a == 0) ring.poison(st, 0, P.lw_floats);)
      }
      __syncwarp();
      RING(ring.sweep_done(i, s);)
      if (c + P.slots * gridDim.x < ncol)
        bar_arrive(BAR_FREE + s, bar_threads);
    }
  }
  RING(ring.finish();)
}

// The host side of a launch, for the args struct Args of one kernel (its
// Tile in .tile) and the kernel instantiation `kernel` that fits it.
template <typename Args>
using KernelFn = void (*)(Args);

template <typename Args>
cudaError_t configure(KernelFn<Args> kernel, const Args* args) {
  const Tile& P = args->tile;
  if (P.slots < 1 || P.slots > MAX_SLOTS || P.sets < 1 ||
      P.slots % P.sets != 0)
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              args->tile.shared_bytes);
}

template <typename Args>
int launch_staged(KernelFn<Args> kernel, const Args* args, void* stream) {
  if (args->atm.ncol <= 0) return 0;
  // Per launch: the attribute is the current device's.
  const cudaError_t err = configure(kernel, args);
  if (err != cudaSuccess) return (int)err;
  kernel<<<args->tile.blocks, args->tile.threads, args->tile.shared_bytes,
           static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

// Blocks per SM of the launch configuration (tile.threads,
// tile.shared_bytes), or -1 where the card refuses it.
template <typename Args>
int occupancy_staged(KernelFn<Args> kernel, const Args* args) {
  if (configure(kernel, args) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, args->tile.threads, args->tile.shared_bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace
