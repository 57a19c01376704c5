// The role clock: a timed build of the staged kernels (csrc/staged.cuh),
// compiled only with -DECCKD_TIME_ROLES (ops/cuda/role_clock.py builds it;
// the launch paths never load it).
//
// The staged body runs three warp roles: the optics warps, which stage a
// slot and then wait for its sweeps (FREE); the LW sweep warps, which wait
// for a staged slot (FULL) and for their set's other angles (LW_DONE); and
// the SW sweep warp, which waits at FULL.  Built with the define, every
// warp reads the SM's cycle counter around its waits and its phases and
// adds the spans into counters of its own, in registers:
//   optics warps: FREE waits (both placements: after a column's staging,
//     and on the split route after the parameters computed ahead), layer
//     parameters (`params`), LW + SW optics;
//   LW sweep warps: FULL waits, LW_DONE waits, sweeping and summing the
//     angles, writing the stage's parameters;
//   SW sweep warp: FULL waits, sweeping and writing the outputs;
//   every warp: its total, from its first statement to its last.
// At the body's end lane 0 of each warp adds its counters, its count and
// whether its counted spans exceed its total into one device record, by
// role, read and reset through ecckd_<name>_role_clock.  The record sums
// every launch since the last reset.  Where a set gives an angle one LW
// sweep warp per g-chunk (Tile.lw_warps 2), the warps of the second chunk
// add theirs a second time to a row of their own (ROLE_LW_CHUNK1), so the
// two chunks' walks read apart; the LW sweep role counts both.
//
// Two planted faults, for the instrument's own test, each in this build
// alone: -DECCKD_PLANT_SLOW_SW makes the SW sweep warp spin
// PLANT_SPIN_CYCLES (staged.cuh) per column inside its sweep phase, and
// -DECCKD_PLANT_SLOW_OPTICS makes each optics warp spin as long per column
// inside its optics phase.

#pragma once

#include <cuda_runtime.h>

// The roles and the counters of each (ops/cuda/role_clock.py ROLES and
// COUNTERS, in this order).
// ROLE_LW_CHUNK1: the LW sweep warps of g-chunk 1 once more.
enum RoleKind {
  ROLE_OPTICS = 0,
  ROLE_LW_SWEEP = 1,
  ROLE_SW_SWEEP = 2,
  ROLE_LW_CHUNK1 = 3
};
constexpr int ROLES = 4;
enum RoleCounter {
  RC_TOTAL = 0,    // cycles from the warp's first statement to its last
  RC_FREE = 1,     // in bar.sync FREE (optics warps)
  RC_FULL = 2,     // in bar.sync FULL (sweep warps)
  RC_LW_DONE = 3,  // in bar.sync LW_DONE (LW sweep warps)
  RC_PARAMS = 4,   // computing or writing layer parameters
  RC_OPTICS = 5,   // LW + SW optics (optics warps)
  RC_SWEEP = 6,    // sweeping, summing and writing outputs (sweep warps)
  RC_WARPS = 7,    // warps of the role
  RC_OVER = 8      // warps whose counted spans exceed their total
};
constexpr int ROLE_COUNTERS = 9;
// The spans a warp counts: RC_FREE .. RC_SWEEP.
constexpr int ROLE_SPANS = RC_SWEEP - RC_FREE + 1;

__device__ unsigned long long role_record[ROLES * ROLE_COUNTERS];

#ifdef ECCKD_PLANT_SLOW_SW
constexpr bool PLANT_SLOW_SW = true;
#else
constexpr bool PLANT_SLOW_SW = false;
#endif
#ifdef ECCKD_PLANT_SLOW_OPTICS
constexpr bool PLANT_SLOW_OPTICS = true;
#else
constexpr bool PLANT_SLOW_OPTICS = false;
#endif

namespace {

// The SM's 32-bit cycle counter: a span of one warp (far below 2^32
// cycles) is the unsigned difference of two readings.
__device__ __forceinline__ unsigned role_now() {
  unsigned t;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(t));
  return t;
}

// One warp's counters.  start() marks a span's beginning and stop(k) adds
// the cycles since to counter k, so the time between spans counts only in
// the total.
struct RoleClock {
  unsigned t0, mark, span[ROLE_SPANS];

  __device__ __forceinline__ RoleClock() : t0(role_now()), mark(t0) {
    for (int k = 0; k < ROLE_SPANS; ++k) span[k] = 0;
  }
  __device__ __forceinline__ void start() { mark = role_now(); }
  __device__ __forceinline__ void stop(int k) {
    span[k - RC_FREE] += role_now() - mark;
  }

  // The warp's last statement: lane 0 adds its counters to role `role`.
  __device__ __forceinline__ void flush(int role) const {
    const unsigned total = role_now() - t0;
    if (threadIdx.x % 32 != 0) return;
    unsigned long long* r = role_record + role * ROLE_COUNTERS;
    unsigned long long counted = 0;
    for (int k = 0; k < ROLE_SPANS; ++k) {
      counted += span[k];
      if (span[k] != 0) atomicAdd(&r[RC_FREE + k], (unsigned long long)span[k]);
    }
    atomicAdd(&r[RC_TOTAL], (unsigned long long)total);
    atomicAdd(&r[RC_WARPS], 1ull);
    if (counted > total) atomicAdd(&r[RC_OVER], 1ull);
  }
};

}  // namespace

// The timed build's host entry points of kernel NAME:
//   ecckd_NAME_role_words(): the record's words (ROLES * ROLE_COUNTERS);
//   ecckd_NAME_role_clock(out, reset): copies the record (role by role,
//     each role's counters in RoleCounter order) into out and, if reset,
//     clears it.  It returns a cudaError_t code.
#define ROLE_CLOCK_ENTRY_POINTS(NAME)                                       \
  extern "C" int ecckd_##NAME##_role_words() {                              \
    return ROLES * ROLE_COUNTERS;                                           \
  }                                                                         \
  extern "C" int ecckd_##NAME##_role_clock(unsigned long long* out,         \
                                           int reset) {                     \
    cudaError_t e =                                                         \
        cudaMemcpyFromSymbol(out, role_record, sizeof role_record);         \
    if (e == cudaSuccess && reset) {                                        \
      const unsigned long long zero[ROLES * ROLE_COUNTERS] = {};            \
      e = cudaMemcpyToSymbol(role_record, zero, sizeof zero);               \
    }                                                                       \
    return (int)e;                                                          \
  }
