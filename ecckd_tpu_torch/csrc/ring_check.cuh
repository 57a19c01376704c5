// The ring protocol's checker: a diagnostic build of the staged kernels
// (csrc/staged.cuh), compiled only with -DECCKD_CHECK_RING
// (ops/cuda/ring_check.py builds it; the launch paths never load it).
//
// The staged body hands each column slot s from the optics warps to its
// set of sweep warps (FULL + s) and back (FREE + s); with the parameter
// stage the set's LW sweep warps write the layer parameters of the slot's
// next column before they free it, or on the split route the optics warps
// compute them into a place of their own before they wait for FREE.  The
// block's i-th column takes slot i % C in round i / C.  The checker
// asserts, per block:
//   FULL: a sweep warp past its FULL wait for column i finds that every
//     optics warp has staged rounds 0 .. i / C of the slot, and no more:
//     staged[s] == n_opt (i / C + 1);
//   FREE: an optics warp past its FREE wait for column i finds that every
//     sweep warp of the slot's set has finished rounds 0 .. i / C - 1, and
//     no more: swept[s] == n_set (i / C); and, since the optics warps
//     join FREE too, that every optics warp has staged rounds
//     0 .. i / C - 1 (others may have staged round i / C since, this one
//     not): n_opt (i / C) <= staged[s] < n_opt (i / C + 1);
//   PRM: with the stage, an optics warp past its FREE wait for column i
//     finds that the set's n_lw LW warps have written the parameters of
//     rounds 1 .. i / C of the slot, and no more: params[s] ==
//     n_lw (i / C); on the split route, an optics warp about to compute
//     column i's parameters ahead of its FREE wait finds that every
//     optics warp has staged rounds 0 .. i / C - 1 of the slot (the last
//     readers of their place), and none round i / C: staged[s] ==
//     n_opt (i / C);
//   STALE: every float of a slot's staged rows is written by the optics
//     of each column before a sweep reads it.  The last reader of the rows
//     (the set's SW warp its rows, one LW warp the LW rows) sets them to
//     NaN before it frees the slot, so a read of a stale or unwritten
//     float comes out as NaN in the outputs (the tool checks them).  The
//     layer parameters' places in the rows (common.cuh "Layer
//     parameters") it sets to 0 instead: an optics warp reads its table
//     rows and Planck points from them as integers, which 0 keeps in
//     bounds where NaN would send a fault's reads out of them, and a read
//     before they are written still changes the outputs;
//   CANARY: nothing writes past a slot: RING_GUARD guard words (of the
//     staging's word type, float or double, each 32-bit half a canary)
//     after every slot (shared memory or the block's device slice; the
//     host plan's col_floats includes them), and on the split route after
//     every slot's LW rows in the device slice, keep their values from
//     the kernel's start to its end.
// Seeded jitter (__nanosleep, ring_config) at the six hand-over points
// changes the warps' orderings from run to run.  Violations go to one
// device record, read and reset through ecckd_<name>_ring_errors.

#pragma once

#include <cuda_runtime.h>

// Guard words after each slot: ops/cuda/ring_check.py RING_GUARD_FLOATS.
constexpr int RING_GUARD = 32;
// Slots a block's ledgers hold (staged.cuh MAX_SLOTS).
constexpr int RING_MAX_SLOTS = 4;

enum RingCheckKind {
  RING_FULL = 0,
  RING_FREE = 1,
  RING_CANARY = 2,
  RING_PRM = 3
};
constexpr int RING_CHECKS = 4;

// Violations of this launch's checks: the count, the count per check,
// and the first one's block, column, slot and check (-1 while none).
struct RingRecord {
  unsigned count;
  unsigned by_check[RING_CHECKS];
  int block, column, slot, check;
};

__device__ RingRecord ring_record = {0, {0, 0, 0, 0}, -1, -1, -1, -1};
__device__ unsigned ring_seed = 0, ring_jitter_ns = 0;

namespace {

__device__ __noinline__ void ring_violation(int check, int column,
                                            int slot) {
  atomicAdd(&ring_record.by_check[check], 1u);
  if (atomicAdd(&ring_record.count, 1u) == 0) {
    ring_record.block = blockIdx.x;
    ring_record.column = column;
    ring_record.slot = slot;
    ring_record.check = check;
  }
}

__device__ __forceinline__ unsigned ring_hash(unsigned a, unsigned b,
                                              unsigned c, unsigned d) {
  unsigned h = a * 0x9E3779B1u ^ b * 0x85EBCA77u ^ c * 0xC2B2AE3Du ^
               d * 0x27D4EB2Fu;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ unsigned ring_canary(int slot, int q) {
  return ring_hash(0xC0FFEEu, blockIdx.x, slot, q) | 0x7F800001u;  // a NaN
}

// A quiet NaN of the staging's word type R.
__device__ __forceinline__ float ring_nan(float) {
  return __int_as_float(0x7FC00000);
}
__device__ __forceinline__ double ring_nan(double) {
  return __longlong_as_double(0x7FF8000000000000LL);
}

// One block's ledgers and guards, over staging of words of type R (float
// or double).  Built by every thread of the block at the body's start,
// before any warp touches a slot.
template <typename R>
struct RingCheck {
  // 32-bit canary words in one guard of RING_GUARD words of R.
  static constexpr int GUARD_WORDS = RING_GUARD * (int)(sizeof(R) / 4);

  unsigned* staged;  // [RING_MAX_SLOTS] shared: optics warps' rounds
  unsigned* swept;   // [RING_MAX_SLOTS] shared: sweep warps' rounds
  unsigned* params;  // [RING_MAX_SLOTS] shared: the stage's rounds (LW
                     // warps' writes of the slot's next parameters)
  R* slots;          // the block's slots, col_floats apart
  R* lw_slots;       // the split route's LW rows, lw_stride apart, or null
  int n_slots, col_floats, lw_stride, n_opt, n_set, n_prm, warp, lane;
  // The layer parameters: layer j's prm_len floats at prm_base + j *
  // prm_stride of a slot, for nlay layers.
  int prm_base, prm_stride, prm_len, nlay;

  __device__ RingCheck(unsigned* ledger, R* slots_, int n_slots_,
                       int col_floats_, R* lw_slots_, int lw_stride_,
                       int n_opt_, int n_set_, int n_prm_, int prm_base_,
                       int prm_stride_, int prm_len_, int nlay_)
      : staged(ledger), swept(ledger + RING_MAX_SLOTS),
        params(ledger + 2 * RING_MAX_SLOTS), slots(slots_),
        lw_slots(lw_slots_), n_slots(n_slots_), col_floats(col_floats_),
        lw_stride(lw_stride_), n_opt(n_opt_), n_set(n_set_), n_prm(n_prm_),
        warp(threadIdx.x / 32), lane(threadIdx.x % 32),
        prm_base(prm_base_), prm_stride(prm_stride_), prm_len(prm_len_),
        nlay(nlay_) {
    if (threadIdx.x < 3 * RING_MAX_SLOTS) ledger[threadIdx.x] = 0;
    for (int q = threadIdx.x; q < guards() * GUARD_WORDS; q += blockDim.x)
      guard(q / GUARD_WORDS)[q % GUARD_WORDS] =
          ring_canary(q / GUARD_WORDS, q % GUARD_WORDS);
    __syncthreads();
  }

  // The guards: one after each slot, then one after each slot's LW rows
  // on the split route.
  __device__ __forceinline__ int guards() const {
    return lw_slots ? 2 * n_slots : n_slots;
  }
  // Guard k's 32-bit words.
  __device__ __forceinline__ unsigned* guard(int k) const {
    R* g = k >= n_slots ? lw_slots + (size_t)(k - n_slots) * lw_stride +
                              lw_stride - RING_GUARD
                        : slots + (size_t)k * col_floats + col_floats -
                              RING_GUARD;
    return reinterpret_cast<unsigned*>(g);
  }

  // The seeded delay of hand-over point `point` of this warp's column i.
  __device__ __forceinline__ void jitter(int point, int i) const {
    const unsigned j = *(volatile unsigned*)&ring_jitter_ns;
    if (j != 0)
      __nanosleep(ring_hash(ring_seed ^ (unsigned)point, blockIdx.x, warp,
                            i) % j);
  }

  // Lane 0 adds this warp's round to a ledger, after the warp's stores.
  __device__ __forceinline__ void add(unsigned* ledger, int s) const {
    __syncwarp();
    __threadfence_block();
    if (lane == 0) atomicAdd(&ledger[s], 1u);
  }

  // A violation unless lo <= ledger[s] < hi (lane 0).
  __device__ __forceinline__ void expect(const unsigned* ledger, int s,
                                         unsigned lo, unsigned hi, int check,
                                         int column) const {
    if (lane != 0) return;
    const unsigned v = *(const volatile unsigned*)&ledger[s];
    if (v < lo || v >= hi) ring_violation(check, column, s);
  }

  // Optics warp, column c (the block's i-th, slot s): past the FREE wait,
  // then before the FULL arrive.  n_prm: the LW warps that write the
  // slot's next parameters (the stage), else 0.
  __device__ __forceinline__ void freed(int i, int s, int c) const {
    const unsigned r = i / n_slots;
    if (r > 0) {
      expect(swept, s, n_set * r, n_set * r + 1, RING_FREE, c);
      expect(staged, s, n_opt * r, n_opt * (r + 1), RING_FREE, c);
      if (n_prm > 0) expect(params, s, n_prm * r, n_prm * r + 1, RING_PRM, c);
    }
    jitter(0, i);
  }

  // Optics warp computing column c's parameters ahead of its FREE wait
  // (the split route's stage; the block's i-th column, slot s): every
  // optics warp has staged rounds 0 .. i / C - 1 of the slot, the last
  // that read its parameters' place, and none round i / C.
  __device__ __forceinline__ void params_ahead(int i, int s, int c) const {
    const unsigned r = i / n_slots;
    expect(staged, s, n_opt * r, n_opt * r + 1, RING_PRM, c);
    jitter(5, i);
  }

  // LW sweep warp with the stage: the next column's parameters written,
  // before the FREE arrive.
  __device__ __forceinline__ void params_done(int i, int s) const {
    jitter(4, i);
    add(params, s);
  }

  // Optics warp: before the FULL arrive.
  __device__ __forceinline__ void staging_done(int i, int s) const {
    jitter(1, i);
    add(staged, s);
  }

  // Sweep warp: past the FULL wait, then before the FREE arrive.
  __device__ __forceinline__ void filled(int i, int s, int c) const {
    const unsigned r = i / n_slots;
    expect(staged, s, n_opt * (r + 1), n_opt * (r + 1) + 1, RING_FULL, c);
    jitter(2, i);
  }
  __device__ __forceinline__ void sweep_done(int i, int s) const {
    jitter(3, i);
    add(swept, s);
  }

  // NaN over words [a, b) of a slot's staging st, 0 over the layer
  // parameters' places among them (none unless ``with_params``), by this
  // warp's lanes.
  __device__ __forceinline__ void poison(R* st, int a, int b,
                                         bool with_params = true) const {
    for (int q = a + lane; q < b; q += 32) {
      const int p = q - prm_base;
      const bool param = with_params && p >= 0 && p < nlay * prm_stride &&
                         p % prm_stride < prm_len;
      st[q] = param ? (R)0 : ring_nan(R());
    }
  }

  // At the body's end (every thread): the guards kept their values.
  __device__ void finish() const {
    __syncthreads();
    for (int q = threadIdx.x; q < guards() * GUARD_WORDS; q += blockDim.x)
      if (guard(q / GUARD_WORDS)[q % GUARD_WORDS] !=
          ring_canary(q / GUARD_WORDS, q % GUARD_WORDS))
        ring_violation(RING_CANARY, -1, q / GUARD_WORDS % n_slots);
  }
};

}  // namespace

// The checked build's host entry points of kernel NAME:
//   ecckd_NAME_ring_config(seed, jitter_ns): the jitter of later launches
//     (jitter_ns 0: none);
//   ecckd_NAME_ring_errors(out[9], reset): copies the record (count, the
//     four counts per check, first block, column, slot, check) into out
//     and, if reset, clears it.  Each returns a cudaError_t code.
#define RING_ENTRY_POINTS(NAME)                                              \
  extern "C" int ecckd_##NAME##_ring_config(unsigned seed,                  \
                                            unsigned jitter_ns) {           \
    cudaError_t e = cudaMemcpyToSymbol(ring_seed, &seed, sizeof seed);      \
    if (e == cudaSuccess)                                                    \
      e = cudaMemcpyToSymbol(ring_jitter_ns, &jitter_ns, sizeof jitter_ns);  \
    return (int)e;                                                           \
  }                                                                          \
  extern "C" int ecckd_##NAME##_ring_errors(int* out, int reset) {          \
    RingRecord r;                                                            \
    cudaError_t e = cudaMemcpyFromSymbol(&r, ring_record, sizeof r);         \
    if (e != cudaSuccess) return (int)e;                                     \
    const int v[9] = {(int)r.count,       (int)r.by_check[0],                \
                      (int)r.by_check[1], (int)r.by_check[2],                \
                      (int)r.by_check[3], r.block,                           \
                      r.column,           r.slot,                            \
                      r.check};                                              \
    for (int k = 0; k < 9; ++k) out[k] = v[k];                               \
    if (reset) {                                                             \
      const RingRecord zero = {0, {0, 0, 0, 0}, -1, -1, -1, -1};             \
      e = cudaMemcpyToSymbol(ring_record, &zero, sizeof zero);               \
    }                                                                        \
    return (int)e;                                                           \
  }
