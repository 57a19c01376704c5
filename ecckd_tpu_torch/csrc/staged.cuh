// The staged, warp-specialized body of the port's three flux kernels:
// lwsw.cu (LW + SW, K1/K2), lw.cu (LW only, K3) and sw.cu (SW only, K4)
// instantiate staged_body for the bands they solve.
//
// Persistent blocks, each with a ring of C column stagings (common.cuh
// "Per-column staging"), on one of three routes (Staging): whole in shared
// memory; split, each slot's LW rows in a device memory slice per block and
// the rest in shared memory, where that holds more columns per block
// (merged kernel only); or, for columns too deep for shared memory, whole
// in the device slice (a run-time instantiation of its own).  Two warp
// roles, and a stage the second role takes on:
//   optics warps take a column's layers, a contiguous range each (which
//   range turns from column to column, so the larger ranges do not always
//   fall on the same warps), and compute each layer's LW sources (tau and
//   Planck at 2-4 angles) and SW two-stream coefficients for all g-points
//   from its layer parameters (common.cuh "Layer parameters");
//   sweep warps, in S sets of one per LW Gauss angle (two, one per
//   g-chunk, where the plan splits a band of two chunks: Tile.lw_warps)
//   and one for SW, run the serial recurrences of earlier columns from the
//   staging only, g-sum four levels at a time with a transposed warp
//   reduction, and write each output level once.  Set k sweeps the
//   columns of the slots s = k (mod S): a sweep is one warp's serial
//   chain, and the sets let
//   S of them run at once under the optics of the next columns;
//   the parameter stage (the merged kernel's, Tile.prm_stage, where the
//   plan gives it: ops/cuda/staged.py stage_plan): a set's LW sweep
//   warps, done with a column's LW rows while the set's SW warp still
//   sweeps, write the layer parameters of the slot's next column there
//   (the layer's first LW row), a layer per lane over all of its layers,
//   before they free the slot.  The optics warps then start on them: SW
//   optics first, the LW optics last, as they overwrite them.  Without
//   the stage (and for each block's first C columns) every optics warp
//   computes its own layers' parameters first, lanes over them: at nlay
//   60, 12 passes of ~700 warp instructions a column with 5 of 32 lanes
//   busy, each on an optics warp's path, where the stage's 2 passes keep
//   every lane busy and lie beside the SW sweep, off that path.  On the
//   split route the sweeps leave no such room; there the stage keeps the
//   parameters in a place of their own after the accumulators, which no
//   sweep reads, and each optics warp computes its own layers' before it
//   waits for the slot (FREE), while the slot's sweeps finish.
// Named barriers hand each slot from the optics warps to its set of sweep
// warps (FULL) and back (FREE).  Every warp's body is in one kernel;
// __launch_bounds__ holds 1024 threads per SM to 64 registers.
//
// The body computes, stages and sums in the compute type R = Real<T> of
// its table type T (common.cuh "Compute type"): float, or double for the
// merged kernel's f64 instantiations; the staging's words, the device
// slice (Tile.stage, typed float* here for the f32 struct's sake) and
// shared memory then hold R.
//
// Built with -DECCKD_CHECK_RING (ops/cuda/ring_check.py), the body also
// checks that hand-over (csrc/ring_check.cuh: slot ledgers, NaN poison,
// jitter, guard words); the RING(...) statements are that build's alone,
// and without the define the body compiles as if they were not there.
// Built with -DECCKD_TIME_ROLES (ops/cuda/role_clock.py), each warp counts
// the cycles of its waits and phases (csrc/role_clock.cuh); the
// ROLE_CLOCK(...) statements are that build's alone, as RING's are.

#pragma once

#include "common.cuh"

#ifdef ECCKD_CHECK_RING
#include "ring_check.cuh"
#define RING(...) __VA_ARGS__
#else
#define RING(...)
#define RING_ENTRY_POINTS(NAME)
#endif

#ifdef ECCKD_TIME_ROLES
#include "role_clock.cuh"
#define ROLE_CLOCK(...) __VA_ARGS__
#else
#define ROLE_CLOCK(...)
#define ROLE_CLOCK_ENTRY_POINTS(NAME)
#endif

// The staging plan of one launch (ops/cuda/staged.py stage_plan).
struct Tile {
  float* stage;      // device staging, in words of the compute type
                     // (the f64 kernel reads it as double*): (blocks,
                     // slots, col_floats) on the device route, the LW
                     // rows (blocks, slots, lw_floats + the checked
                     // build's guard) on the split route; null when
                     // staged in shared memory alone
  int slots;         // C: columns staged per block (a ring)
  int sets;          // S: sets of sweep warps (S divides C)
  int blocks;        // persistent blocks of the launch
  int threads;       // threads per block: the optics warps, then S sets
                     // of sweep warps (one per LW angle, then one SW)
  int shared_bytes;  // dynamic shared memory per block; 0: device staging
  int col_floats;    // staging words per slot (shared or device)
  int lw_floats;     // LW rows' floats (the SW rows follow, but on the
                     // split route, where they start the slot)
  int sw_floats;     // SW rows' floats (the accumulators follow)
  int prm_base;      // the layer parameters' offset in a slot:
  int prm_stride;    //   layer j's start at prm_base + j * prm_stride;
  int prm_sw;        //   the SW band's gas weights at + prm_sw (common.cuh)
  int prm_stage;     // 1: the sets' LW sweep warps write the layer
                     // parameters of each slot's next column (in its LW
                     // rows: prm_base 0), or on the split route each
                     // optics warp computes its own before its FREE wait
                     // (in their own place); 0: each optics warp computes
                     // its own layers' parameters once it holds the slot
  int lw_warps;      // LW sweep warps a set has per Gauss angle: 1, or 2
                     // where an LW band of two g-chunks in the pairs
                     // layout (common.cuh "Layout") gives each chunk its
                     // own warp; read by the merged kernel's pairs
                     // instantiations alone
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
template <class S, typename R>
bool has_shape(const BandT<R>& B) {
  return B.ngpt == S::NG && B.ndense == S::ND && B.nslice == S::ND + S::NL;
}

// Where a launch stages its columns: whole in the device slice, whole in
// shared memory, or split, the LW rows in the device slice and the rest in
// shared memory.  Each route is an instantiation of its own.
enum Staging { STAGE_DEVICE, STAGE_SHARED, STAGE_SPLIT };

inline Staging staging_of(const Tile& P) {
  return P.shared_bytes == 0 ? STAGE_DEVICE
         : P.stage != nullptr ? STAGE_SPLIT
                              : STAGE_SHARED;
}

// Guard words after each slot's LW rows in the split route's slice: the
// checked build's (ring_check.cuh), none otherwise.
#ifdef ECCKD_CHECK_RING
constexpr int SLICE_GUARD = RING_GUARD;
#else
constexpr int SLICE_GUARD = 0;
#endif

// 1024 threads per SM (blocks of 1024, 512 or 256) at 64 registers each.
constexpr int MAX_THREADS = 1024;
// Named barriers (0 is __syncthreads; a block has 16): slot s is FULL once
// the optics warps have staged its column, FREE once its set of sweep warps
// is done with it (and, with the parameter stage, has written the layer
// parameters of its next column); LW_DONE + k joins set k's LW sweep warps
// before they sum their angles.
constexpr int MAX_SLOTS = 4, NAMED_BARRIERS = 16;
constexpr int BAR_FULL = 1, BAR_FREE = BAR_FULL + MAX_SLOTS,
              BAR_LW_DONE = BAR_FREE + MAX_SLOTS;
// The planted faults' own barrier (tools/cuda_sanitize.py --checked).
constexpr int BAR_PLANT = BAR_LW_DONE + MAX_SLOTS;
static_assert(BAR_PLANT < NAMED_BARRIERS, "more named barriers than 16");
RING(static_assert(MAX_SLOTS <= RING_MAX_SLOTS, "ring ledgers too small");)
#ifdef ECCKD_PLANT_SKIP_FREE
constexpr bool PLANT_SKIP_FREE = true;
#else
constexpr bool PLANT_SKIP_FREE = false;
#endif
#ifdef ECCKD_PLANT_SKIP_PRM
constexpr bool PLANT_SKIP_PRM = true;
#else
constexpr bool PLANT_SKIP_PRM = false;
#endif

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Slot s's LW rows on the split route: the block's device slice, of
// words of type R.
template <typename R>
__device__ __forceinline__ R* lw_slice(const Tile& P, int s) {
  return reinterpret_cast<R*>(P.stage) +
         ((size_t)blockIdx.x * P.slots + s) * (P.lw_floats + SLICE_GUARD);
}

// The planted fault ECCKD_PLANT_SKIP_PRM's slow stage: in the planted
// round the LW sweep warps spin this many clock cycles (~50 us) before they
// write the parameters, so the optics warps read the slot first in every
// run (on the split route the last optics warp spins four times as long
// before it stages its first column).
constexpr long long PLANT_SPIN_CYCLES = 100000;

__device__ __forceinline__ void plant_spin(long long cycles) {
  for (const long long t0 = clock64(); clock64() - t0 < cycles;) {
  }
}

// One launch's solve.  SL / SS: the LW / SW band's Shape (common.cuh),
// NoBand for a band the kernel does not solve (BL / BS, W / S are then
// null); NT: the grid's temperature points, or 0; STAGING: the route
// (Staging; shared memory takes its 32-bit addressing).  A persistent
// block walks the columns blockIdx.x, + gridDim.x, ...; the i-th goes to
// slot i % C and is swept by set i % S.  The block's last S (n_lw + 1)
// warps sweep (per set n_lw LW warps, one per Gauss angle or, with
// Tile.lw_warps 2, one per angle and g-chunk, then the SW warp); the
// others, the optics warps, stage the next columns meanwhile.  On the
// split route a slot's
// LW rows lie in the block's device slice and its SW rows start the slot
// in shared memory; the barriers order the slice's stores and loads as
// they order shared memory's (bar.sync / bar.arrive order a thread's
// earlier accesses to every state space for the threads they join).
// Where the routes differ, each takes its own statement (if constexpr),
// so the whole-column routes compile as they did before the split.
// JAC (the merged kernel's Jacobian instantiation: one LW angle, an LW
// band of one g-chunk) adds RTE's LW surface-temperature Jacobian: the LW
// sweep warp carries it up beside the radiance (common.cuh
// lw_sweeps_chunks) into a row of (nlay + 1) after the slot's
// accumulators and writes it to jac (ncol, nlay + 1) with its fluxes.
template <typename T, class SL, class SS, int NT, int STAGING,
          bool JAC = false>
__device__ __forceinline__ void staged_body(const AtmosT<Real<T>>& A,
                                            const GridT<Real<T>>& G,
                                            const BandT<Real<T>>* BL,
                                            const BandT<Real<T>>* BS,
                                            const LwSolveT<Real<T>>* W,
                                            const SwSolveT<Real<T>>* S,
                                            const Tile& P,
                                            Real<T>* jac = nullptr) {
  ROLE_CLOCK(RoleClock rc;)
  using R = Real<T>;
  constexpr bool LW = SL::NG >= 0, SW = SS::NG >= 0;
  extern __shared__ __align__(16) float smem[];
  const int nlay = A.nlay, nlev = nlay + 1, ncol = A.ncol;
  // LW sweep warps per angle: the plan's where the band takes the pairs
  // layout (common.cuh "Layout"), else 1, so that every other
  // instantiation compiles as if the field were not there.
  int lw_warps = 1;
  if constexpr (PAIRS<SL::NG, R> && SW) lw_warps = P.lw_warps;
  const int n_lw = LW ? W->n_ang * lw_warps : 0, n_set = n_lw + (SW ? 1 : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_opt = blockDim.x / 32 - P.sets * n_set;
  // A slot's barriers join the optics warps and the slot's set.
  const int bar_threads = 32 * (n_opt + n_set);
  constexpr bool SPLIT = STAGING == STAGE_SPLIT;
  // The parameter stage (merged kernel, whole columns): the set's LW
  // sweep warps, done with a column's LW rows, write the layer parameters
  // of the slot's next column there before they free the slot.
  const bool stage = LW && SW && !SPLIT && P.prm_stage != 0;
  R* slots = STAGING != STAGE_DEVICE
                 ? reinterpret_cast<R*>(smem)
                 : reinterpret_cast<R*>(P.stage) +
                       (size_t)blockIdx.x * P.slots * P.col_floats;
  RING(__shared__ unsigned ring_ledger[3 * RING_MAX_SLOTS];
       const int sw_gases = SW ? 3 * BS->nslice - 2 * BS->ndense : 0;
       const RingCheck<R> ring(ring_ledger, slots, P.slots, P.col_floats,
                               SPLIT ? lw_slice<R>(P, 0) : nullptr,
                               P.lw_floats + SLICE_GUARD, n_opt, n_set,
                               stage ? n_lw : 0, P.prm_base, P.prm_stride,
                               P.prm_sw + sw_gases, nlay);)
  // The layer parameters of column c's layers j0, j0 + dj, ... below jb
  // into its slot st.
  auto params = [&](int c, R* st, int j0, int dj, int jb) {
    for (int j = j0; j < jb; j += dj)
      layer_params<T, SL, SS>(A, G, BL, BS, W, c, j,
                              st + P.prm_base + j * P.prm_stride);
  };
  if (warp < n_opt) {
    // The layer parameters of this warp's layers, lanes over them, unless
    // the stage wrote them; then their optics, one layer at a time.
    for (int c = blockIdx.x, i = 0; c < ncol; c += gridDim.x, ++i) {
      const int s = i % P.slots;
      R* st = slots + (size_t)s * P.col_floats;
      const R* prm = st + P.prm_base;
      const int r = (warp + i) % n_opt;
      const int ja = r * nlay / n_opt, jb = (r + 1) * nlay / n_opt;
      // The split route's stage: the parameters lie in a place of their
      // own, which no sweep reads, and the warp computes its layers'
      // before it waits for the slot's sweeps (FREE), in the time that
      // wait would take.  Only from round 2 of a slot (i > C >= 2): the
      // FREE wait of the block's column before has joined every optics
      // warp after its staging of the slot's previous column, the last
      // read of the place.
      // (The planted fault ECCKD_PLANT_SKIP_PRM takes round 1 too, and its
      // last optics warp stages round 0 late.)
      bool ahead = false;
      if constexpr (SPLIT)
        ahead = P.prm_stage != 0 && P.slots >= 2 &&
                (i > P.slots || (PLANT_SKIP_PRM && i == P.slots));
      // The planted fault ECCKD_PLANT_SKIP_FREE (tools/cuda_sanitize.py
      // --checked): in round 1 of slot 0 the optics warps wait for each
      // other (BAR_PLANT) but not for the slot's sweeps, and join FREE
      // only after staging, so they may overwrite the staging that the
      // sweeps still read.  Every barrier keeps its count and order, and
      // the optics warps stay in step: without that, at C = 1 one would
      // stage the slot's next column over layers another still stages,
      // and read that one's rows as its layer parameters (integers).
      const bool late_free = PLANT_SKIP_FREE && i == P.slots && s == 0;
      if (!ahead) {
        ROLE_CLOCK(rc.start();)
        if (late_free) bar_sync(BAR_PLANT, 32 * n_opt);
        else if (i >= P.slots) bar_sync(BAR_FREE + s, bar_threads);
        ROLE_CLOCK(rc.stop(RC_FREE);)
        RING(ring.freed(i, s, c);)
      }
      // (The planted fault computes its own, so that it never reads the
      // slot's rows as parameters before the stage wrote them.)
      if (ahead || !stage || i < P.slots || late_free) {
        RING(if (ahead) ring.params_ahead(i, s, c);)
        ROLE_CLOCK(rc.start();)
        params(c, st, ja + lane, 32, jb);
        __syncwarp();
        ROLE_CLOCK(rc.stop(RC_PARAMS);)
      }
      if (ahead) {
        ROLE_CLOCK(rc.start();)
        bar_sync(BAR_FREE + s, bar_threads);
        ROLE_CLOCK(rc.stop(RC_FREE);)
        RING(ring.freed(i, s, c);)
      }
      if (PLANT_SKIP_PRM && SPLIT && P.prm_stage != 0 && i == 0 &&
          warp == n_opt - 1)
        plant_spin(4 * PLANT_SPIN_CYCLES);
      ROLE_CLOCK(rc.start();)
      if constexpr (SPLIT) {
        lw_optics<T, SL, NT>(A, G, *BL, *W, c, ja, jb, lane, prm,
                              P.prm_stride, lw_slice<R>(P, s));
        sw_optics<T, SS, NT>(A, G, *BS, *S, c, ja, jb, lane, prm,
                              P.prm_stride, P.prm_sw, st);
      } else {
        // The band whose first row holds the parameters goes last: its
        // optics overwrite them (LW with the stage, else SW if present).
        auto lw_pass = [&] {
          if constexpr (LW)
            lw_optics<T, SL, NT>(A, G, *BL, *W, c, ja, jb, lane, prm,
                                  P.prm_stride, st);
        };
        auto sw_pass = [&] {
          if constexpr (SW)
            sw_optics<T, SS, NT>(A, G, *BS, *S, c, ja, jb, lane, prm,
                                  P.prm_stride, P.prm_sw, st + P.lw_floats);
        };
        if (stage) {
          sw_pass();
          lw_pass();
        } else {
          lw_pass();
          sw_pass();
        }
      }
      ROLE_CLOCK(if (PLANT_SLOW_OPTICS) plant_spin(PLANT_SPIN_CYCLES);
                 rc.stop(RC_OPTICS);)
      if (late_free) bar_sync(BAR_FREE + s, bar_threads);
      RING(ring.staging_done(i, s);)
      bar_arrive(BAR_FULL + s, bar_threads);
    }
    ROLE_CLOCK(rc.flush(ROLE_OPTICS);)
  } else {
    // The sweeps from the staging, set k: LW (the set's warp a: angle a,
    // or with lw_warps 2 angle a / 2 at g-chunk a % 2) into its own
    // accumulators, or SW; then the level fluxes, written once.
    const int set = (warp - n_opt) / n_set, a = (warp - n_opt) % n_set;
    for (int c = blockIdx.x + set * gridDim.x, i = set; c < ncol;
         c += P.sets * gridDim.x, i += P.sets) {
      const int s = i % P.slots;
      R* st = slots + (size_t)s * P.col_floats;
      R* acc;
      if constexpr (SPLIT) acc = st + P.sw_floats + 2 * nlev * a;
      else acc = st + P.lw_floats + P.sw_floats + 2 * nlev * a;
      // The Jacobian's row, after every warp's accumulators.
      R* jac_acc = nullptr;
      if constexpr (JAC) jac_acc = acc + 2 * nlev * (n_set - a);
      // The slot's next column, and whether it comes (a FREE to arrive).
      const int c_next = c + P.slots * gridDim.x;
      ROLE_CLOCK(rc.start();)
      bar_sync(BAR_FULL + s, bar_threads);
      ROLE_CLOCK(rc.stop(RC_FULL);)
      RING(ring.filled(i, s, c);)
      ROLE_CLOCK(rc.start();)
      for (int q = lane; q < 2 * nlev; q += 32) acc[q] = (R)0;
      if constexpr (JAC)
        if (a < n_lw)
          for (int q = lane; q < nlev; q += 32) jac_acc[q] = (R)0;
      __syncwarp();
      // The planted fault ECCKD_PLANT_SKIP_PRM: in round 0 of slot 0 the
      // LW warps free the slot before they write the next column's
      // parameters, and write them late (PLANT_SPIN_CYCLES).
      const bool late_prm = PLANT_SKIP_PRM && stage && i == 0;
      bool write_prm = false;
      if (a == n_lw) {
        if constexpr (SW) {
          if constexpr (SPLIT)
            sw_sweeps_staged<SS::NG>(*S, *BS, nlay, c, lane, st, acc,
                                     acc + nlev);
          else
            sw_sweeps_staged<SS::NG>(*S, *BS, nlay, c, lane,
                                     st + P.lw_floats, acc, acc + nlev);
          __syncwarp();
          for (int q = lane; q < nlev; q += 32) {
            S->up[(size_t)c * nlev + q] = acc[q];
            S->dn[(size_t)c * nlev + q] = acc[nlev + q];
          }
          ROLE_CLOCK(if (PLANT_SLOW_SW) plant_spin(PLANT_SPIN_CYCLES);
                     rc.stop(RC_SWEEP);)
          RING(const int o = SPLIT ? 0 : P.lw_floats;
               ring.poison(st, o, o + P.sw_floats);)
        }
      } else if constexpr (LW) {
        const R* rows;
        if constexpr (SPLIT) rows = lw_slice<R>(P, s);
        else rows = st;
        if constexpr (JAC) {
          const int ng = fixed_or<SL::NG>(BL->ngpt);
          lw_sweeps_chunks<R, true>(*W, ng, nlay, c, lane, a, 0, ng, 0, rows,
                                    acc, acc + nlev, jac_acc);
        } else if constexpr (PAIRS<SL::NG, R> && SW) {
          if (lw_warps > 1)
            lw_sweeps_chunk<SL::NG>(*W, nlay, c, lane, a / lw_warps,
                                    a % lw_warps, rows, acc, acc + nlev);
          else
            lw_sweeps_staged<SL::NG>(*W, *BL, nlay, c, lane, a, rows, acc,
                                     acc + nlev);
        } else {
          lw_sweeps_staged<SL::NG>(*W, *BL, nlay, c, lane, a, rows, acc,
                                   acc + nlev);
        }
        // The sums of the angles (and g-chunks), in the warps' order, split
        // over the LW warps.
        ROLE_CLOCK(rc.stop(RC_SWEEP); rc.start();)
        bar_sync(BAR_LW_DONE + set, 32 * n_lw);
        ROLE_CLOCK(rc.stop(RC_LW_DONE); rc.start();)
        const R* acc0 = acc - 2 * nlev * a;
        for (int q = lane + 32 * a; q < 2 * nlev; q += 32 * n_lw) {
          R v = (R)0;
          for (int b = 0; b < n_lw; ++b) v += acc0[2 * nlev * b + q];
          (q < nlev ? W->up : W->dn)[(size_t)c * nlev + q % nlev] = v;
        }
        if constexpr (JAC)
          for (int q = lane + 32 * a; q < nlev; q += 32 * n_lw)
            jac[(size_t)c * nlev + q] = jac_acc[q];
        ROLE_CLOCK(rc.stop(RC_SWEEP);)
        // Every LW warp of the set is done with the LW rows: one poisons
        // them (on the split route they hold no layer parameters).
        RING(if (n_lw > 1) bar_sync(BAR_LW_DONE + set, 32 * n_lw);
             if (a == 0) ring.poison(SPLIT ? lw_slice<R>(P, s) : st, 0,
                                     P.lw_floats, !SPLIT);
             if (stage && n_lw > 1) bar_sync(BAR_LW_DONE + set, 32 * n_lw);
             else __syncwarp();)
        // The stage: the next column's parameters into the LW rows, lanes
        // over its layers, split over the set's LW warps.
        write_prm = stage && c_next < ncol;
        if (write_prm && !late_prm) {
          ROLE_CLOCK(rc.start();)
          params(c_next, st, 32 * a + lane, 32 * n_lw, nlay);
          ROLE_CLOCK(rc.stop(RC_PARAMS);)
          RING(ring.params_done(i, s);)
        }
      }
      __syncwarp();
      RING(ring.sweep_done(i, s);)
      if (c_next < ncol) bar_arrive(BAR_FREE + s, bar_threads);
      if (write_prm && late_prm) {
        plant_spin(PLANT_SPIN_CYCLES);
        params(c_next, st, 32 * a + lane, 32 * n_lw, nlay);
        RING(ring.params_done(i, s);)
      }
    }
    ROLE_CLOCK(rc.flush(a == n_lw ? ROLE_SW_SWEEP : ROLE_LW_SWEEP);
               if (a < n_lw && a % lw_warps != 0) rc.flush(ROLE_LW_CHUNK1);)
  }
  RING(ring.finish();)
}

// The host side of a launch, for the args struct Args of one kernel (its
// Tile in .tile) and the kernel instantiation `kernel` that fits it (null:
// none does, and the launch is refused).
template <typename Args>
using KernelFn = void (*)(Args);

template <typename Args>
cudaError_t configure(KernelFn<Args> kernel, const Args* args) {
  const Tile& P = args->tile;
  if (kernel == nullptr || P.slots < 1 || P.slots > MAX_SLOTS ||
      P.sets < 1 || P.slots % P.sets != 0)
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
