"""The launch side of the staged kernels (csrc/staged.cuh): the merged
csrc/lwsw.cu, the LW-only lw.cu and the SW-only sw.cu.

``stage_plan`` sizes one launch's per-column staging (csrc/common.cuh
"Per-column staging") for the bands it solves, picks the columns per
block, the sets of sweep warps and the threads per block, and the route
(csrc/staged.cuh Staging): a column whole in shared memory, split (its LW
rows in a device memory slice, the rest in shared memory), or whole in
the device slice, whether the merged kernel runs the parameter stage, and
how many LW sweep warps a set has per angle (and, for the merged kernel's
Jacobian instantiation, its accumulator row; ``jac_refusal`` names what
that instantiation leaves out);
``occupancy`` asks the card how many such blocks an SM holds; and
``run_staged`` launches any of the three kernels over column chunks.  The
wrappers in ops/cuda/{lwsw,lw,sw}.py call ``run_staged`` with the bands
they solve (None for an absent one).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ecckd_tpu_torch.ops.cuda import binding, plan as plan_mod

RESERVED_SHARED_BYTES = 1024
"""Shared memory the CUDA runtime holds per block besides its own
(cudaDevAttrReservedSharedMemoryPerBlock, sm_80 and later)."""
MAX_SLOTS = 2
"""Columns staged per block: one swept while the next one's optics run."""
SLOT_LIMIT = 4
"""The most slots csrc/staged.cuh has named barriers for (MAX_SLOTS)."""
SHAPES = {"lwsw": (2, 2, 2), "lw": (4, 2, 2), "sw": (2, 3, 3)}
"""Per kernel: (blocks per SM, C, S) that ``plan_for`` asks ``stage_plan``
for (PERF.md §6 has the block shapes timed)."""
SM_THREADS = 1024
"""Threads per SM of a launch (64 registers each)."""
F64_SM_THREADS = 768
"""Threads per SM of the merged kernel's double instantiations that stage
in shared memory (whole or split): csrc/lwsw.cu F64_SHARED_THREADS, 80
registers each; on the device route they keep ``SM_THREADS``."""
SHIPPED_NT = 6
"""Temperatures of the shipped files' (p, T) grid (csrc/staged.cuh)."""
CONSTANT_SHAPES = {"lw": ((32, 7, 1), (36, 7, 1)), "sw": ((27, 5, 1),)}
"""(g-points, dense gases, LUT gases) of the bands whose instantiations
take them as template constants, on ``SHIPPED_NT`` temperatures
(csrc/staged.cuh FsckShape, RrtmgpShape, WideShape; the merged kernel
only with the SW one): csrc/*.cu ``pick``."""


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A staged kernel's staging for one launch (csrc/common.cuh
    "Per-column staging"), in words of the compute type per column
    (``*_floats``; ``word_bytes`` each: 4 at float32, 8 at float64)."""
    lw_floats: int     # LW rows x ngpt_lw
    sw_floats: int     # SW rows x ngpt_sw
    acc_floats: int    # level accumulators, 2 (nlay+1) per LW sweep
                       # warp and 2 (nlay+1) for SW; with the Jacobian
                       # (nlay+1) more, after them
    prm_floats: int    # layer parameters in a place of their own, or 0
    prm_base: int      # layer j's parameters start at prm_base +
    prm_stride: int    #   j * prm_stride,
    prm_sw: int        #   the SW band's gas weights prm_sw later
    slots: int         # C: columns staged per block
    sets: int          # S: sets of sweep warps per block (S divides C)
    shared: bool       # staged in shared memory (else a device slice)
    threads: int       # threads per block
    guard_floats: int = 0  # guard words after each slot (and, split,
                           # after its LW rows): the ring checker's build
                           # only (ops/cuda/ring_check.py)
    split: bool = False    # the LW rows in a device slice, the rest of
                           # the slot in shared memory
    prm_stage: bool = False  # the sets' LW sweep warps write each slot's
                             # next layer parameters (in its LW rows);
                             # else each optics warp computes its own
    word_bytes: int = 4      # bytes of a staged word: the compute type's
    lw_warps: int = 1        # LW sweep warps a set has per angle: 2 where
                             # each g-chunk of a band of two in the pairs
                             # layout has its own (csrc/staged.cuh)

    @property
    def route(self) -> str:
        """"shared", "split" or "device" (csrc/staged.cuh Staging)."""
        return ("split" if self.split else "shared" if self.shared
                else "device")

    @property
    def col_floats(self) -> int:
        """The floats of one slot: what a column stages there (on the
        split route all but its LW rows), then the guard."""
        return ((0 if self.split else self.lw_floats) + self.sw_floats
                + self.acc_floats + self.prm_floats + self.guard_floats)

    @property
    def bytes_per_column(self) -> int:
        return self.word_bytes * self.col_floats

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory per block (0 on the device route)."""
        return self.slots * self.bytes_per_column if self.shared else 0

    @property
    def sm_blocks(self) -> int:
        """Blocks per SM that the plan's threads ask for: the threads an
        SM runs (``SM_THREADS``, or ``F64_SM_THREADS`` at float64 in
        shared memory) over the block's.  ``occupancy`` reads what the
        card holds."""
        return ((F64_SM_THREADS if self.word_bytes == 8 and self.shared
                 else SM_THREADS) // self.threads)

    @property
    def report(self) -> str:
        """The plan in one line: route, C, S, threads per block, blocks
        and columns in flight per SM, the parameter stage, and the LW
        sweep warps an angle where a set has more than one."""
        return (f"{self.route}, C = {self.slots}, S = {self.sets}, "
                f"{self.threads} threads, {self.sm_blocks} blocks and "
                f"{self.sm_blocks * self.slots} columns per SM, stage "
                f"{'on' if self.prm_stage else 'off'}"
                + (f", {self.lw_warps} LW sweep warps an angle (one per "
                   "g-chunk)" if self.lw_warps > 1 else ""))

    @property
    def slice_floats(self) -> int:
        """Device staging floats per slot: the slot on the device route,
        its LW rows and their guard on the split route, else 0."""
        if self.split:
            return self.lw_floats + self.guard_floats
        return 0 if self.shared else self.col_floats


def band_gases(gas_plan: plan_mod.GasPlan) -> Tuple[int, int]:
    """(dense gases, LUT gases) of one band's gas plan."""
    nd = sum(sl.kind == plan_mod.KIND_DENSE for sl in gas_plan.slices)
    return nd, len(gas_plan.slices) - nd


def pairs(ngpt_lw: int, ngpt_sw: int, gases_lw: Tuple[int, int],
          gases_sw: Tuple[int, int], n_t: int, word_bytes: int) -> bool:
    """csrc/common.cuh ``PAIRS`` of the instantiation that ``pick`` runs
    on these bands: whether its LW band is a template constant
    (``CONSTANT_SHAPES``) above 32 g-points at compute type float, so its
    LW optics and sweeps take one pass over (layer, g-point) pairs
    ("Layout") instead of the g-chunk loop."""
    constant = (n_t == SHIPPED_NT
                and (ngpt_lw, *gases_lw) in CONSTANT_SHAPES["lw"]
                and (not ngpt_sw
                     or (ngpt_sw, *gases_sw) in CONSTANT_SHAPES["sw"]))
    return constant and ngpt_lw > 32 and word_bytes == 4


def stage_plan(nlay: int, ngpt_lw: int, ngpt_sw: int, n_angles: int,
               gases_lw: Tuple[int, int], gases_sw: Tuple[int, int],
               block_shared: int, sm_shared: int, blocks_per_sm: int = 2,
               max_slots: int = MAX_SLOTS, sets: int = 1,
               param_stage: Optional[bool] = None,
               word_bytes: int = 4,
               split: Optional[bool] = None,
               n_t: int = SHIPPED_NT,
               lw_warps: Optional[int] = None,
               jac: bool = False) -> StagePlan:
    """The staging of one launch of the kernel that solves the bands with
    ``ngpt_* > 0`` (both: lwsw.cu, LW only: lw.cu, SW only: sw.cu).

    Per column: LW 3 nlay rows at 1 angle (tr, src_dn, src_up), 3 nlay + 1
    at 2-4 (tau, layer and level Planck); SW 5 nlay + 2 rows; 2 (nlay+1)
    accumulators (up, down) per LW angle and 2 (nlay+1) for SW, and with
    ``jac`` (the merged kernel's Jacobian instantiation) one more row of
    (nlay+1), the LW sweep's d flux_up / d T_sfc, after them; and the
    layer parameters, 4 + with LW 4 Planck words, per band 1 per dense and
    3 per LUT gas (``gases_*``: ``band_gases``) per layer.  These go in
    the layer's first row of the band solved last (SW if present) when
    that band has <= 32 g-points (one g-chunk: the row is written only
    after they are read) and they fit there, else after the accumulators.

    ``word_bytes`` is the size of a staged word, the compute type's: 4 at
    float32, 8 at float64, where every row, parameter and accumulator is a
    double and a column takes twice the bytes (nlay 60: 113,264 B, so C =
    2 in one block per SM where float32 runs two), and where the kernel
    holds ``F64_SM_THREADS`` per SM in shared memory (``SM_THREADS`` on
    the device route).

    ``block_shared`` and ``sm_shared`` are the card's shared memory per
    block (opt-in) and per SM, in bytes.  C, the columns staged per
    block, is the most, up to ``max_slots``, that fit in
    ``block_shared``; columns that do not fit alone are staged in device
    memory, ``max_slots`` per block.  With both bands, where whole columns
    fit but fewer than ``max_slots`` of them, and more fit without their
    LW rows, the plan is split: each slot's LW rows go to a device slice
    and C is the most of the rest that fit (the layer parameters stay in
    the SW rows or after the accumulators, which then start the slot).
    Where the instantiation lays its LW band's (layer, g-point) pairs over
    the lanes (``pairs``: lw_rrtmgp's 36 g-points at float32 on the
    grid's ``n_t`` temperatures), at one angle the plan also weighs blocks
    per SM: it is split where that holds more columns in flight per SM
    (blocks x C) than whole columns do.  ``split`` True or False asks for
    the split route or whole columns instead of the rule
    (tools/stage_sweep.py times both; True without both bands raises).
    S, the sets of sweep warps (one per LW angle and one SW each; set k
    sweeps slots k, k + S, ...), is the most, up to ``sets``, that
    divides C.  Threads per block: 1024 (64 registers each) per SM, in
    ``blocks_per_sm`` blocks where that many fit in ``sm_shared`` and hold
    the S sets and one optics warp, else in half as many, down to one
    (768 per SM at float64 in shared memory).

    The parameter stage (csrc/staged.cuh; the merged kernel's) takes the
    optics warps' own pass over their layers' parameters (lanes over
    layers, one pass per optics warp and column) off their path.  With
    whole columns in shared memory each set's LW sweep warps, done with a
    column's LW rows, write the parameters of the slot's next column
    there, lanes over its layers (the layer's first LW row: ``prm_base``
    0, ``prm_stride`` the LW g-points; the staging keeps its size).  On
    the split route the parameters move to a place of their own after the
    accumulators (``per_layer`` words a layer, where C still fits), which
    no sweep reads, and each optics warp computes its layers' there before
    it waits for the slot.  It needs both bands and an LW band of one
    g-chunk whose row holds them, or on the split route one laid out in
    pairs (``with_param_stage``).  ``param_stage``
    None takes it where ``stage_rule`` says: at one LW angle with C = 2.
    True or False asks for it or not (tools/stage_sweep.py times both),
    True where it does not fit raising.

    LW sweep warps per angle (``lw_warps``; csrc/staged.cuh): one walks
    an angle's g-points, over both g-chunks at once where the band lays
    them out in pairs (lane l carries g-points l and l + 32); or, with
    ``with_chunk_warps``, each of the two g-chunks has a warp of its own
    (g-points 0-31 one recurrence a lane, 32-35 on the second warp) with
    accumulators of its own, and the set adds the two chunks' level sums
    in chunk order.  ``lw_warps`` None takes two where they fit: the
    pairs layout at one angle on the split route, the second warp's
    accumulators (2 (nlay + 1) words a slot) keeping the plan's C, blocks
    per SM and parameter stage; 1 or 2 asks for one or the other
    (tools/stage_sweep.py ``g1`` / ``g2`` times both), 2 where it does
    not fit raising.

    The rule, timed with tools/stage_sweep.py at 65,536 columns on an
    H100 80GB HBM3 at 700 W, the same build with and without the stage:
    with C = 2 a slot turns over in its optics, then its sweeps.  With
    whole columns the optics warps' path sets the pace; at one angle the
    stage takes their pass off it and the LW sweep warp writes it while
    the SW warp still sweeps (K1 at nlay 30 3.57-3.61 -> 3.11-3.29 ms, 60
    5.65-5.83 -> 5.45-5.68, 91 11.88-12.07 -> 10.88-10.96).  On the split
    route, whose sweeps read the LW rows through L2, the sweep warps have
    no such room: their pass lengthened the slot's turn (nlay 137 16.4-16.8
    -> 16.9-17.3 ms with the parameters in their own place, 18.6-18.8 in
    the slice's LW rows), so there the optics warps, which wait for the
    slot, compute them meanwhile (nlay 124 15.2-15.4 -> 14.4-14.6 ms, 137
    16.4-16.8 -> 15.8-16.0, 175 20.6-20.7 -> 20.3; the benchmark's
    inputs).  From nlay 176 (float64: 88) their place leaves one column
    per block, and the split route runs without the stage.  At 3 angles
    the set's three LW sweep warps, which compute each angle's sources,
    leave no room beside the SW sweep (nlay 60 6.84-6.99 -> 7.09-7.25
    ms), and with C = 1 no other slot's optics run beside the pass (K3 at
    nlay 300: 32.1-32.4 -> 42.1 ms).

    The split rule at 36 LW g-points, timed the same way (K1 on a banded
    emissivity): at nlay 60 a whole column (59,512 B) leaves one block of
    1024 threads per SM, 2 columns in flight, 10.06 ms; split, two
    blocks of 512 threads and 4 columns, 7.16-7.42 ms (C = 3 whole in one
    block 8.51, split C = 3 in two 7.68, split C = 4 in one 8.76); nlay
    91 13.87 -> 11.33 ms.  At nlay 47, where whole columns keep two
    blocks, they stay whole (6.25 against 6.38 split).  At float64, whose
    instantiations keep the chunked loop, more columns in flight lost
    (nlay 47: whole in one block 12.24 ms, split in two 13.77-13.79), so
    there, on the run-time shapes (the g-chunk loop too) and at 2-4
    angles (not timed) the rule is the one above.  The parameter stage on
    that split route (the parameters' own place, 26 words a layer): nlay
    60 7.62-7.65 -> 7.25-7.43 ms in two blocks of 512 threads; nlay 137,
    one block of 1024, 20.57-20.83 -> 20.41-20.63.  From nlay 88 the place
    leaves one block per SM: at nlay 91 two blocks without it 10.84-11.21
    ms, one with it 14.37-14.40, so there it is declined.  At nlay 47 whole
    columns stay (5.84-6.16 ms; split 6.39-6.60, with the stage
    6.23-6.45).  One LW sweep warp per g-chunk on those split plans, timed
    the same way against one warp over the pairs in the same call: nlay
    60 (stage, two blocks of 512) 6.60-6.65 against 7.22-7.87 ms, 91 (no
    stage, two blocks) 10.24-10.54 against 11.13-11.21, 137 (stage, one
    block of 1024) 18.25-18.49 against 20.92-21.01: the chunk-0 warp's
    walk takes 36.1 k cycles a column at nlay 60 where the pairs took
    67.7 k (the role clock), and the slot's turn is the optics and the SW
    sweep again.  Where the second warp's accumulators would cost the
    stage (nlay 87, 174-175) or a block (103, 206-208) the pairs stay (not
    timed)."""
    if not 1 <= max_slots <= SLOT_LIMIT:
        raise ValueError(f"max_slots must be in 1..{SLOT_LIMIT}")
    has_lw, has_sw = ngpt_lw > 0, ngpt_sw > 0
    prm_lw = 4 + gases_lw[0] + 3 * gases_lw[1] if has_lw else 0
    prm_sw = gases_sw[0] + 3 * gases_sw[1] if has_sw else 0
    lw_floats = (3 * nlay if n_angles == 1 else 3 * nlay + 1) * ngpt_lw
    sw_floats = (5 * nlay + 2) * ngpt_sw
    sweeps = (n_angles if has_lw else 0) + int(has_sw)
    acc_floats = 2 * sweeps * (nlay + 1) + (nlay + 1 if jac else 0)
    per_layer = 4 + prm_lw + prm_sw
    last = ngpt_sw if has_sw else ngpt_lw
    in_rows = last <= 32 and per_layer <= last
    plan = StagePlan(
        lw_floats=lw_floats, sw_floats=sw_floats, acc_floats=acc_floats,
        prm_floats=0 if in_rows else per_layer * nlay,
        prm_base=((lw_floats if has_sw else 0) if in_rows
                  else lw_floats + sw_floats + acc_floats),
        prm_stride=last if in_rows else per_layer, prm_sw=4 + prm_lw,
        slots=max_slots, sets=1, shared=True, threads=1024,
        word_bytes=word_bytes)

    def shaped(p: StagePlan) -> StagePlan:
        """``p`` with its C, S and the threads of the blocks that fit."""
        fit = block_shared // p.bytes_per_column
        slots = min(fit, max_slots) or max_slots
        s = max(k for k in range(1, min(sets, slots) + 1) if slots % k == 0)
        p = dataclasses.replace(p, slots=slots, sets=s, shared=fit >= 1)
        sm_threads = (F64_SM_THREADS if word_bytes == 8 and p.shared
                      else SM_THREADS)
        blocks = blocks_per_sm
        while blocks > 1 and (
                sm_threads // blocks < 32 * (s * sweeps + 1) or p.shared
                and blocks * (p.shared_bytes + RESERVED_SHARED_BYTES)
                > sm_shared):
            blocks //= 2
        return dataclasses.replace(p, threads=sm_threads // blocks)

    whole = shaped(plan)
    cut = (shaped(dataclasses.replace(plan, split=True,
                                      prm_base=plan.prm_base - lw_floats))
           if has_lw and has_sw else None)
    if split is None:
        in_flight = lambda p: p.sm_blocks * p.slots
        split = cut is not None and (
            whole.shared and whole.slots < max_slots
            and cut.slots > whole.slots
            or n_angles == 1
            and pairs(ngpt_lw, ngpt_sw, gases_lw, gases_sw, n_t, word_bytes)
            and in_flight(cut) > in_flight(whole))
    elif split and cut is None:
        raise ValueError("no split route without both bands")
    plan = cut if split else whole
    with_stage = with_param_stage(
        plan, nlay, ngpt_lw, ngpt_sw, per_layer, block_shared, sm_shared,
        pairs(ngpt_lw, ngpt_sw, gases_lw, gases_sw, n_t, word_bytes))
    if param_stage is None:
        param_stage = with_stage is not None and stage_rule(plan, n_angles)
    if param_stage and with_stage is None:
        raise ValueError(f"no parameter stage on the {plan.route} route "
                         f"with {ngpt_lw} LW g-points and {per_layer} "
                         "parameters a layer")
    plan = with_stage if param_stage else plan
    chunked = with_chunk_warps(
        plan, nlay, n_angles, block_shared, sm_shared,
        pairs(ngpt_lw, ngpt_sw, gases_lw, gases_sw, n_t, word_bytes))
    if lw_warps is None:
        lw_warps = 2 if chunked is not None else 1
    if lw_warps not in (1, 2) or lw_warps == 2 and chunked is None:
        raise ValueError(f"no {lw_warps} LW sweep warps an angle on this "
                         f"{plan.route} plan with {ngpt_lw} LW g-points at "
                         f"{n_angles} angle(s)")
    return chunked if lw_warps == 2 else plan


def with_param_stage(plan: StagePlan, nlay: int, ngpt_lw: int,
                     ngpt_sw: int, per_layer: int, block_shared: int,
                     sm_shared: int, lw_pairs: bool) -> Optional[StagePlan]:
    """``plan`` (one without the stage) with the parameter stage, or None
    where it cannot take it: it needs both bands (the merged kernel's),
    the parameters in rows already, and whole columns in shared memory,
    where the parameters move to the LW rows (an LW band of one g-chunk
    whose row holds a layer's ``per_layer`` parameters), or the split
    route, where they move after the accumulators (``per_layer`` a layer)
    if C still fits in ``block_shared``.  There the LW band may also be
    one whose optics lay (layer, g-point) pairs over the lanes
    (``lw_pairs``: ``pairs``), which read only their own warp's layers'
    parameters and never share a row with them, if the plan's blocks per
    SM still fit in ``sm_shared`` too (its split plans hold two, which
    the place leaves room for to nlay 87); with whole columns such a band
    writes a layer's LW row before a later step reads its parameters, and
    is refused.  At <= 32 g-points the split plans keep what they were
    timed with."""
    chunk = 0 < ngpt_lw <= 32 and per_layer <= ngpt_lw
    if not ((chunk or lw_pairs and plan.split) and ngpt_sw > 0
            and plan.prm_floats == 0):
        return None
    if plan.route == "shared":
        return dataclasses.replace(plan, prm_stage=True, prm_base=0,
                                   prm_stride=ngpt_lw)
    if plan.route != "split":
        return None
    own = dataclasses.replace(plan, prm_stage=True,
                              prm_floats=per_layer * nlay,
                              prm_base=plan.sw_floats + plan.acc_floats,
                              prm_stride=per_layer)
    sm_fits = (own.sm_blocks * (own.shared_bytes + RESERVED_SHARED_BYTES)
               <= sm_shared)
    fits = (block_shared // own.bytes_per_column >= plan.slots
            and (sm_fits or not lw_pairs))
    return own if fits else None


def with_chunk_warps(plan: StagePlan, nlay: int, n_angles: int,
                     block_shared: int, sm_shared: int,
                     lw_pairs: bool) -> Optional[StagePlan]:
    """``plan`` with one LW sweep warp per g-chunk (``lw_warps`` 2), or
    None where it cannot take them: an LW band of two g-chunks in the
    pairs layout (``lw_pairs``: ``pairs``), one angle, the split route,
    and room for the second warp's accumulators (2 (nlay + 1) words a
    slot, the parameters' own place after them) that keeps the plan's C,
    blocks per SM and parameter stage, with an optics warp left beside
    the sets' sweep warps.  ``stage_plan`` gives it where it fits."""
    if not (lw_pairs and n_angles == 1 and plan.split):
        return None
    extra = 2 * (nlay + 1)
    two = dataclasses.replace(
        plan, lw_warps=2, acc_floats=plan.acc_floats + extra,
        prm_base=plan.prm_base + (extra if plan.prm_floats else 0))
    fits = (block_shared // two.bytes_per_column >= plan.slots
            and two.sm_blocks * (two.shared_bytes + RESERVED_SHARED_BYTES)
            <= sm_shared
            and two.threads >= 32 * (two.sets * 3 + 1))
    return two if fits else None


def stage_rule(plan: StagePlan, n_angles: int) -> bool:
    """Where the parameter stage pays, for a plan it fits (``stage_plan``
    gives the timings): the shape alone decides."""
    return n_angles == 1 and plan.slots >= 2


def tile_struct(plan: StagePlan, blocks: int = 0,
                stage: Optional[torch.Tensor] = None) -> binding.Tile:
    """The kernel's Tile of ``plan``; ``stage``: the device slice
    (``slice_floats`` per slot) on the device and split routes."""
    return binding.Tile(stage=0 if stage is None else stage.data_ptr(),
                        slots=plan.slots, sets=plan.sets, blocks=blocks,
                        threads=plan.threads,
                        shared_bytes=plan.shared_bytes,
                        col_floats=plan.col_floats,
                        lw_floats=plan.lw_floats, sw_floats=plan.sw_floats,
                        prm_base=plan.prm_base, prm_stride=plan.prm_stride,
                        prm_sw=plan.prm_sw, prm_stage=int(plan.prm_stage),
                        lw_warps=plan.lw_warps)


def kernel_name(lw: Optional[plan_mod.LwInputs],
                sw: Optional[plan_mod.SwInputs]) -> str:
    """The kernel that solves these bands: "lwsw", "lw" or "sw"."""
    return "lwsw" if lw and sw else "lw" if lw else "sw"


def plan_for(atm: plan_mod.Atmosphere, lw: Optional[plan_mod.LwInputs],
             sw: Optional[plan_mod.SwInputs], jac: bool = False) -> StagePlan:
    """``stage_plan`` for these inputs, on their card's shared memory, in
    their kernel's block shape (``SHAPES``), at their dtype's word size,
    on their grid's temperatures; ``jac``: the merged kernel's Jacobian
    instantiation's."""
    props = torch.cuda.get_device_properties(atm.tlay.device)
    blocks, slots, sets = SHAPES[kernel_name(lw, sw)]
    return stage_plan(atm.tlay.shape[1], lw.plan.ngpt if lw else 0,
                      sw.plan.ngpt if sw else 0,
                      lw.n_gauss_angles if lw else 1,
                      band_gases(lw.plan) if lw else (0, 0),
                      band_gases(sw.plan) if sw else (0, 0),
                      props.shared_memory_per_block_optin,
                      props.shared_memory_per_multiprocessor,
                      blocks_per_sm=blocks, max_slots=slots, sets=sets,
                      word_bytes=atm.tlay.element_size(),
                      n_t=(lw or sw).n_t, jac=jac)


def jac_refusal(nlay: int, ngpt_lw: int, ngpt_sw: int,
                gases_lw: Tuple[int, int], gases_sw: Tuple[int, int],
                n_t: int, block_shared: Optional[int] = None,
                sm_shared: Optional[int] = None) -> Optional[str]:
    """Why the merged kernel's Jacobian instantiation does not take these
    bands, or None: it runs an LW band of one g-chunk (one LW sweep warp
    an angle, one angle: the caller checks the angles) whose shape, and
    the SW band's, the kernels take as constants (``CONSTANT_SHAPES``:
    lw_fsck with sw_wide, csrc/lwsw.cu ``pick_jac``), and with the card's
    shared memory given (``block_shared``, ``sm_shared``) only where
    ``stage_plan`` stages its columns in shared memory, whole or split,
    not in the device slice."""
    if ngpt_lw > 32:
        return (f"the Jacobian instantiation sweeps an LW band of one "
                f"g-chunk (<= 32 g-points); {ngpt_lw} take the pairs layout")
    if ((ngpt_lw, *gases_lw) not in CONSTANT_SHAPES["lw"]
            or (ngpt_sw, *gases_sw) not in CONSTANT_SHAPES["sw"]
            or n_t != SHIPPED_NT):
        return ("the Jacobian instantiation takes the shipped lw_fsck + "
                "sw_wide shapes (32 + 27 g-points, 7 + 1 and 5 + 1 gases, "
                f"{SHIPPED_NT} temperatures) as constants, not "
                f"{ngpt_lw} + {ngpt_sw} g-points with {gases_lw} and "
                f"{gases_sw} gases on {n_t} temperatures")
    if block_shared is None:
        return None
    blocks, slots, sets = SHAPES["lwsw"]
    plan = stage_plan(nlay, ngpt_lw, ngpt_sw, 1, gases_lw, gases_sw,
                      block_shared, sm_shared, blocks_per_sm=blocks,
                      max_slots=slots, sets=sets, jac=True)
    if plan.route == "device":
        return (f"at nlay {nlay} a column stages in the device slice, a "
                "route the Jacobian instantiation leaves out")
    return None


@functools.lru_cache(maxsize=None)
def blocks_per_sm(name: str, shape: tuple, threads: int, shared_bytes: int,
                  mode: str, device_index: int,
                  lib: Optional[ctypes.CDLL] = None,
                  split: bool = False, jac: bool = False) -> int:
    """The CUDA occupancy calculator's blocks per SM for a launch
    configuration of kernel ``name`` in launch mode ``mode``
    (binding.MODES: ``ecckd_<name>_occupancy`` or ``..._occupancy_f64``;
    with ``jac``, binding.JAC: ``..._occupancy_jac``)
    on one card; ``shape`` (``launch_shape``) and ``split`` (the route)
    pick the instantiation, ``lib`` a bound build other than
    ``binding.library``'s."""
    args_type = binding.args_type(name, mode, jac)
    lib = lib or binding.library(name)
    if mode == "f64":
        fn = getattr(lib, f"ecckd_{name}_occupancy_f64")
        fn.argtypes = [ctypes.c_void_p]
        query = fn
    else:
        tag = binding.JAC[0] if jac else ""
        fn = getattr(lib, f"ecckd_{name}_occupancy{tag}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        query = lambda a: fn(a, int(mode == "fast"))
    fn.restype = ctypes.c_int
    lw_shape, sw_shape, n_t = shape
    # A stage pointer beside shared memory names the split route; the
    # query reads no memory through it.
    args = args_type(tile=binding.Tile(stage=int(split), slots=1, sets=1,
                                       threads=threads,
                                       shared_bytes=shared_bytes))
    args.grid.n_t = n_t
    for field, band in (("lw_band", lw_shape), ("sw_band", sw_shape),
                        ("band", lw_shape or sw_shape)):
        if hasattr(args, field):
            b = getattr(args, field)
            b.ngpt, b.ndense, b.nslice = band
    with torch.cuda.device(device_index):
        blocks = query(ctypes.byref(args))
    if blocks <= 0:
        raise RuntimeError(f"ecckd_{name}_occupancy: {threads} threads with "
                           f"{shared_bytes} B of shared memory do not fit")
    return blocks


def launch_shape(lw: Optional[plan_mod.LwInputs],
                 sw: Optional[plan_mod.SwInputs]) -> tuple:
    """What picks a kernel's instantiation (csrc/*.cu pick): per band
    (ngpt, dense gases, gases) or None, and the grid's temperatures."""
    shape = lambda b: (b and (b.plan.ngpt, band_gases(b.plan)[0],
                              len(b.plan.slices)))
    return shape(lw), shape(sw), (lw or sw).n_t


def occupancy(atm: plan_mod.Atmosphere, lw: Optional[plan_mod.LwInputs],
              sw: Optional[plan_mod.SwInputs],
              plan: Optional[StagePlan] = None,
              lib: Optional[ctypes.CDLL] = None,
              jac: bool = False) -> Tuple[StagePlan, int]:
    """(the staging plan, blocks per SM) of the launch of the kernel for
    these prepared bands (both: the merged kernel; one, the other None:
    its own) on their card; ``plan`` replaces ``plan_for``'s, ``lib``
    the kernel's build (``blocks_per_sm``), ``jac`` asks for the merged
    kernel's Jacobian instantiation."""
    plan = plan or plan_for(atm, lw, sw, jac)
    mode = binding.mode_of(atm, lw or sw)
    return plan, blocks_per_sm(kernel_name(lw, sw), launch_shape(lw, sw),
                               plan.threads, plan.shared_bytes, mode,
                               atm.tlay.device.index or 0, lib, plan.split,
                               jac)


def run_staged(atm: plan_mod.Atmosphere, lw: Optional[plan_mod.LwInputs],
               sw: Optional[plan_mod.SwInputs], column_chunk: int, counted,
               plan: Optional[StagePlan] = None,
               max_blocks: Optional[int] = None,
               lib: Optional[ctypes.CDLL] = None, jac: bool = False):
    """Launch the staged kernel for the bands present (csrc/lwsw.cu,
    lw.cu or sw.cu) over column chunks on the current stream, in the
    bands' table mode: persistent blocks, as many as the card holds at
    once, on ``stage_plan``'s staging (a device slice per block where a
    column, or on the split route its LW rows, does not stay in shared
    memory; ``max_blocks`` caps them).
    Returns the (ncol, nlay+1) outputs, (up, down) per band, LW first, in
    the inputs' dtype, and with ``jac`` (the merged kernel's Jacobian
    instantiation, ``binding.JAC``) d LW up / d T_sfc fifth; the
    launch mode is theirs (``binding.mode_of``).
    Launches count on ``counted`` (binding.launch_chunks); the route and
    the parameter stage are ``plan_for``'s, not counted.  ``lib``: a
    bound build of the kernel other than the plain one (the ring
    checker's, ops/cuda/ring_check.py); the launch paths pass none."""
    ncol, nlay = atm.tlay.shape
    name = kernel_name(lw, sw)
    dev, dtype = atm.tlay.device, atm.tlay.dtype
    mode = binding.mode_of(atm, lw or sw)
    # The kernel writes every level of every column: no zero-fill.
    outs = [torch.empty((ncol, nlay + 1), dtype=dtype, device=dev)
            for _ in range(2 * ((lw is not None) + (sw is not None))
                           + int(jac))]
    if ncol == 0:
        return outs
    chunk = max(1, min(int(column_chunk), ncol))
    plan, per_sm = occupancy(atm, lw, sw, plan, lib, jac)
    blocks = min(chunk, max_blocks or chunk, per_sm * torch.cuda.
                 get_device_properties(dev).multi_processor_count)
    stage = torch.empty((blocks, plan.slots, plan.slice_floats),
                        dtype=dtype, device=dev) if plan.slice_floats else None
    # The merged kernel shares one grid: the LW model's (mergeable pair);
    # a single-band kernel takes its model's own.
    grid = binding.grid_struct(lw or sw)
    tile = tile_struct(plan, blocks, stage)
    args_type = binding.args_type(name, mode, jac)
    if lw and sw:
        bands = dict(lw_band=binding.band_struct(lw),
                     sw_band=binding.band_struct(sw))
    else:
        bands = dict(band=binding.band_struct(lw or sw))
    sw_outs = outs[2:4] if lw else outs

    def make_args(c0: int, c1: int):
        solves = {}
        if lw:
            solves["lw"] = binding.lw_struct(lw, c0, c1, outs[0], outs[1])
        if sw:
            solves["sw"] = binding.sw_struct(sw, c0, c1, *sw_outs)
        if jac:
            solves["jac"] = outs[4][c0:c1].data_ptr()
        return args_type(atm=binding.atmos_struct(atm, c0, c1), grid=grid,
                         tile=tile, **bands, **solves)

    binding.launch_chunks(name, ncol, chunk, make_args, counted, dev, mode,
                          lib, jac)
    return outs
