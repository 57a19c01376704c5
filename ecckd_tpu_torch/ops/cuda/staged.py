"""The launch side of the staged kernels (csrc/staged.cuh): the merged
csrc/lwsw.cu, the LW-only lw.cu and the SW-only sw.cu.

``stage_plan`` sizes one launch's per-column staging (csrc/common.cuh
"Per-column staging") for the bands it solves, picks the columns per
block, the sets of sweep warps and the threads per block, and whether a
column fits in shared memory or goes to a device memory slice;
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


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A staged kernel's staging for one launch (csrc/common.cuh
    "Per-column staging"), in float32 words per column."""
    lw_floats: int     # LW rows x ngpt_lw
    sw_floats: int     # SW rows x ngpt_sw
    acc_floats: int    # level accumulators, 2 (nlay+1) per LW angle and
                       # 2 (nlay+1) for SW
    prm_floats: int    # layer parameters in a place of their own, or 0
    prm_base: int      # layer j's parameters start at prm_base +
    prm_stride: int    #   j * prm_stride,
    prm_sw: int        #   the SW band's gas weights prm_sw later
    slots: int         # C: columns staged per block
    sets: int          # S: sets of sweep warps per block (S divides C)
    shared: bool       # staged in shared memory (else a device slice)
    threads: int       # threads per block
    guard_floats: int = 0  # guard words after each slot: the ring
                           # checker's build only (ops/cuda/ring_check.py)

    @property
    def col_floats(self) -> int:
        """The floats of one slot: what a column stages, then the guard."""
        return (self.lw_floats + self.sw_floats + self.acc_floats
                + self.prm_floats + self.guard_floats)

    @property
    def bytes_per_column(self) -> int:
        return 4 * self.col_floats

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory per block (0 on the device route)."""
        return self.slots * self.bytes_per_column if self.shared else 0


def band_gases(gas_plan: plan_mod.GasPlan) -> Tuple[int, int]:
    """(dense gases, LUT gases) of one band's gas plan."""
    nd = sum(sl.kind == plan_mod.KIND_DENSE for sl in gas_plan.slices)
    return nd, len(gas_plan.slices) - nd


def stage_plan(nlay: int, ngpt_lw: int, ngpt_sw: int, n_angles: int,
               gases_lw: Tuple[int, int], gases_sw: Tuple[int, int],
               block_shared: int, sm_shared: int, blocks_per_sm: int = 2,
               max_slots: int = MAX_SLOTS, sets: int = 1) -> StagePlan:
    """The staging of one launch of the kernel that solves the bands with
    ``ngpt_* > 0`` (both: lwsw.cu, LW only: lw.cu, SW only: sw.cu).

    Per column: LW 3 nlay rows at 1 angle (tr, src_dn, src_up), 3 nlay + 1
    at 2-4 (tau, layer and level Planck); SW 5 nlay + 2 rows; 2 (nlay+1)
    accumulators (up, down) per LW angle and 2 (nlay+1) for SW; and the
    layer parameters, 4 + with LW 4 Planck words, per band 1 per dense and
    3 per LUT gas (``gases_*``: ``band_gases``) per layer.  These go in
    the layer's first row of the band solved last (SW if present) when
    that band has <= 32 g-points (one g-chunk: the row is written only
    after they are read) and they fit there, else after the accumulators.

    ``block_shared`` and ``sm_shared`` are the card's shared memory per
    block (opt-in) and per SM, in bytes.  C, the columns staged per
    block, is the most, up to ``max_slots``, that fit in
    ``block_shared``; columns that do not fit alone are staged in device
    memory, ``max_slots`` per block.  S, the sets of sweep warps (one per
    LW angle and one SW each; set k sweeps slots k, k + S, ...), is the
    most, up to ``sets``, that divides C.  Threads per block: 1024 (64
    registers each) per SM, in ``blocks_per_sm`` blocks where that many
    fit in ``sm_shared`` and hold the S sets and one optics warp, else in
    half as many, down to one."""
    if not 1 <= max_slots <= SLOT_LIMIT:
        raise ValueError(f"max_slots must be in 1..{SLOT_LIMIT}")
    has_lw, has_sw = ngpt_lw > 0, ngpt_sw > 0
    prm_lw = 4 + gases_lw[0] + 3 * gases_lw[1] if has_lw else 0
    prm_sw = gases_sw[0] + 3 * gases_sw[1] if has_sw else 0
    lw_floats = (3 * nlay if n_angles == 1 else 3 * nlay + 1) * ngpt_lw
    sw_floats = (5 * nlay + 2) * ngpt_sw
    sweeps = (n_angles if has_lw else 0) + int(has_sw)
    acc_floats = 2 * sweeps * (nlay + 1)
    per_layer = 4 + prm_lw + prm_sw
    last = ngpt_sw if has_sw else ngpt_lw
    in_rows = last <= 32 and per_layer <= last
    plan = StagePlan(
        lw_floats=lw_floats, sw_floats=sw_floats, acc_floats=acc_floats,
        prm_floats=0 if in_rows else per_layer * nlay,
        prm_base=((lw_floats if has_sw else 0) if in_rows
                  else lw_floats + sw_floats + acc_floats),
        prm_stride=last if in_rows else per_layer, prm_sw=4 + prm_lw,
        slots=max_slots, sets=1, shared=True, threads=1024)
    fit = block_shared // plan.bytes_per_column
    slots = min(fit, max_slots) or max_slots
    sets = max(s for s in range(1, min(sets, slots) + 1) if slots % s == 0)
    plan = dataclasses.replace(plan, slots=slots, sets=sets,
                               shared=fit >= 1)
    blocks = blocks_per_sm
    while blocks > 1 and (
            1024 // blocks < 32 * (sets * sweeps + 1) or plan.shared
            and blocks * (plan.shared_bytes + RESERVED_SHARED_BYTES)
            > sm_shared):
        blocks //= 2
    return dataclasses.replace(plan, threads=1024 // blocks)


def tile_struct(plan: StagePlan, blocks: int = 0,
                stage: Optional[torch.Tensor] = None) -> binding.Tile:
    return binding.Tile(stage=0 if stage is None else stage.data_ptr(),
                        slots=plan.slots, sets=plan.sets, blocks=blocks,
                        threads=plan.threads,
                        shared_bytes=plan.shared_bytes,
                        col_floats=plan.col_floats,
                        lw_floats=plan.lw_floats, sw_floats=plan.sw_floats,
                        prm_base=plan.prm_base, prm_stride=plan.prm_stride,
                        prm_sw=plan.prm_sw)


def kernel_name(lw: Optional[plan_mod.LwInputs],
                sw: Optional[plan_mod.SwInputs]) -> str:
    """The kernel that solves these bands: "lwsw", "lw" or "sw"."""
    return "lwsw" if lw and sw else "lw" if lw else "sw"


def plan_for(atm: plan_mod.Atmosphere, lw: Optional[plan_mod.LwInputs],
             sw: Optional[plan_mod.SwInputs]) -> StagePlan:
    """``stage_plan`` for these inputs, on their card's shared memory, in
    their kernel's block shape (``SHAPES``)."""
    props = torch.cuda.get_device_properties(atm.tlay.device)
    blocks, slots, sets = SHAPES[kernel_name(lw, sw)]
    return stage_plan(atm.tlay.shape[1], lw.plan.ngpt if lw else 0,
                      sw.plan.ngpt if sw else 0,
                      lw.n_gauss_angles if lw else 1,
                      band_gases(lw.plan) if lw else (0, 0),
                      band_gases(sw.plan) if sw else (0, 0),
                      props.shared_memory_per_block_optin,
                      props.shared_memory_per_multiprocessor,
                      blocks_per_sm=blocks, max_slots=slots, sets=sets)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(name: str, shape: tuple, threads: int, shared_bytes: int,
                  fast: bool, device_index: int,
                  lib: Optional[ctypes.CDLL] = None) -> int:
    """The CUDA occupancy calculator's blocks per SM for a launch
    configuration of kernel ``name`` (``ecckd_<name>_occupancy``) on one
    card; ``shape`` (``launch_shape``) picks the instantiation, ``lib`` a
    bound build other than ``binding.library``'s."""
    args_type = binding.ARGS[name]
    lib = lib or binding.library(name, args_type)
    fn = getattr(lib, f"ecckd_{name}_occupancy")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    lw_shape, sw_shape, n_t = shape
    args = args_type(grid=binding.Grid(n_t=n_t),
                     tile=binding.Tile(slots=1, sets=1, threads=threads,
                                       shared_bytes=shared_bytes))
    for field, band in (("lw_band", lw_shape), ("sw_band", sw_shape),
                        ("band", lw_shape or sw_shape)):
        if hasattr(args, field):
            b = getattr(args, field)
            b.ngpt, b.ndense, b.nslice = band
    with torch.cuda.device(device_index):
        blocks = fn(ctypes.byref(args), int(fast))
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
              lib: Optional[ctypes.CDLL] = None) -> Tuple[StagePlan, int]:
    """(the staging plan, blocks per SM) of the launch of the kernel for
    these prepared bands (both: the merged kernel; one, the other None:
    its own) on their card; ``plan`` replaces ``plan_for``'s, ``lib``
    the kernel's build (``blocks_per_sm``)."""
    plan = plan or plan_for(atm, lw, sw)
    return plan, blocks_per_sm(kernel_name(lw, sw), launch_shape(lw, sw),
                               plan.threads, plan.shared_bytes,
                               (lw or sw).arrays.fast,
                               atm.tlay.device.index or 0, lib)


def run_staged(atm: plan_mod.Atmosphere, lw: Optional[plan_mod.LwInputs],
               sw: Optional[plan_mod.SwInputs], column_chunk: int, counted,
               plan: Optional[StagePlan] = None,
               max_blocks: Optional[int] = None,
               lib: Optional[ctypes.CDLL] = None):
    """Launch the staged kernel for the bands present (csrc/lwsw.cu,
    lw.cu or sw.cu) over column chunks on the current stream, in the
    bands' table mode: persistent blocks, as many as the card holds at
    once, on ``stage_plan``'s staging (a device slice per block where a
    column does not fit in shared memory; ``max_blocks`` caps them).
    Returns the (ncol, nlay+1) outputs, (up, down) per band, LW first.
    Launches count on ``counted`` (binding.launch_chunks).  ``lib``: a
    bound build of the kernel other than the plain one (the ring
    checker's, ops/cuda/ring_check.py); the launch paths pass none."""
    ncol, nlay = atm.tlay.shape
    name = kernel_name(lw, sw)
    dev = atm.tlay.device
    # The kernel writes every level of every column: no zero-fill.
    outs = [torch.empty((ncol, nlay + 1), dtype=torch.float32, device=dev)
            for _ in range(2 * ((lw is not None) + (sw is not None)))]
    if ncol == 0:
        return outs
    chunk = max(1, min(int(column_chunk), ncol))
    plan, per_sm = occupancy(atm, lw, sw, plan, lib)
    blocks = min(chunk, max_blocks or chunk, per_sm * torch.cuda.
                 get_device_properties(dev).multi_processor_count)
    stage = None if plan.shared else torch.empty(
        (blocks, plan.slots, plan.col_floats), dtype=torch.float32,
        device=dev)
    # The merged kernel shares one grid: the LW model's (mergeable pair);
    # a single-band kernel takes its model's own.
    grid = binding.grid_struct(lw or sw)
    tile = tile_struct(plan, blocks, stage)
    args_type = binding.ARGS[name]
    if lw and sw:
        bands = dict(lw_band=binding.band_struct(lw),
                     sw_band=binding.band_struct(sw))
    else:
        bands = dict(band=binding.band_struct(lw or sw))
    sw_outs = outs[2:] if lw else outs

    def make_args(c0: int, c1: int):
        solves = {}
        if lw:
            solves["lw"] = binding.lw_struct(lw, c0, c1, outs[0], outs[1])
        if sw:
            solves["sw"] = binding.sw_struct(sw, c0, c1, *sw_outs)
        return args_type(atm=binding.atmos_struct(atm, c0, c1), grid=grid,
                         tile=tile, **bands, **solves)

    binding.launch_chunks(name, args_type, ncol, chunk, make_args, counted,
                          dev, (lw or sw).arrays.fast, lib)
    return outs
