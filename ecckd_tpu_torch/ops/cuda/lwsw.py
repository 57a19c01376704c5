"""Merged longwave + shortwave solve: the CUDA kernel and its plain version.

``lwsw_fluxes_cuda`` is the port of the JAX package's
``ops/pallas/lwsw.py::lwsw_fluxes_fused`` (TPU kernel ``_lwsw_kernel``):
both bands' broadband fluxes for one atmosphere over one shared
(p, T) interpolation grid, ``top_at_1``, 1-4 LW Gauss angles.  It takes
CUDA tensors and launches ``csrc/lwsw.cu`` (float32 only), or raises.
``lwsw_fluxes_plain`` is the same computation in plain PyTorch, which takes
any dtype on any device and is what the kernel is tested against.

Both run on the same host preparation (ops/cuda/plan.py); the plain
version is ops/cuda/common.py's ``lw_plain`` + ``sw_plain``, the bodies
lw_fluxes_plain and sw_fluxes_plain run too, as the kernel runs
common.cuh's column bodies.  Returns (lw_up, lw_dn, sw_up, sw_dn), each
(ncol, nlay+1).

Both take ``mxu_mode``, the JAX package's mode string
(``config.set_mxu_precision``; None reads the current one at the call): in
the fast mode the plain version interpolates the bf16 table and the
wrapper launches the kernel's fast entry point (``fast_launches``).

The kernel stages each column's sweep coefficients (csrc/common.cuh "The
tiled merged solve"); ``stage_plan`` sizes that staging per launch, picks
the columns per block and whether it fits in shared memory or goes to a
device memory slice.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ecckd_tpu_torch import config
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops.cuda import binding, common, plan as plan_mod
from ecckd_tpu_torch.ops.cuda.binding import DEFAULT_COLUMN_CHUNK

Fluxes4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


RESERVED_SHARED_BYTES = 1024
"""Shared memory the CUDA runtime holds per block besides its own
(cudaDevAttrReservedSharedMemoryPerBlock, sm_80 and later)."""
MAX_SLOTS = 2
"""Columns staged per block: one swept while the next one's optics run."""


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """The merged kernel's staging for one launch (csrc/common.cuh "The
    tiled merged solve"), in float32 words per column."""
    lw_floats: int     # LW rows x ngpt_lw
    sw_floats: int     # SW rows x ngpt_sw
    acc_floats: int    # level accumulators, 2 (nlay+1) per LW angle and
                       # 2 (nlay+1) for SW
    prm_floats: int    # layer parameters in a place of their own, or 0
    prm_base: int      # layer j's parameters start at prm_base +
    prm_stride: int    #   j * prm_stride,
    prm_sw: int        #   the SW band's prm_sw later
    slots: int         # C: columns staged per block
    shared: bool       # staged in shared memory (else a device slice)
    threads: int       # threads per block

    @property
    def col_floats(self) -> int:
        return (self.lw_floats + self.sw_floats + self.acc_floats
                + self.prm_floats)

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
               block_shared: int, sm_shared: int) -> StagePlan:
    """Staging per column: LW 3 nlay rows at 1 angle (tr, src_dn, src_up),
    3 nlay + 1 at 2-4 (tau, layer and level Planck); SW 5 nlay + 2 rows;
    2 (nlay+1) accumulators (up, down) per LW angle and 2 (nlay+1) for
    SW; and the layer parameters, 4 + per band 1 per dense and 3 per LUT
    gas (``gases_*``: ``band_gases``) per layer.  These go in the layer's
    first SW row (r_dif) when they fit there and ngpt_sw <= 32 (one
    g-chunk: the row is written only after they are read), else after
    the accumulators.

    ``block_shared`` and ``sm_shared`` are the card's shared memory per
    block (opt-in) and per SM, in bytes.  C, the columns staged per
    block, is the most, up to ``MAX_SLOTS``, that fit in
    ``block_shared``; columns that do not fit alone are staged in device
    memory, ``MAX_SLOTS`` per block.  Threads per block: 1024 (64
    registers each) per SM, in two blocks of 512 where two fit in
    ``sm_shared``, else one."""
    prm_lw, prm_sw = (nd + 3 * nl for nd, nl in (gases_lw, gases_sw))
    lw_floats = (3 * nlay if n_angles == 1 else 3 * nlay + 1) * ngpt_lw
    sw_floats = (5 * nlay + 2) * ngpt_sw
    acc_floats = 2 * (n_angles + 1) * (nlay + 1)
    per_layer = 4 + prm_lw + prm_sw
    in_rows = ngpt_sw <= 32 and per_layer <= ngpt_sw
    plan = StagePlan(
        lw_floats=lw_floats, sw_floats=sw_floats, acc_floats=acc_floats,
        prm_floats=0 if in_rows else per_layer * nlay,
        prm_base=lw_floats if in_rows else lw_floats + sw_floats + acc_floats,
        prm_stride=ngpt_sw if in_rows else per_layer, prm_sw=4 + prm_lw,
        slots=MAX_SLOTS, shared=True, threads=512)
    fit = block_shared // plan.bytes_per_column
    plan = dataclasses.replace(plan, slots=min(fit, MAX_SLOTS) or MAX_SLOTS,
                               shared=fit >= 1)
    fits_two = (not plan.shared or 2 * (plan.shared_bytes
                                        + RESERVED_SHARED_BYTES) <= sm_shared)
    return dataclasses.replace(plan, threads=512 if fits_two else 1024)


class _Tile(ctypes.Structure):
    """Mirror of csrc/lwsw.cu's LwswTile."""
    _fields_ = ([("stage", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "slots", "blocks", "threads", "shared_bytes",
                    "col_floats", "lw_floats", "sw_floats", "prm_base",
                    "prm_stride", "prm_sw")])


class _Args(ctypes.Structure):
    """Mirror of csrc/lwsw.cu's LwswArgs."""
    _fields_ = [("atm", binding.Atmos), ("grid", binding.Grid),
                ("lw_band", binding.Band), ("sw_band", binding.Band),
                ("lw", binding.LwSolve), ("sw", binding.SwSolve),
                ("tile", _Tile)]


def tile_struct(plan: StagePlan, blocks: int = 0,
                stage: Optional[torch.Tensor] = None) -> _Tile:
    return _Tile(stage=0 if stage is None else stage.data_ptr(),
                 slots=plan.slots, blocks=blocks, threads=plan.threads,
                 shared_bytes=plan.shared_bytes, col_floats=plan.col_floats,
                 lw_floats=plan.lw_floats, sw_floats=plan.sw_floats,
                 prm_base=plan.prm_base, prm_stride=plan.prm_stride,
                 prm_sw=plan.prm_sw)


def _plan_for(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
              sw: plan_mod.SwInputs) -> StagePlan:
    """``stage_plan`` for these inputs, on their card's shared memory."""
    props = torch.cuda.get_device_properties(atm.tlay.device)
    return stage_plan(atm.tlay.shape[1], lw.plan.ngpt, sw.plan.ngpt,
                      lw.n_gauss_angles, band_gases(lw.plan),
                      band_gases(sw.plan), props.shared_memory_per_block_optin,
                      props.shared_memory_per_multiprocessor)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(threads: int, shared_bytes: int, fast: bool,
                   device_index: int) -> int:
    """The CUDA occupancy calculator's blocks per SM for a launch
    configuration (``ecckd_lwsw_occupancy``), on one card."""
    lib = binding.library("lwsw", _Args)
    lib.ecckd_lwsw_occupancy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ecckd_lwsw_occupancy.restype = ctypes.c_int
    args = _Args(tile=_Tile(threads=threads, shared_bytes=shared_bytes))
    with torch.cuda.device(device_index):
        blocks = lib.ecckd_lwsw_occupancy(ctypes.byref(args), int(fast))
    if blocks <= 0:
        raise RuntimeError(f"ecckd_lwsw_occupancy: {threads} threads with "
                           f"{shared_bytes} B of shared memory do not fit")
    return blocks


def occupancy(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
              sw: plan_mod.SwInputs) -> Tuple[StagePlan, int]:
    """(the staging plan, blocks per SM) of the merged kernel's launch on
    these inputs, on their card."""
    plan = _plan_for(atm, lw, sw)
    dev = atm.tlay.device
    return plan, _blocks_per_sm(plan.threads, plan.shared_bytes,
                                lw.arrays.fast, dev.index or 0)


def _kernel_core(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
                 sw: plan_mod.SwInputs, column_chunk: int) -> Fluxes4:
    """Launch csrc/lwsw.cu over column chunks on the current stream, in
    the bands' table mode (both in one mode: plan.prepare): persistent
    blocks, as many as the card holds at once, on ``stage_plan``'s
    staging (a device slice per block where a column does not fit in
    shared memory)."""
    ncol, nlay = atm.tlay.shape
    fast = lw.arrays.fast
    lw_t, lw_s = binding.lw_shapes(lw, ncol, nlay, "lw_")
    sw_t, sw_s = binding.sw_shapes(sw, ncol, "sw_")
    binding.check_inputs("lwsw", atm, {**lw_t, **sw_t}, {**lw_s, **sw_s},
                         fast)
    dev = atm.tlay.device
    # The kernel writes every level of every column: no zero-fill.
    outs = [torch.empty((ncol, nlay + 1), dtype=torch.float32, device=dev)
            for _ in range(4)]
    if ncol == 0:
        return tuple(outs)
    chunk = max(1, min(int(column_chunk), ncol))
    plan, per_sm = occupancy(atm, lw, sw)
    blocks = min(chunk, per_sm * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    stage = None if plan.shared else torch.empty(
        (blocks, plan.slots, plan.col_floats), dtype=torch.float32,
        device=dev)
    # The merged kernel shares one grid: the LW model's (mergeable pair).
    grid = binding.grid_struct(lw)
    lw_band, sw_band = binding.band_struct(lw), binding.band_struct(sw)
    tile = tile_struct(plan, blocks, stage)

    def make_args(c0: int, c1: int) -> _Args:
        return _Args(atm=binding.atmos_struct(atm, c0, c1), grid=grid,
                     lw_band=lw_band, sw_band=sw_band,
                     lw=binding.lw_struct(lw, c0, c1, outs[0], outs[1], None),
                     sw=binding.sw_struct(sw, c0, c1, outs[2], outs[3], None),
                     tile=tile)

    binding.launch_chunks("lwsw", _Args, ncol, chunk, make_args,
                          lwsw_fluxes_cuda, dev, fast)
    return tuple(outs)


def _plain_core(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
                sw: plan_mod.SwInputs) -> Fluxes4:
    return (*common.lw_plain(atm, lw), *common.sw_plain(atm, sw))


def _night_masked(sw: plan_mod.SwInputs, fluxes: Fluxes4) -> Fluxes4:
    lw_up, lw_dn, sw_up, sw_dn = fluxes
    return (lw_up, lw_dn, *common.night_masked(sw, sw_up, sw_dn))


def lwsw_fluxes_plain(model_lw: CKDModel, model_sw: CKDModel,
                      plev: torch.Tensor, tlay: torch.Tensor,
                      tlev: torch.Tensor, tsfc: torch.Tensor,
                      emis_gpt: torch.Tensor, gas_concs: GasConcs,
                      sfc_alb: torch.Tensor, tsi: torch.Tensor,
                      sza_deg: torch.Tensor, n_gauss_angles: int = 1,
                      mxu_mode: Optional[str] = None) -> Fluxes4:
    """The kernel's computation in plain PyTorch, in tlay's dtype on
    tlay's device.  Arguments as ``lwsw_fluxes_cuda``."""
    atm, lw, sw = plan_mod.prepare(model_lw, model_sw, plev, tlay, tlev,
                                   tsfc, emis_gpt, gas_concs, sfc_alb, tsi,
                                   sza_deg, n_gauss_angles,
                                   config.is_fast(mxu_mode))
    return _night_masked(sw, _plain_core(atm, lw, sw))


def lwsw_fluxes_cuda(model_lw: CKDModel, model_sw: CKDModel,
                     plev: torch.Tensor, tlay: torch.Tensor,
                     tlev: torch.Tensor, tsfc: torch.Tensor,
                     emis_gpt: torch.Tensor, gas_concs: GasConcs,
                     sfc_alb: torch.Tensor, tsi: torch.Tensor,
                     sza_deg: torch.Tensor, n_gauss_angles: int = 1,
                     column_chunk: int = DEFAULT_COLUMN_CHUNK,
                     mxu_mode: Optional[str] = None) -> Fluxes4:
    """Both bands' broadband fluxes through the merged CUDA kernel.

    Args mirror pipeline.lw_sw_fluxes with the surface already per g-point:
      emis_gpt: (ncol, ngpt_lw) emissivity; sfc_alb: (ncol,) or
      (ncol, ngpt_sw) albedo; tsi (ncol,) [W m-2]; sza_deg (ncol,).
      column_chunk: columns per launch.  The kernel's staging does not
        grow with it: shared memory, or for a column too deep for that
        (``stage_plan``: nlay >~ 250 at 32 + 27 g-points) a device slice
        per persistent block.
      mxu_mode: table mode (None: config's, read now); the fast mode
        launches the fast entry point.

    Takes float32 CUDA tensors and launches the kernel; anything else
    raises (ValueError), CPU tensors and inputs that require grad
    included: ``lwsw_fluxes_plain`` is the version for those.  Each launch
    adds one to ``lwsw_fluxes_cuda.launches`` (exact) or
    ``lwsw_fluxes_cuda.fast_launches`` (fast).
    """
    binding.require_cuda("lwsw_fluxes_cuda", tlay, plev, tlev, tsfc,
                         emis_gpt, gas_concs, sfc_alb, tsi, sza_deg)
    atm, lw, sw = plan_mod.prepare(model_lw, model_sw, plev, tlay, tlev,
                                   tsfc, emis_gpt, gas_concs, sfc_alb, tsi,
                                   sza_deg, n_gauss_angles,
                                   config.is_fast(mxu_mode))
    return _night_masked(sw, _kernel_core(atm, lw, sw, column_chunk))


lwsw_fluxes_cuda.launches = 0
lwsw_fluxes_cuda.fast_launches = 0
