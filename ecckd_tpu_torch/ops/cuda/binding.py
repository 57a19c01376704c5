"""ctypes binding shared by the three kernel wrappers (lwsw.py, lw.py,
sw.py).

* Mirrors of ``csrc/common.cuh``'s structs (``GasSlice``, ``Band``,
  ``Grid``, ``Atmos``, ``LwSolve``, ``SwSolve``), of ``csrc/staged.cuh``'s
  staging plan ``Tile`` and of the three kernels' argument structs composed
  of them (``LwswArgs``, ``LwArgs``, ``SwArgs``: ``ARGS``); ``library``
  checks each one's size against the C side's ``ecckd_<name>_args_size()``
  before the first launch.
* Functions that fill them from the host preparation (ops/cuda/plan.py)
  for the columns [c0, c1) of one launch.
* ``require_cuda`` / ``grad_refusal``: a wrapper raises on CPU tensors
  and on inputs that require grad (the kernels define no backward);
  ``check_inputs``: device, float32, contiguity and shape checks that
  raise on what a kernel does not take.
* ``launch_chunks``: the launch loop over column chunks, which raises on a
  non-zero ``cudaGetLastError()`` and counts launches per instantiation
  (``launches`` for the exact table, ``fast_launches`` for the fast
  mode's bf16 table; csrc/common.cuh "Table mode").

nvcc and the build are reached only from ``library``, at the first launch,
so the CPU tests import this module without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ecckd_tpu_torch import constants
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.ops.cuda import plan as plan_mod
from ecckd_tpu_torch.solvers.quadrature import gauss_angles

MAX_SLICES = 16  # csrc/common.cuh

DEFAULT_COLUMN_CHUNK = 65536
"""Columns per kernel launch.  The kernels' staging does not grow with it:
shared memory, or for columns too deep for that (ops/cuda/staged.py
stage_plan) a device slice per persistent block, whose count it caps."""


class GasSlice(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("row0", ctypes.c_int),
                ("vmr_kind", ctypes.c_int), ("vmr_idx", ctypes.c_int),
                ("n_mf", ctypes.c_int), ("a", ctypes.c_float),
                ("b", ctypes.c_float), ("mf0", ctypes.c_float),
                ("log_mf0", ctypes.c_float), ("d_log", ctypes.c_float),
                ("v_hi", ctypes.c_float)]


class Band(ctypes.Structure):
    # table: float32, or bfloat16 in the fast mode (a void pointer in C).
    _fields_ = [("table", ctypes.c_void_p), ("ngpt", ctypes.c_int),
                ("nslice", ctypes.c_int), ("ndense", ctypes.c_int),
                ("s", GasSlice * MAX_SLICES)]


class Grid(ctypes.Structure):
    _fields_ = ([("t_first", ctypes.c_void_p), ("n_p", ctypes.c_int),
                 ("n_t", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in ("log_p0", "d_log_p", "p_hi",
                                                 "dt", "t_hi")])


class Atmos(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("plev", "tlay", "vmr_prof",
                                                "vmr_scal")]
                + [(n, ctypes.c_int) for n in ("ncol", "nlay", "n_prof",
                                               "n_scal")])


class LwSolve(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("tlev", "tsfc", "emis",
                                                "planck", "up", "dn")]
                + [("n_planck", ctypes.c_int), ("n_ang", ctypes.c_int),
                   ("planck_t0", ctypes.c_float),
                   ("planck_dt", ctypes.c_float),
                   ("sec", ctypes.c_float * 4), ("w2pi", ctypes.c_float * 4)])


class SwSolve(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("alb", "mu0", "tsi_scale",
                                               "solar", "ray", "up", "dn")]


class Tile(ctypes.Structure):
    """Mirror of csrc/staged.cuh's Tile (ops/cuda/staged.py stage_plan)."""
    _fields_ = ([("stage", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "slots", "sets", "blocks", "threads", "shared_bytes",
                    "col_floats", "lw_floats", "sw_floats", "prm_base",
                    "prm_stride", "prm_sw")])


class LwswArgs(ctypes.Structure):
    """Mirror of csrc/lwsw.cu's LwswArgs."""
    _fields_ = [("atm", Atmos), ("grid", Grid), ("lw_band", Band),
                ("sw_band", Band), ("lw", LwSolve), ("sw", SwSolve),
                ("tile", Tile)]


class LwArgs(ctypes.Structure):
    """Mirror of csrc/lw.cu's LwArgs."""
    _fields_ = [("atm", Atmos), ("grid", Grid), ("band", Band),
                ("lw", LwSolve), ("tile", Tile)]


class SwArgs(ctypes.Structure):
    """Mirror of csrc/sw.cu's SwArgs."""
    _fields_ = [("atm", Atmos), ("grid", Grid), ("band", Band),
                ("sw", SwSolve), ("tile", Tile)]


ARGS = {"lwsw": LwswArgs, "lw": LwArgs, "sw": SwArgs}


@functools.lru_cache(maxsize=None)
def library(name: str, args_type) -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/<name>.cu`` (``bind``): the plain
    build, with no defines, the only one a launch path loads.  Bound once
    per name, as ``build.load`` loads once: a launch finds the bound
    library in the cache."""
    from ecckd_tpu_torch.ops.cuda import build
    return bind(build.load(name), name, args_type)


def bind(lib: ctypes.CDLL, name: str, args_type) -> ctypes.CDLL:
    """Bind a build of ``csrc/<name>.cu`` (both entry points,
    ``ecckd_<name>_launch`` and ``..._launch_fast``), checking that its
    argument struct has the size of the ctypes mirror ``args_type``."""
    for entry in (f"ecckd_{name}_launch", f"ecckd_{name}_launch_fast"):
        launch = getattr(lib, entry)
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        launch.restype = ctypes.c_int
    size = getattr(lib, f"ecckd_{name}_args_size")
    size.argtypes = []
    size.restype = ctypes.c_int
    lib.ecckd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ecckd_cuda_error_string.restype = ctypes.c_char_p
    if size() != ctypes.sizeof(args_type):
        raise RuntimeError(
            f"{name} kernel argument layout mismatch: C {size()} bytes vs "
            f"ctypes {ctypes.sizeof(args_type)}")
    return lib


def band_struct(band: plan_mod.BandInputs) -> Band:
    slices = band.plan.slices
    if len(slices) > MAX_SLICES:
        raise ValueError(f"{len(slices)} contributing gases; the kernels "
                         f"take at most {MAX_SLICES}")
    ndense = sum(sl.kind == plan_mod.KIND_DENSE for sl in slices)
    if any(sl.kind == plan_mod.KIND_DENSE for sl in slices[ndense:]):
        raise ValueError("the kernels take a gas plan's dense gases first")
    out = Band(table=band.arrays.table.data_ptr(), ngpt=band.plan.ngpt,
               nslice=len(slices), ndense=ndense)
    for i, sl in enumerate(slices):
        vkind, vidx = (band.vmr_kinds[sl.vmr_slot] if sl.vmr_slot >= 0
                       else (plan_mod.VMR_NONE, 0))
        out.s[i] = GasSlice(kind=sl.kind, row0=sl.row0, vmr_kind=vkind,
                            vmr_idx=vidx, a=sl.a, b=sl.b)
        if sl.kind == plan_mod.KIND_LUT:
            # The constants of interp.vmr_index, rounded to float32 once.
            grid = sl.mf_grid
            out.s[i].n_mf = len(grid)
            out.s[i].mf0 = grid[0]
            out.s[i].log_mf0 = math.log(grid[0])
            out.s[i].d_log = math.log(grid[1] / grid[0])
            out.s[i].v_hi = len(grid) - 1.001
    return out


def grid_struct(band: plan_mod.BandInputs) -> Grid:
    """The band's own model's (p, T) grid."""
    arr = band.arrays
    return Grid(t_first=arr.t_first.data_ptr(), n_p=band.n_p, n_t=band.n_t,
                log_p0=arr.log_p0, d_log_p=arr.d_log_p,
                p_hi=band.n_p - 1.0001, dt=arr.dt, t_hi=band.n_t - 1.0001)


def atmos_struct(atm: plan_mod.Atmosphere, c0: int, c1: int) -> Atmos:
    return Atmos(plev=atm.plev[c0:c1].data_ptr(),
                 tlay=atm.tlay[c0:c1].data_ptr(),
                 vmr_prof=atm.vmr_prof[c0:c1].data_ptr(),
                 vmr_scal=atm.vmr_col[c0:c1].data_ptr(), ncol=c1 - c0,
                 nlay=atm.tlay.shape[1], n_prof=atm.vmr_prof.shape[1],
                 n_scal=atm.vmr_col.shape[1])


def lw_struct(lw: plan_mod.LwInputs, c0: int, c1: int, up: torch.Tensor,
              dn: torch.Tensor) -> LwSolve:
    arr = lw.arrays
    out = LwSolve(tlev=lw.tlev[c0:c1].data_ptr(),
                  tsfc=lw.tsfc[c0:c1].data_ptr(),
                  emis=lw.emis[c0:c1].data_ptr(),
                  planck=arr.planck_function.data_ptr(),
                  up=up[c0:c1].data_ptr(), dn=dn[c0:c1].data_ptr(),
                  n_planck=arr.planck_function.shape[0],
                  n_ang=lw.n_gauss_angles, planck_t0=arr.planck_t0,
                  planck_dt=arr.planck_dt)
    for a, (sec, wgt) in enumerate(zip(*gauss_angles(lw.n_gauss_angles))):
        out.sec[a] = sec
        out.w2pi[a] = 2.0 * constants.PI * wgt
    return out


def sw_struct(sw: plan_mod.SwInputs, c0: int, c1: int, up: torch.Tensor,
              dn: torch.Tensor) -> SwSolve:
    return SwSolve(alb=sw.alb[c0:c1].data_ptr(), mu0=sw.mu0[c0:c1].data_ptr(),
                   tsi_scale=sw.tsi_scale[c0:c1].data_ptr(),
                   solar=sw.arrays.solar.data_ptr(),
                   ray=sw.arrays.rayleigh.data_ptr(), up=up[c0:c1].data_ptr(),
                   dn=dn[c0:c1].data_ptr())


def grad_refusal(*inputs) -> Optional[str]:
    """Why a kernel must not run on these per-column inputs (tensors or
    GasConcs), or None: the kernels define no backward, so on an input
    that requires grad a launch would return fluxes cut from the autograd
    graph and every gradient through them would be silently zero."""
    if not torch.is_grad_enabled():
        return None
    for x in inputs:
        tensors = x.values if isinstance(x, GasConcs) else (x,)
        if any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in tensors):
            return ("an input requires grad and the kernels define no "
                    "backward; gradients run on backend='torch' (or "
                    "'auto', which takes it)")
    return None


def require_cuda(fn_name: str, tlay: torch.Tensor, *inputs) -> None:
    """A ``*_cuda`` wrapper launches its kernel or raises: it never runs
    the plain version in its place, and never runs on inputs that require
    grad (``grad_refusal``; ``inputs`` are the other per-column ones)."""
    refusal = grad_refusal(tlay, *inputs)
    if refusal is not None:
        raise ValueError(f"{fn_name}: {refusal}")
    if tlay.device.type != "cuda":
        raise ValueError(f"{fn_name} takes CUDA tensors; tlay is on "
                         f"{tlay.device} (the plain version is "
                         f"{fn_name[:-5]}_plain)")


def band_tensors(prefix: str, band: plan_mod.BandInputs
                 ) -> Dict[str, torch.Tensor]:
    """A band's model tensors, for check_inputs."""
    arr = band.arrays
    out = {f"{prefix}table": arr.table, f"{prefix}t_first": arr.t_first}
    for name in ("planck_function", "solar", "rayleigh"):
        if getattr(arr, name) is not None:
            out[prefix + name] = getattr(arr, name)
    return out


def check_inputs(kernel: str, atm: plan_mod.Atmosphere,
                 tensors: Dict[str, torch.Tensor],
                 shapes: Dict[str, Tuple[int, ...]],
                 fast: bool = False) -> None:
    """Raise unless every tensor is float32 (the tables bfloat16 if
    ``fast``), contiguous and on tlay's CUDA device, and ``tensors[name]``
    has ``shapes[name]``."""
    tensors = dict(plev=atm.plev, tlay=atm.tlay, vmr_prof=atm.vmr_prof,
                   vmr_col=atm.vmr_col, **tensors)
    device = atm.tlay.device
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                             f"expected one CUDA device ({device})")
        want = (torch.bfloat16 if fast and name.endswith("table")
                 else torch.float32)
        if t.dtype != want:
            raise ValueError(f"{kernel} kernel takes {want} {name}; it is "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} is not contiguous")
        if name.endswith("table") and t.numel() >= 2 ** 31:
            raise ValueError(f"{kernel} kernel: {name} exceeds 32-bit row "
                             "indexing")
    ncol, nlay = atm.tlay.shape
    shapes = dict(plev=(ncol, nlay + 1), **shapes)
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{kernel} kernel: {name} has shape "
                             f"{tuple(tensors[name].shape)}, expected {shape}")
    if atm.vmr_prof.shape[0] != ncol or atm.vmr_prof.shape[2] != nlay \
            or atm.vmr_col.shape[0] != ncol:
        raise ValueError(f"{kernel} kernel: vmr stacks do not match "
                         "(ncol, nlay)")


def lw_shapes(lw: plan_mod.LwInputs, ncol: int, nlay: int, prefix: str = ""):
    tensors = {prefix + "tlev": lw.tlev, prefix + "tsfc": lw.tsfc,
               prefix + "emis": lw.emis, **band_tensors(prefix, lw)}
    shapes = {prefix + "tlev": (ncol, nlay + 1), prefix + "tsfc": (ncol,),
              prefix + "emis": (ncol, lw.plan.ngpt)}
    return tensors, shapes


def sw_shapes(sw: plan_mod.SwInputs, ncol: int, prefix: str = ""):
    tensors = {prefix + "alb": sw.alb, prefix + "mu0": sw.mu0,
               prefix + "tsi_scale": sw.tsi_scale,
               **band_tensors(prefix, sw)}
    shapes = {prefix + "alb": (ncol, sw.plan.ngpt), prefix + "mu0": (ncol,),
              prefix + "tsi_scale": (ncol,)}
    return tensors, shapes


def launch_chunks(name: str, args_type, ncol: int, column_chunk: int,
                  make_args: Callable[[int, int], ctypes.Structure],
                  counted, device, fast: bool = False,
                  lib: Optional[ctypes.CDLL] = None) -> None:
    """Launch ``csrc/<name>.cu`` once per column chunk [c0, c1) on
    ``device``'s current stream, with the arguments ``make_args(c0, c1)``:
    the exact entry point, or ``..._launch_fast`` if ``fast``.  Each launch
    adds one to ``counted.launches`` (``counted.fast_launches`` if
    ``fast``).  The launch runs with ``device`` as the host thread's
    current device: the runtime launches on the current device, and
    another card's stream there is an error.  ``lib``: a bound build of
    the kernel (``bind``) in place of ``library``'s."""
    lib = lib or library(name, args_type)
    suffix = "_fast" if fast else ""
    launch = getattr(lib, f"ecckd_{name}_launch{suffix}")
    counter = "fast_launches" if fast else "launches"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for c0 in range(0, ncol, column_chunk):
            args = make_args(c0, min(c0 + column_chunk, ncol))
            rc = launch(ctypes.byref(args), stream)
            if rc != 0:
                raise RuntimeError(
                    f"{name}{suffix} kernel launch failed: CUDA error {rc} "
                    f"({lib.ecckd_cuda_error_string(rc).decode()})")
            setattr(counted, counter, getattr(counted, counter) + 1)
