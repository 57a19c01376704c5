"""ctypes binding to the native netCDF3 engine (counterpart of
``ecckd_tpu.io.nc3_native``).

The engine is the repository's C++ netCDF3 reader and writer,
``native/ecckd_io/`` (``nc3.cc``, ``nc3_capi.cc``): the counterpart of the
netCDF-C stack the reference links against.  The port builds it from
those sources with the host C++ compiler at first use, with
``native/Makefile``'s flags, into ``ecckd_tpu_torch/_build/``; the file
name carries a hash of the sources, the header and the flags, and a build
lands by an atomic rename, so concurrent processes never load a partial
file.  ``native/build/`` (``make -C native``, the JAX package's) is
neither read nor written.

It is optional: with no C++ compiler (``$CXX``, ``g++`` or ``c++``) or no
sources, ``load_library`` returns None and io/rfmip.py's ``_NcFile`` and
models/loader.py read and write with scipy instead.  Which engine ran is
never hidden: ``io.rfmip.io_engine`` names it, and the RFMIP drivers'
``--metrics-json`` records it.  A compiler that fails on the sources
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parents[2] / "native" / "ecckd_io"
SOURCES = ("nc3.cc", "nc3_capi.cc")
HEADER = "nc3.h"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")   # native/Makefile

NC_TYPES = {"b": 1, "c": 2, "h": 3, "i": 4, "f": 5, "d": 6}
NP_OF_NC = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.int32,
            5: np.float32, 6: np.float64}

_lib = None
_lock = threading.Lock()


def compiler() -> Optional[str]:
    """The host C++ compiler: $CXX, g++ or c++ on PATH; None if absent."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


def library_path() -> Path:
    """Where the engine's build goes: keyed by a hash of the sources, the
    header and the flags."""
    h = hashlib.sha256()
    for name in (*SOURCES, HEADER):
        h.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes()
                 + b"\0")
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libecckd_io-{h.hexdigest()[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the engine unless its keyed library exists; returns the
    path.  Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(SOURCE_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the netCDF3 engine failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a stub
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The engine, built at first use; None if it cannot be built here (no
    C++ compiler, or no sources)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = compiler()
        if cxx is None or not all((SOURCE_DIR / s).is_file()
                                  for s in (*SOURCES, HEADER)):
            return None
        lib = ctypes.CDLL(str(build(cxx)))
        _bind(lib)
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    """argtypes/restype of the C API (native/ecckd_io/nc3_capi.cc)."""
    vp, ip, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    ll, dp = ctypes.c_longlong, ctypes.POINTER(ctypes.c_double)
    sig = {
        "nc3_open": (vp, [cp]), "nc3_close": (None, [vp]),
        "nc3_error": (cp, []), "nc3_num_dims": (ip, [vp]),
        "nc3_dim_name": (cp, [vp, ip]), "nc3_dim_size": (ll, [vp, ip]),
        "nc3_num_vars": (ip, [vp]), "nc3_var_name": (cp, [vp, ip]),
        "nc3_var_id": (ip, [vp, cp]), "nc3_var_ndims": (ip, [vp, ip]),
        "nc3_var_type": (ip, [vp, ip]),
        "nc3_var_shape": (None, [vp, ip, ctypes.POINTER(ll)]),
        "nc3_read_var_double": (ip, [vp, ip, dp]),
        "nc3_get_att_text": (ip, [vp, ip, cp, cp, ip]),
        "nc3_get_att_double": (ip, [vp, ip, cp, dp, ip]),
        "nc3w_create": (vp, [cp]), "nc3w_def_dim": (ip, [vp, cp, ll]),
        "nc3w_def_var": (ip, [vp, cp, ip, ip, ctypes.POINTER(ip)]),
        "nc3w_put_att_text": (None, [vp, ip, cp, cp]),
        "nc3w_put_var_double": (ip, [vp, ip, dp, ll]),
        "nc3w_finish": (ip, [vp]),
        "nc3_update_var_double": (ip, [cp, cp, dp, ll]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError("the native netCDF3 engine cannot be built here "
                           "(no C++ compiler or no native/ sources)")
    return lib


def _doubles(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeReader:
    """Read-only netCDF3 file through the native engine."""

    def __init__(self, path: str):
        lib = _require()
        self._lib = lib
        self._h = lib.nc3_open(str(path).encode())
        if not self._h:
            raise OSError(lib.nc3_error().decode())
        self.dimensions: Dict[str, int] = {
            lib.nc3_dim_name(self._h, i).decode():
            int(lib.nc3_dim_size(self._h, i))
            for i in range(lib.nc3_num_dims(self._h))}
        self.var_names = [lib.nc3_var_name(self._h, i).decode()
                          for i in range(lib.nc3_num_vars(self._h))]

    def close(self) -> None:
        if self._h:
            self._lib.nc3_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def has_var(self, name: str) -> bool:
        return self._lib.nc3_var_id(self._h, name.encode()) >= 0

    def var_shape(self, name: str):
        vid = self._vid(name)
        nd = self._lib.nc3_var_ndims(self._h, vid)
        shape = (ctypes.c_longlong * max(nd, 1))()
        self._lib.nc3_var_shape(self._h, vid, shape)
        return tuple(int(shape[i]) for i in range(nd))

    def var_ndims(self, name: str) -> int:
        return self._lib.nc3_var_ndims(self._h, self._vid(name))

    def read(self, name: str) -> np.ndarray:
        """Variable data as float64 in its file shape."""
        vid = self._vid(name)
        shape = self.var_shape(name)
        out = np.empty(int(np.prod(shape)) if shape else 1, np.float64)
        if self._lib.nc3_read_var_double(self._h, vid, _doubles(out)) != 0:
            raise OSError(self._lib.nc3_error().decode())
        return out.reshape(shape)

    def var_type(self, name: str) -> int:
        """netCDF3 external type code of a variable (NC_TYPES values)."""
        return int(self._lib.nc3_var_type(self._h, self._vid(name)))

    def read_exact(self, name: str) -> np.ndarray:
        """Variable data in its FILE dtype: the engine decodes to float64,
        and the conversion back is lossless for every netCDF3 external
        type, so the values equal a scipy read bit for bit."""
        return self.read(name).astype(NP_OF_NC[self.var_type(name)])

    def att_text(self, var: Optional[str], name: str) -> Optional[str]:
        """A text attribute of ``var`` (None: global), or None if absent."""
        vid = -1 if var is None else self._vid(var)
        n = self._lib.nc3_get_att_text(self._h, vid, name.encode(), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n + 1)
        self._lib.nc3_get_att_text(self._h, vid, name.encode(), buf, n + 1)
        return buf.value.decode()

    def _vid(self, name: str) -> int:
        vid = self._lib.nc3_var_id(self._h, name.encode())
        if vid < 0:
            raise KeyError(f"no variable {name!r}")
        return vid


class NativeWriter:
    """Create a netCDF3 (CDF-2) file through the native engine."""

    def __init__(self, path: str):
        self._lib = _require()
        self._w = self._lib.nc3w_create(str(path).encode())
        self._dims: Dict[str, int] = {}
        self._vars: Dict[str, int] = {}

    def def_dim(self, name: str, size: int) -> int:
        self._dims[name] = self._lib.nc3w_def_dim(self._w, name.encode(),
                                                  size)
        return self._dims[name]

    def def_var(self, name: str, typecode: str,
                dims: Sequence[str]) -> int:
        ids = (ctypes.c_int * len(dims))(*[self._dims[d] for d in dims])
        vid = self._lib.nc3w_def_var(self._w, name.encode(),
                                     NC_TYPES[typecode], len(dims), ids)
        self._vars[name] = vid
        return vid

    def put_att(self, var: Optional[str], name: str, value: str) -> None:
        vid = -1 if var is None else self._vars[var]
        self._lib.nc3w_put_att_text(self._w, vid, name.encode(),
                                    str(value).encode())

    def put_var(self, name: str, data: np.ndarray) -> None:
        arr = np.ascontiguousarray(data, np.float64)
        if self._lib.nc3w_put_var_double(self._w, self._vars[name],
                                         _doubles(arr), arr.size) != 0:
            raise OSError(self._lib.nc3_error().decode())

    def finish(self) -> None:
        rc = self._lib.nc3w_finish(self._w)
        self._w = None
        if rc != 0:
            raise OSError(self._lib.nc3_error().decode())


def update_var(path: str, name: str, data: np.ndarray) -> None:
    """Overwrite an existing variable in place (template fill, as the
    reference's unblock_and_write; mo_rfmip_io.F90:288-317)."""
    lib = _require()
    arr = np.ascontiguousarray(data, np.float64)
    if lib.nc3_update_var_double(str(path).encode(), name.encode(),
                                 _doubles(arr), arr.size) != 0:
        raise OSError(lib.nc3_error().decode())
