"""Build the port's CUDA kernels at first use.

``nvcc`` compiles ``ecckd_tpu_torch/csrc/<name>.cu`` from the package's own
sources into a shared library with a plain C interface (loaded with
``ctypes``) under ``ecckd_tpu_torch/_build/``.  The file name carries a
hash of the source, of every header under ``csrc/`` (the kernels share
``common.cuh``) and of the flags, so an edited kernel or header is rebuilt
and an unchanged one is reused.  A failed build raises with nvcc's output;
there is no fallback.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 -std=c++17`` and no
fast-math (the kernels rely on IEEE-accurate expm1f/logf/divides).
``-Xptxas -v`` keeps the register/spill report next to the library
(``<lib>.ptxas.txt``).

``defines`` (``build(name, defines)``, ``load(name, defines)``) adds
``-D`` flags, for a diagnostic build of a kernel: ops/cuda/ring_check.py
builds the kernels with their ring-protocol checker this way.  The
defines enter the hash and the file name (``lib<name>-<define tags>-
<hash>.so``), so such a build never takes the place of the plain one,
which every launch path loads (``defines=()``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def define_flags(defines: Sequence[str]) -> Tuple[str, ...]:
    """``-D`` flags of ``defines`` (macro names), in the given order."""
    for d in defines:
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", d):
            raise ValueError(f"not a macro name: {d!r}")
    return tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes: keyed by a hash of the
    source, the headers it may include (every ``csrc/*.cuh``), the
    compiler flags and ``defines``, which also tag the file name."""
    flags = define_flags(defines)
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    tags = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tags}-{h.hexdigest()[:16]}.so"


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``defines``) unless the keyed
    library exists; returns its path.  Raises RuntimeError with nvcc's
    stderr on failure."""
    out = library_path(name, defines)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *define_flags(defines), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}.cu:\n{proc.stdout}\n{proc.stderr}")
    Path(f"{out}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent build never sees a stub
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, built with
    ``defines``."""
    return ctypes.CDLL(str(build(name, defines)))
