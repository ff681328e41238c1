"""Build and load the port's CUDA kernels (``csrc/*.cu``, headers ``csrc/*.cuh``).

Every source compiles with ``nvcc`` for ``sm_90a``, one ``nvcc`` process per
source, all started together; the objects link into one shared library with
a plain C interface, loaded with ctypes. The library lands in
``build/velocity_tpu_torch/`` at the repository root, named by a hash of the
sources, headers and flags, so an edited kernel or header is rebuilt and an
unchanged one is reused. Nothing builds at import: the first wrapper that
launches a kernel calls ``library()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "velocity_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = [*ARCH, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# (restype, argtypes) of every exported C function; pointers and the stream
# are c_void_p so that 64-bit addresses are not cut to int. vt_lk_block's
# masks (trackable, done in, done out) and vt_source_window's trackable
# point at torch.bool bytes.
SIGNATURES = {
    "vt_extract_slabs": (_I, [_P, _I, _I, _P, _I, _I, _P, _P, _P]),
    "vt_extract_slabs_batched": (_I, [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P]),
    "vt_extract_patches": (_I, [_P, _I, _I, _P, _I, _I, _P, _P, _P]),
    "vt_extract_patches_batched": (_I, [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P]),
    "vt_lk_block": (_I, [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P]),
    "vt_corner_subpix": (_I, [_P, _I, _P, _P, _I, _I, _I, _F, _P, _P, _P]),
    "vt_extract_warped": (_I, [_P, _I, _I, _I, _I, _P, _L, _L, _P, _I, _I, _I, _I, _I,
                               _P, _P, _P]),
    "vt_source_window": (_I, [_P, _I, _I, _I, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _F,
                              _I, _I, _P, _P, _P, _P]),
}

_lib = None
build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _sources() -> list[Path]:
    """The translation units nvcc compiles."""
    return sorted(SRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of velocity_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libvt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = _sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        build_log = "".join(proc.communicate()[0] for proc in procs)  # waits for each
        failed = [src.name for src, proc in zip(srcs, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{build_log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
