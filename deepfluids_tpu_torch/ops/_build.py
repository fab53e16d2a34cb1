"""Build and bind the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (with the ``*.cuh`` headers they
include), one process per source in parallel, and links them into one
shared library with a plain C interface, for ``sm_90a`` (Hopper).  The
build happens at first use, never at import, into ``_build/<hash>/``
beside this package (listed in ``.gitignore``).  The hash covers the
sources, headers and flags, so an edited source is rebuilt and an
unchanged one is reused.  The library is loaded with ``ctypes``; every
entry point returns the ``cudaError_t`` of ``cudaGetLastError()`` after its
launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libdf_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the entry points: name -> (restype, argtypes).  Pointers
# and the stream are c_void_p; a plain int would cut them to 32 bits.  After
# the tensors, every entry point takes batch, its spatial extents (H, W in
# 2D; D, H, W in 3D), dtype (0 f32 / 1 bf16), device and stream.
_TAIL2 = [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_TAIL3 = [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIGNATURES = {
    "df_curl2d": (ctypes.c_int, [ctypes.c_void_p] * 2 + _TAIL2),  # psi, out
    "df_jacobian2d": (ctypes.c_int,                      # vel, jac, vort
                      [ctypes.c_void_p] * 3 + _TAIL2),
    "df_curl2d_bwd": (ctypes.c_int, [ctypes.c_void_p] * 2 + _TAIL2),  # g, out
    "df_jacobian2d_bwd": (ctypes.c_int,                  # gj, gw, out
                          [ctypes.c_void_p] * 3 + _TAIL2),
    "df_curl3d": (ctypes.c_int, [ctypes.c_void_p] * 2 + _TAIL3),  # psi, out
    "df_jacobian3d": (ctypes.c_int,                      # vel, jac, vort
                      [ctypes.c_void_p] * 3 + _TAIL3),
    "df_curl3d_bwd": (ctypes.c_int, [ctypes.c_void_p] * 2 + _TAIL3),  # g, out
    "df_jacobian3d_bwd": (ctypes.c_int,                  # gj, gv, out
                          [ctypes.c_void_p] * 3 + _TAIL3),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, the standard toolkit location, or PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_dir() -> str:
    """``_build/<hash of sources, headers and flags>`` for the current
    sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_sources()
                      + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build() -> str:
    """Compile the library if this source hash has none yet; its path.

    Each source is compiled to an object by its own nvcc, all started
    together, then one nvcc links them.  Everything is written in a
    temporary directory and the library renamed into place, so a concurrent
    process never loads a half-written one.  nvcc's own report (``-Xptxas
    -v``: registers, shared memory, spills) is kept as ``build.log`` beside
    the library."""
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        nvcc = find_nvcc()
        jobs = []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        link = [nvcc, "-shared", "-o", os.path.join(work, LIB_NAME),
                *(obj for _, obj, _ in jobs)]
        log = []
        for cmd, _, proc in jobs:     # wait for every compile first
            log.append((cmd, proc.communicate()[0], proc.returncode))
        for cmd, out, rc in log:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                                   f"{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            for cmd, out, _ in log:
                f.write(" ".join(cmd) + "\n" + out)
            f.write(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        os.replace(os.path.join(work, LIB_NAME), lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib
