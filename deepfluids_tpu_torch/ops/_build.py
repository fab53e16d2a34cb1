"""Build and bind the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, for ``sm_90a`` (Hopper).  The build happens at first use, never at
import, into ``_build/<hash>/`` beside this package (listed in
``.gitignore``).  The hash covers the sources and the flags, so an edited
source is rebuilt and an unchanged one is reused.  The library is loaded with
``ctypes``; every entry point returns the ``cudaError_t`` of
``cudaGetLastError()`` after its launch.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the entry points: name -> (restype, argtypes).  Pointers
# and the stream are c_void_p; a plain int would cut them to 32 bits.  After
# the tensors, every entry point takes batch, H, W, dtype (0 f32 / 1 bf16),
# device and stream.
_TAIL = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "df_curl2d": (ctypes.c_int, [ctypes.c_void_p] * 2 + _TAIL),  # psi, out
    "df_jacobian2d": (ctypes.c_int,                      # vel, jac, vort
                      [ctypes.c_void_p] * 3 + _TAIL),
    "df_curl2d_bwd": (ctypes.c_int, [ctypes.c_void_p] * 2 + _TAIL),  # g, out
    "df_jacobian2d_bwd": (ctypes.c_int,                  # gj, gw, out
                          [ctypes.c_void_p] * 3 + _TAIL),
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
    """``_build/<hash of sources and flags>`` for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build() -> str:
    """Compile the library if this source hash has none yet; its path.

    nvcc writes to a temporary name that is renamed into place, so a
    concurrent process never loads a half-written library.  nvcc's own
    report (``-Xptxas -v``: registers, shared memory, spills) is kept as
    ``build.log`` beside the library."""
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
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
