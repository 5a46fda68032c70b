"""Build and load the CUDA block kernels (``csrc/block_kernels.cu``).

The source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  The library lands in ``<checkout>/build/`` under a name keyed by
the source's hash, so an edited source is never served a stale build.
Nothing is compiled at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "block_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# what the last build reported: {"seconds", "ptxas", "path"} (None = cached)
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA block "
                       "kernels are compiled on first use")


def build() -> Path:
    """Compile the kernels if this source has no library yet; return its
    path.  Records the compile seconds and ptxas's register/shared-memory
    report in ``build_info``."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"block_kernels-{digest}.so"
    if out.is_file():
        build_info.update(seconds=None, ptxas="", path=str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas=proc.stderr, path=str(out))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.aihab_ln_gemm.argtypes = [p, i, p, p, p, i, p, p, p, i, i, i,
                                          i, f, f, i, i, p]
            lib.aihab_gemm_residual.argtypes = [p, p, i, p, p, i, p, i, i, i,
                                                i, p]
            lib.aihab_attention.argtypes = [p, p, i, i, i, i, i, i, f, p]
            for fn in (lib.aihab_ln_gemm, lib.aihab_gemm_residual,
                       lib.aihab_attention):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
