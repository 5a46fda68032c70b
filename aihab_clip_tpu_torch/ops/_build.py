"""Build and load the CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library of its own with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds, and the sources build in parallel (one ``nvcc`` each, all
started together).  A library lands in ``<checkout>/build/`` under a name
keyed by the hash of its source and of every header in ``csrc/``
(``common.cuh``; ``hopper.cuh``, the TMA, mbarrier and wgmma helpers), so
an edited source or header is never served a stale build.  Nothing is
compiled at import: the first kernel launch builds.  The TMA tensor maps
are encoded on the host through the runtime's driver entry point, so the
libraries link against cudart alone.

  block_kernels.cu       the TMA + wgmma GEMM behind ln_gemm (after an LN row
                         pass) and gemm_residual (K1-K5, K7, K16, K17), the
                         TMA + wgmma flash attention (K1, K2, K5, K6 fwd in
                         bf16; K13's grouped attention in fp32; K12's and
                         K14's with P normalised, in fp32; head_dim 64, 72,
                         88, 104), act_pass (the gelu_poly forms past the GEMM
                         epilogues), the train MLP's backward row kernel (K17)
  fused_attention_bwd.cu fused_attention's backward (K6b): TMA + wgmma dq and
                         dk/dv kernels
  quant_kernels.cu       row_quant, the TMA + wgmma int8_gemm (K8-K15; its
                         quantized output for K9, K11, K14, K15)
  preprocess.cu          normalize_u8 (K18)
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

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("block_kernels", "fused_attention_bwd", "quant_kernels",
           "preprocess")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# each C entry point's argument types (every one returns a CUDA error code)
_ARGTYPES = {
    "block_kernels": {
        "aihab_ln_gemm": [_p, _i, _p, _p, _p, _i, _p, _p, _i, _p, _i, _i, _i,
                          _i, _f, _f, _i, _i, _p],
        "aihab_act_pass": [_p, _i, _p, _i, _p, _i, _i, _p],
        "aihab_gemm_residual": [_p, _p, _i, _p, _p, _p, _i, _p, _i, _i, _i,
                                _i, _p],
        "aihab_attention": [_p, _p, _i, _i, _i, _i, _i, _i, _f, _i, _i, _p],
        "aihab_fused_attention_fwd": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _f,
                                      _p],
        "aihab_mlp_train_fwd": [_p] * 11 + [_i, _i, _i, _f, _p],
        "aihab_mlp_train_bwd": [_p] * 10 + [_i, _i, _i, _f, _p],
        "aihab_gemm_plan": [_i, _i, _i, _p],
        "aihab_flash_plan": [_i, _i, _i, _i, _i, _p],
    },
    "fused_attention_bwd": {
        "aihab_fused_attention_bwd": [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
                                      _i, _i, _i, _i, _f, _p],
        "aihab_fused_attention_bwd_plan": [_i, _i, _i, _i, _p],
    },
    "quant_kernels": {
        "aihab_row_quant": [_p, _i, _i, _i, _i, _i, _p, _p, _f, _p, _p, _p],
        "aihab_int8_gemm": [_p, _p, _p, _p, _p, _p, _p, _i, _p, _i, _i, _i, _i,
                            _i, _i, _i, _f, _i, _i, _p],
        "aihab_int8_gemm_qout": [_p] * 5 + [_i] * 4 + [_p] * 3 + [_i] * 3
                                + [_p],
        "aihab_int8_gemm_plan": [_i, _i, _i, _i, _i, _p],
    },
    "preprocess": {
        "aihab_normalize_u8": [_p, _p, _i, _ll, _f, _f, _f, _f, _f, _f, _p],
    },
}

_SOURCE_OF = {fn: src for src, fns in _ARGTYPES.items() for fn in fns}

_lock = threading.Lock()
_libs: dict = {}
# what each source's last build reported: {"seconds", "ptxas", "path"}
# (seconds None = served from the cache)
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are compiled on first use")


def _library_path(name: str) -> Path:
    """The library of source ``name``, keyed by the hash of the source and
    of every header in ``csrc/`` (any of which it may include)."""
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source that has no library yet, all at once; return
    {source name: library path}.  Records each build's seconds and ptxas's
    register/shared-memory report in ``build_info``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in SOURCES}
    procs = {}
    t0 = time.perf_counter()
    for name, out in paths.items():
        if out.is_file():
            build_info[name] = dict(seconds=None, ptxas="", path=str(out))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, paths[name])
        build_info[name] = dict(seconds=time.perf_counter() - t0, ptxas=err,
                                path=str(paths[name]))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths


def library(name: str = "block_kernels") -> ctypes.CDLL:
    """The loaded library of source ``name`` (every source is built on the
    first call)."""
    with _lock:
        if not _libs:
            for src, path in build().items():
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in _ARGTYPES[src].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[src] = lib
        return _libs[name]


def launch(fn: str, device, *args) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current stream of
    ``device``, with ``device`` current; raise on the CUDA error code it
    returns."""
    import torch

    lib = library(_SOURCE_OF[fn])
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args, stream)  # (the device switch costs µs)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
