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
  jpeg_pixels.cu         the fast JPEG decode's pixel stage: jpeg_idct (J1),
                         jpeg_color_resize (J2)

The host sources compile the same way with the host C++ compiler (``$CXX``,
else ``c++``; ``-O2``, no ``-march=native``, no ``-ffast-math``) and run on
the CPU too: ``host_library`` builds one alone, without ``nvcc``.

  jpeg_entropy.cpp       the fast JPEG decode's entropy stage (Huffman and
                         arithmetic coding; and the fixture tool's QM
                         encoder)
  zstd_decode.cpp        the zstd decoder (orbax checkpoints, ops/zstd.py)
  blosc_lz4.cpp          LZ4 blocks and blosc1 frames (the zarr cache store,
                         ops/blosc.py)
  A build that fails, or
a compiler that is missing, raises; nothing falls back.
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
           "preprocess", "jpeg_pixels")
HOST_SOURCES = ("jpeg_entropy", "zstd_decode", "blosc_lz4")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

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
    "jpeg_pixels": {
        "aihab_jpeg_idct": [_p, _p, _p, _p, _i, _ll, _p],
        "aihab_jpeg_color_resize": [_p, _p, _p, _p, _p, _i, _i, _p],
        "aihab_jpeg_color_resize_cmyk": [_p, _p, _p, _p, _p, _i, _i, _p],
    },
}
# the host sources' entry points (no stream argument)
_HOST_ARGTYPES = {
    "jpeg_entropy": {
        "aihab_jpeg_entropy": [_p, _p, _p, _p, _p, _i, _p, _i, _p, _p, _i],
        "aihab_jpeg_arith_encode": [_p, _p, _p, _ll],
        "aihab_jpeg_packed_size": [_i],
    },
    "zstd_decode": {
        "aihab_zstd_decode": [_p, _ll, _p, _p, _p, _i],
        "aihab_zstd_decode_into": [_p, _ll, _p, _ll, _p, _i],
        "aihab_zstd_content_size": [_p, _ll],
        "aihab_zstd_take": [_p, _p],
        "aihab_xxh64": [_p, _ll, ctypes.c_ulonglong, _p],
    },
    "blosc_lz4": {
        "aihab_blosc_decompress": [_p, _ll, _p, _ll, _i],
        "aihab_blosc_compress": [_p, _ll, _i, _p, _p, _i],
        "aihab_lz4_decompress": [_p, _ll, _p, _ll],
        "aihab_lz4_compress": [_p, _ll, _p, _p],
    },
}

# the entry points that return a value other than an error code
_RESTYPES = {"aihab_zstd_content_size": _ll, "aihab_jpeg_arith_encode": _ll}

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


def _cxx() -> str:
    cand = os.environ.get("CXX") or "c++"
    path = shutil.which(cand)
    if path is None:
        raise RuntimeError(f"host C++ compiler {cand!r} not found (set CXX); "
                           "the host sources (csrc/*.cpp) are compiled on "
                           "first use")
    return path


def _source(name: str) -> Path:
    return _CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _library_path(name: str) -> Path:
    """The library of source ``name``, keyed by the hash of the source and
    of every header in ``csrc/`` (any of which it may include); a host
    source by its own text and flags."""
    digest = hashlib.sha256(_source(name).read_bytes())
    if name in HOST_SOURCES:
        digest.update(" ".join(CXX_FLAGS).encode())
    else:
        for header in sorted(_CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES + HOST_SOURCES) -> dict:
    """Compile every source of ``names`` that has no library yet, all at
    once (``nvcc`` for the CUDA sources, the host compiler for the host
    ones); return {source name: library path}.  Records each build's
    seconds and the compiler's report (ptxas's registers and shared
    memory) in ``build_info``.  Each library is written under a name of
    its own process and renamed into place, so processes building at once
    never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name, out in paths.items():
        if out.is_file():
            build_info[name] = dict(seconds=None, ptxas="", path=str(out))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = ([_cxx(), *CXX_FLAGS] if name in HOST_SOURCES
               else [_nvcc(), *NVCC_FLAGS])
        procs[name] = (tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp), str(_source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{_source(name).name} ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, paths[name])
        build_info[name] = dict(seconds=time.perf_counter() - t0, ptxas=err,
                                path=str(paths[name]))
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return paths


def _load(paths: dict) -> None:
    for src, path in paths.items():
        lib = ctypes.CDLL(str(path))
        table = _HOST_ARGTYPES if src in HOST_SOURCES else _ARGTYPES
        for fn, argtypes in table[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
        _libs[src] = lib


def library(name: str = "block_kernels") -> ctypes.CDLL:
    """The loaded library of source ``name`` (every source, the host ones
    included, is built on the first call)."""
    with _lock:
        if any(src not in _libs for src in SOURCES):
            _load(build())
        return _libs[name]


def host_library(name: str = "jpeg_entropy") -> ctypes.CDLL:
    """The loaded library of host source ``name``, built alone (no
    ``nvcc``): the CPU's path to it."""
    with _lock:
        if name not in _libs:
            _load(build((name,)))
        return _libs[name]


# each C entry point once its library is loaded (a launch then skips the
# lock and the library lookup: a small kernel's call is bound by the host)
_entries: dict = {}


def launch(fn: str, device, *args) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current stream of
    ``device``, with ``device`` current; raise on the CUDA error code it
    returns."""
    import torch

    entry = _entries.get(fn)
    if entry is None:
        entry = _entries[fn] = getattr(library(_SOURCE_OF[fn]), fn)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = entry(*args, stream)  # (the device switch costs µs)
    else:
        with torch.cuda.device(device):
            err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
