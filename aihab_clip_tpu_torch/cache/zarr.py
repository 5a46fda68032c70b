"""zarr v2 arrays over a kvstore (``cache/kvstore.py``): what tensorstore's
``zarr`` driver writes and reads for the JAX package, in its cache store
(``TensorStoreStore``: blosc/LZ4) and inside orbax checkpoints (zstd).

An array under ``<prefix>/`` is its ``.zarray`` (JSON: ``chunks``,
``compressor``, ``dimension_separator``, ``dtype``, ``fill_value``,
``filters``, ``order``, ``shape``, ``zarr_format``; keys sorted, no spaces,
as tensorstore writes them) and one value per chunk, keyed by the chunk's
grid indices joined by the separator (``0.0``; ``0`` for a 0-d array).  A
chunk that is absent reads as ``fill_value`` (zero for null).  Edge chunks
are stored whole, padded with the fill.

  * dtypes: ``<f2 <f4 <f8``, signed and unsigned integers of 1-8 bytes,
    ``|b1``, either byte order, and ``bfloat16`` (numpy has no bfloat16: such
    an array reads as, and is written from, a ``torch.bfloat16`` tensor);
  * order ``C``; no filters;
  * compressors: null, ``zlib``, ``zstd`` (``ops/zstd.py``; written as raw
    blocks) and ``blosc`` with cname ``lz4`` (``ops/blosc.py``).

``default_chunks`` is tensorstore's choice for an array created without a
chunk layout (about 2**20 elements a chunk, the small dimensions whole, the
rest a hypercube), so ``write_array``'s ``.zarray`` is the one tensorstore
writes for the same array, key for key.
"""

from __future__ import annotations

import itertools
import json
import math
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import blosc, zstd

BLOSC_LZ4 = {"blocksize": 0, "clevel": 5, "cname": "lz4", "id": "blosc",
             "shuffle": -1}
ZSTD_1 = {"id": "zstd", "level": 1}
CHUNK_ELEMENTS = 1 << 20


def default_chunks(shape: Sequence[int]) -> List[int]:
    """tensorstore's default chunk shape for ``shape``: dimensions taken
    from the smallest up; one that fits under the hypercube side of the
    elements left is whole, and the rest share that side."""
    rank = len(shape)
    chunks = [0] * rank
    order = sorted(range(rank), key=lambda d: shape[d])
    left = float(CHUNK_ELEMENTS)
    for i, d in enumerate(order):
        side = max(1, math.floor(left ** (1.0 / (rank - i)) + 1e-9))
        extent = max(int(shape[d]), 1)
        if extent > side:
            for d2 in order[i:]:
                chunks[d2] = side
            break
        chunks[d] = extent
        left /= extent
    return chunks


def dtype_str(dtype) -> str:
    """A numpy dtype (or ``torch.bfloat16``) as zarr v2 writes it."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    dt = np.dtype(dtype)
    if dt.kind not in "fiub":
        raise TypeError(f"dtype {dt} has no zarr form here")
    if dt.itemsize == 1 or dt.kind == "b":
        return "|" + dt.kind + str(dt.itemsize)
    return dt.newbyteorder("<").str if dt.byteorder in "=|" else dt.str


def parse_dtype(s: str):
    """zarr's dtype string -> a numpy dtype, or ``torch.bfloat16``."""
    if s == "bfloat16":
        return torch.bfloat16
    dt = np.dtype(s)
    if dt.kind not in "fiub":
        raise TypeError(f"zarr dtype {s!r} is not read here")
    return dt


def _itemsize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else np.dtype(dtype).itemsize


def _fill(value, dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}[value]
    return value


def encode_zarray(shape, chunks, dtype, compressor) -> bytes:
    """The ``.zarray`` tensorstore writes (``.`` separator, null fill)."""
    meta = {"chunks": list(chunks), "compressor": compressor,
            "dimension_separator": ".",
            "dtype": dtype_str(dtype), "fill_value": None,
            "filters": None, "order": "C", "shape": list(shape),
            "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def _chunk_key(prefix: str, idx, sep: str) -> str:
    name = sep.join(str(i) for i in idx) if idx else "0"
    return f"{prefix}/{name}" if prefix else name


def _encode(raw: bytes, compressor: Optional[Dict], itemsize: int) -> bytes:
    if compressor is None:
        return raw
    cid = compressor["id"]
    if cid == "zstd":
        return zstd.compress_raw(raw)
    if cid == "blosc" and compressor.get("cname") == "lz4":
        return blosc.compress(raw, itemsize)
    if cid == "zlib":
        return zlib.compress(raw, int(compressor.get("level", 1)))
    raise NotImplementedError(f"zarr compressor {compressor} is not written "
                              "here")


def _decode(data: bytes, compressor: Optional[Dict], name: str):
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zstd":
        return zstd.decompress(data, name=name)
    if cid == "blosc":
        return blosc.decompress(data, name=name)
    if cid == "zlib":
        return zlib.decompress(data)
    raise NotImplementedError(f"{name}: zarr compressor {compressor} is not "
                              "read here")


def as_numpy(arr):
    """(numpy array, its zarr dtype); a bfloat16 tensor as its uint16
    bits."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return (arr.detach().cpu().contiguous().view(torch.int16)
                    .numpy().view(np.uint16), torch.bfloat16)
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    return arr, arr.dtype


def write_array(kv, prefix: str, arr, compressor: Optional[Dict] = None,
                chunks: Optional[Sequence[int]] = None) -> None:
    """``arr`` (numpy, or a torch tensor) as a zarr v2 array under
    ``prefix``; its chunks first, its ``.zarray`` last.  Default: blosc/LZ4
    in tensorstore's default chunks."""
    compressor = BLOSC_LZ4 if compressor is None else compressor
    a, dtype = as_numpy(arr)
    shape = a.shape
    if chunks is None:
        chunks = default_chunks(shape)
    chunks = [int(c) for c in chunks]
    itemsize = _itemsize(dtype)
    grid = [(-(-s // c)) if s else 0 for s, c in zip(shape, chunks)]
    for idx in itertools.product(*[range(g) for g in grid]):
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        piece = a[sl]
        if piece.shape != tuple(chunks):
            pad = np.zeros(chunks, a.dtype)
            pad[tuple(slice(0, s) for s in piece.shape)] = piece
            piece = pad
        raw = np.ascontiguousarray(piece).tobytes()
        kv.write(_chunk_key(prefix, idx, "."),
                 _encode(raw, compressor, itemsize))
    kv.write(f"{prefix}/.zarray" if prefix else ".zarray",
             encode_zarray(shape, chunks, dtype, compressor))


def read_zarray(kv, prefix: str) -> Optional[Dict]:
    raw = kv.read(f"{prefix}/.zarray" if prefix else ".zarray")
    return None if raw is None else json.loads(raw)


def read_array(kv, prefix: str, meta: Optional[Dict] = None):
    """The zarr v2 array under ``prefix``: a numpy array (a
    ``torch.bfloat16`` tensor for bfloat16).  KeyError when it is absent."""
    meta = read_zarray(kv, prefix) if meta is None else meta
    if meta is None:
        raise KeyError(f"no zarr array at {prefix!r}")
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{prefix}: zarr format "
                                  f"{meta.get('zarr_format')} is not read")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise NotImplementedError(f"{prefix}: order {meta.get('order')} / "
                                  f"filters {meta.get('filters')} not read")
    dtype = parse_dtype(meta["dtype"])
    np_dtype = np.dtype("<u2") if dtype == torch.bfloat16 else dtype
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"]) if shape else ()
    sep = meta.get("dimension_separator", ".")
    compressor = meta.get("compressor")
    fill = 0 if dtype == torch.bfloat16 else _fill(meta.get("fill_value"),
                                                   dtype)
    grid = [(-(-s // c)) if s else 0 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * np_dtype.itemsize
    out = None
    for idx in itertools.product(*[range(g) for g in grid]):
        key = _chunk_key(prefix, idx, sep)
        data = kv.read(key)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        if data is None:
            if out is None:
                out = np.full(shape, fill, np_dtype)
            else:
                out[sl] = fill
            continue
        raw = _decode(data, compressor, key)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{key}: chunk of {len(raw)} bytes, "
                             f"{chunk_bytes} expected")
        piece = np.frombuffer(raw, np_dtype).reshape(chunks)
        if len(grid) == 0 or (all(g == 1 for g in grid)
                              and tuple(chunks) == shape):
            out = piece  # one whole chunk: no copy
            continue
        if out is None:
            out = np.empty(shape, np_dtype)
        out[sl] = piece[tuple(slice(0, s.stop - s.start) for s in sl)]
    if out is None:
        out = np.full(shape, fill, np_dtype)
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.array(out).view(np.int16)).view(
            torch.bfloat16)
    return out
