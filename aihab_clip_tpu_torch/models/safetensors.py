"""Read the weights of a HuggingFace snapshot without ``safetensors`` or
``transformers``.

A ``.safetensors`` file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
"__metadata__": {...}}`` and the tensors' bytes, offsets counted from the
end of the header.  ``read_safetensors`` maps the file copy-on-write and
returns each tensor as a ``torch.frombuffer`` view of the mapping: nothing
is read into a second host copy (BF16, which numpy lacks, included).  The
caller's ``.float()`` of an F16/BF16 view is the one copy a load makes.

``read_snapshot_weights`` reads a snapshot directory: ``model.safetensors``,
the shards a ``model.safetensors.index.json`` names, or a
``pytorch_model.bin`` through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict

import torch

# the weights' dtypes, and I64 for the position_ids buffers older HF files
# carry
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> {name: tensor}, views of a private
    mapping of the file.  An unknown dtype, a header that does not parse,
    offsets outside the data, a byte count that does not match the shape or
    two tensors that overlap raise ``ValueError`` naming the file."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        try:
            header = json.loads(f.read(n))
        except ValueError as exc:
            raise ValueError(f"{path}: unreadable safetensors header") from exc
        size = f.seek(0, 2)
        if not header.keys() - {"__metadata__"}:
            return {}
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start = 8 + n
    out, spans = {}, []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info.get('dtype')!r}, not one of "
                             f"{sorted(_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= size - start \
                or end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{[begin, end]} for shape {shape} {info['dtype']}"
                             f" in {size - start} data bytes")
        spans.append((begin, end, name))
        out[name] = (torch.frombuffer(buf, dtype=dtype, count=count,
                                      offset=start + begin).reshape(shape)
                     if count else torch.empty(shape, dtype=dtype))
    spans.sort()
    for (b0, e0, n0), (b1, e1, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {n0!r} and {n1!r} overlap")
    return out


def read_snapshot_weights(snap) -> Dict[str, torch.Tensor]:
    """The weights of a HF snapshot directory: ``model.safetensors``, else
    the shards of ``model.safetensors.index.json``, else
    ``pytorch_model.bin``; ``FileNotFoundError`` when it holds none."""
    snap = Path(snap)
    single, index = snap / "model.safetensors", \
        snap / "model.safetensors.index.json"
    if single.is_file():
        return read_safetensors(single)
    if index.is_file():
        weight_map = json.loads(index.read_text())["weight_map"]
        out: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            tensors = read_safetensors(snap / shard)
            missing = {k for k, v in weight_map.items() if v == shard} \
                - tensors.keys()
            if missing:
                raise ValueError(f"{snap / shard}: lacks {sorted(missing)} "
                                 f"that {index.name} places there")
            out.update(tensors)
        return out
    binary = snap / "pytorch_model.bin"
    if binary.is_file():
        return torch.load(binary, map_location="cpu", weights_only=True,
                          mmap=True)
    raise FileNotFoundError(f"{snap} holds no model.safetensors, "
                            "model.safetensors.index.json or "
                            "pytorch_model.bin")
