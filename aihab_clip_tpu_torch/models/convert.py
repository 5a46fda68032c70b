"""The weight carry: the JAX package's flax-layout parameters -> this port.

Input is the flat ``{"a/b/c": ndarray}`` form that ``save_params_npz``
(``aihab_clip_tpu/models/convert.py:208``) writes and
``tests/golden/*_params.npz`` hold.  Layout facts:

  * flax Dense ``kernel`` [in, out]  -> torch ``weight`` [out, in]
  * flax Conv ``kernel`` HWIO        -> torch ``weight`` OIHW (every 4-D
    kernel: ViT's ``conv1``, ConvNeXt's ``stem_conv`` [4, 4, 3, C],
    ``down_conv_<s>`` [2, 2, C, 2C] and ``dwconv`` [7, 7, 1, C] -> [C, 1,
    7, 7])
  * ``attn/in_proj/{kernel,bias}``   -> ``attn.in_proj_{weight,bias}``
  * LayerNorm ``scale``              -> ``weight``
  * ``resblocks_<i>``                -> ``resblocks.<i>``
  * ``text/token_embedding``         -> ``text.token_embedding.weight``
  * every other leaf keeps its path (ConvNeXt's ``stage<s>_block<b>/gamma``)

The same rules carry a SigLIP tree into ``SigLIPModel``: its separate
``attn/{q,k,v,out}_proj`` and ``text/head`` Dense kernels, the conv1 bias,
``attnpool/{probe,attn,ln,mlp}`` and the scalar ``logit_scale`` and
``logit_bias`` keep their names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _set(tree: Dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_params_npz(path) -> Dict:
    """``save_params_npz`` output -> nested dict of numpy arrays."""
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            _set(out, tuple(key.split("/")), data[key])
    return out


def flatten_params(params: Mapping, prefix=()) -> Dict[str, np.ndarray]:
    """Nested param dict -> {"a/b/c": ndarray}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, prefix + (k,)))
        else:
            flat["/".join(prefix + (k,))] = np.asarray(v, dtype=np.float32)
    return flat


def _convert_key(key: str, v: np.ndarray):
    parts = [p.replace("resblocks_", "resblocks.") if p.startswith(
        "resblocks_") else p for p in key.split("/")]
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if parent == "in_proj":
        name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
        return ".".join(parts[:-2] + [name]), v.T if leaf == "kernel" else v
    if leaf == "kernel" and v.ndim == 4:
        return ".".join(parts[:-1] + ["weight"]), v.transpose(3, 2, 0, 1)
    if leaf == "kernel":
        return ".".join(parts[:-1] + ["weight"]), v.T
    if leaf == "scale":
        return ".".join(parts[:-1] + ["weight"]), v
    if parts == ["text", "token_embedding"]:
        return "text.token_embedding.weight", v
    return ".".join(parts), v


def flax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax-layout CLIP (ViT or ConvNeXt) or SigLIP params (nested or
    ``/``-flat) -> a state dict for ``CLIPModel`` or
    ``SigLIPModel.load_state_dict``."""
    sd = {}
    for key, v in flatten_params(params).items():
        name, arr = _convert_key(key, v)
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd
