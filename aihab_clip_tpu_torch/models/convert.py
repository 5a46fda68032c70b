"""The weight carry: reference checkpoints and the JAX package's
flax-layout parameters -> this port, and the port -> JAX's cache layout.

Input is the flat ``{"a/b/c": ndarray}`` form that ``save_params_npz``
(``aihab_clip_tpu/models/convert.py:208``) writes and
``tests/golden/*_params.npz`` hold.  Layout facts:

  * flax Dense ``kernel`` [in, out]  -> torch ``weight`` [out, in]
  * flax Conv ``kernel`` HWIO        -> torch ``weight`` OIHW (every 4-D
    kernel: ViT's ``conv1``, ConvNeXt's ``stem_conv`` [4, 4, 3, C],
    ``down_conv_<s>`` [2, 2, C, 2C] and ``dwconv`` [7, 7, 1, C] -> [C, 1,
    7, 7], a ModifiedResNet's ``conv1``-``conv3`` and ``downsample_conv``)
  * ``attn/in_proj/{kernel,bias}``   -> ``attn.in_proj_{weight,bias}``
  * LayerNorm and FrozenBatchNorm ``scale`` -> ``weight`` (a BatchNorm's
    ``mean`` and ``var`` keep their names)
  * ``resblocks_<i>``                -> ``resblocks.<i>``
  * ``text/token_embedding``         -> ``text.token_embedding.weight``
  * every other leaf keeps its path (ConvNeXt's ``stage<s>_block<b>/gamma``)

LoRA adapters cross the same way: ``flax_adapters_to_port`` and
``port_adapters_to_flax`` map the keys of JAX's ``lora_adapters.npz``
(``<kernel path>/a|b``) to and from the port's weight names
(``jax_kernel_path`` inverts ``_convert_key`` for a Dense weight).

The same rules carry a SigLIP tree into ``SigLIPModel``: its separate
``attn/{q,k,v,out}_proj`` and ``text/head`` Dense kernels, the conv1 bias,
``attnpool/{probe,attn,ln,mlp}`` and the scalar ``logit_scale`` and
``logit_bias`` keep their names.

``torch_state_dict_to_port`` reads an OpenAI/open_clip CLIP state dict
(JAX ``convert.py:80-139``).  The port's module names follow OpenAI's, so
the text tower only gains its ``text.`` prefix and every tensor keeps its
layout (JAX's two transposes cancel); a ModifiedResNet's visual keys take
JAX's module names (``rn_visual_key``, JAX ``convert.py:166-205``).  The
result equals
``flax_params_to_state_dict`` of JAX's converted tree bit for bit.
``state_dict_to_flax_params`` inverts ``flax_params_to_state_dict``, and
``save_params_npz`` writes the converted cache JAX reads.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .clip import CLIPConfig, config_from_state_dict_shapes


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
    """Flax-layout CLIP (ViT, ModifiedResNet or ConvNeXt) or SigLIP params
    (nested or ``/``-flat) -> a state dict for ``CLIPModel`` or
    ``SigLIPModel.load_state_dict``."""
    sd = {}
    for key, v in flatten_params(params).items():
        name, arr = _convert_key(key, v)
        # the transposes copied by torch (blocked, threaded: numpy's
        # strided copy of a kernel runs several times slower)
        sd[name] = torch.from_numpy(arr).contiguous()
    return sd


def jax_kernel_path(name: str) -> str:
    """The inverse of ``_convert_key`` for a 2-D Dense weight (a LoRA
    target): the port's ``visual.transformer.resblocks.0.attn.in_proj_weight``
    or ``....out_proj.weight`` -> JAX's ``visual/transformer/resblocks_0/
    attn/in_proj/kernel`` or ``.../out_proj/kernel``."""
    parts = name.split(".")
    if parts[-1] == "in_proj_weight":
        parts = parts[:-1] + ["in_proj", "weight"]
    if parts[-1] != "weight":
        raise ValueError(f"{name!r} is not a Dense weight")
    return "/".join(_flax_parts(parts[:-1]) + ["kernel"])


def _flax_parts(parts):
    """Module names of the port -> flax's (``resblocks.<i>`` ->
    ``resblocks_<i>``)."""
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "resblocks" and i + 1 < len(parts):
            out.append(f"resblocks_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def flax_adapters_to_port(npz_or_dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX's ``lora_adapters.npz`` (a path, or its ``{"<kernel path>/a" |
    "<kernel path>/b": array}`` mapping) -> ``{port weight name: {"a":
    [in, r], "b": [r, out]}}`` fp32 tensors.  A and B keep JAX's layouts
    (the kernel is [in, out]); ``train/lora.lora_merge`` adds their product
    transposed to the port's [out, in] weight."""
    if isinstance(npz_or_dict, Mapping):
        flat = dict(npz_or_dict)
    else:
        with np.load(npz_or_dict) as data:
            flat = {k: data[k] for k in data.files}
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        path, leaf = key.rsplit("/", 1)
        if leaf not in ("a", "b"):
            raise ValueError(f"adapter key {key!r} is not <path>/a|b")
        name = _convert_key(path, np.zeros((1, 1), np.float32))[0]
        out.setdefault(name, {})[leaf] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    return out


def port_adapters_to_flax(adapters: Mapping) -> Dict[str, np.ndarray]:
    """``{port weight name: {"a", "b"}}`` -> the ``lora_adapters.npz``
    mapping JAX's runner writes (``<kernel path>/a``, ``<kernel path>/b``,
    the same layouts)."""
    return {f"{jax_kernel_path(name)}/{leaf}":
            np.asarray(t.detach().float().cpu().numpy() if hasattr(
                t, "detach") else t, dtype=np.float32)
            for name, ab in adapters.items() for leaf, t in ab.items()}


# what a key of a transformer block may be after ``resblocks.<i>.``
_BLOCK_KEYS = {"attn.in_proj_weight", "attn.in_proj_bias",
               "attn.out_proj.weight", "attn.out_proj.bias"} | {
    f"{m}.{leaf}" for m in ("ln_1", "ln_2", "mlp.c_fc", "mlp.c_proj")
    for leaf in ("weight", "bias")}
_TEXT_KEYS = {"positional_embedding", "text_projection",
              "token_embedding.weight", "ln_final.weight", "ln_final.bias"}
_VIT_KEYS = {"class_embedding", "positional_embedding", "proj",
             "conv1.weight", "ln_pre.weight", "ln_pre.bias", "ln_post.weight",
             "ln_post.bias"}


def clean_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's tensors as fp32 torch tensors: the DDP
    ``module.`` prefix stripped (when every key has it), the ``attn_mask``
    buffers and the ``input_resolution`` / ``context_length`` /
    ``vocab_size`` entries of OpenAI's JIT archives dropped."""
    if state_dict and all(str(k).startswith("module.") for k in state_dict):
        state_dict = {str(k)[len("module."):]: v
                      for k, v in state_dict.items()}
    return {k: torch.as_tensor(v).float() for k, v in state_dict.items()
            if not str(k).endswith("attn_mask")
            and k not in ("input_resolution", "context_length", "vocab_size")}


def _block_key(key: str, prefix: str) -> bool:
    parts = key[len(prefix):].split(".", 1)
    return key.startswith(prefix) and len(parts) == 2 \
        and parts[0].isdigit() and parts[1] in _BLOCK_KEYS


def text_key(key: str) -> str:
    """An OpenAI text-tower key or ``logit_scale`` -> the port's name."""
    if key == "logit_scale":
        return key
    if key in _TEXT_KEYS or _block_key(key, "transformer.resblocks."):
        return "text." + key
    raise KeyError(f"Unhandled checkpoint key: {key}")


_BN_LEAVES = {"weight": "weight", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}


def rn_visual_key(key: str):
    """An OpenAI ModifiedResNet visual key (below ``visual.``) -> the
    port's name, or None for a BatchNorm's ``num_batches_tracked`` (dropped):
    ``layer<s>.<b>.`` -> ``layer<s>_<b>.``, ``downsample.0`` / ``.1`` ->
    ``downsample_conv`` / ``downsample_bn``, ``running_mean`` / ``_var``
    -> ``mean`` / ``var``.  An unknown key raises JAX's ``KeyError``."""
    parts = key.split(".")

    def bn(prefix: str, leaf: str, what: str):
        if leaf == "num_batches_tracked":
            return None
        if leaf not in _BN_LEAVES:
            raise KeyError(f"Unhandled {what} bn key: visual.{key}")
        return f"visual.{prefix}.{_BN_LEAVES[leaf]}"

    if parts[0] in ("conv1", "conv2", "conv3"):
        return f"visual.{parts[0]}.weight"
    if parts[0] in ("bn1", "bn2", "bn3"):
        return bn(parts[0], parts[1], "stem")
    if parts[0].startswith("layer"):
        blk, mod = f"{parts[0]}_{parts[1]}", parts[2]
        if mod.startswith("conv"):
            return f"visual.{blk}.{mod}.weight"
        if mod.startswith("bn"):
            return bn(f"{blk}.{mod}", parts[3], "block")
        if mod == "downsample" and parts[3] == "0":
            return f"visual.{blk}.downsample_conv.weight"
        if mod == "downsample" and parts[3] == "1":
            return bn(f"{blk}.downsample_bn", parts[4], "downsample")
        if mod == "downsample":
            raise KeyError(f"Unhandled downsample key: visual.{key}")
        raise KeyError(f"Unhandled block key: visual.{key}")
    if parts[0] == "attnpool":
        if parts[1] == "positional_embedding":
            return "visual.attnpool.positional_embedding"
        if parts[1] in ("q_proj", "k_proj", "v_proj", "c_proj"):
            leaf = "weight" if parts[2] == "weight" else "bias"
            return f"visual.attnpool.{parts[1]}.{leaf}"
        raise KeyError(f"Unhandled attnpool key: visual.{key}")
    raise KeyError(f"Unhandled ResNet visual key: visual.{key}")


def torch_state_dict_to_port(state_dict: Mapping, resolution: int = 0
                             ) -> Tuple[CLIPConfig, Dict[str, torch.Tensor]]:
    """An OpenAI/open_clip CLIP state dict (tensors or arrays, any float
    dtype) -> (CLIPConfig, the port's fp32 state dict).  A state dict with
    ``visual.trunk.`` keys is open_clip's ConvNeXt layout
    (``convnext.openclip_convnext_state_dict_to_port``, which alone reads
    ``resolution``); a ModifiedResNet's visual keys are renamed by
    ``rn_visual_key``.  An unknown key raises ``KeyError``, as in JAX."""
    sd = clean_state_dict(state_dict)
    if any(k.startswith("visual.trunk.") for k in sd):
        from .convnext import openclip_convnext_state_dict_to_port

        return openclip_convnext_state_dict_to_port(sd, resolution=resolution)
    cfg = config_from_state_dict_shapes({k: tuple(v.shape)
                                         for k, v in sd.items()})
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        if not key.startswith("visual."):
            out[text_key(key)] = v
        elif not cfg.is_vit:
            name = rn_visual_key(key[len("visual."):])
            if name is not None:
                out[name] = v
        elif key[len("visual."):] not in _VIT_KEYS \
                and not _block_key(key, "visual.transformer.resblocks."):
            raise KeyError(f"Unhandled ViT visual key: {key}")
        else:
            out[key] = v
    return cfg, out


def jax_param_path(name: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """A port parameter's JAX path and its axis map: ``(path, perm)`` with
    the port tensor's dim ``d`` holding the JAX leaf's dim ``perm[d]``
    (a Dense kernel is transposed, a conv kernel OIHW <- HWIO); the
    inverse of ``_convert_key``."""
    *mods, leaf = name.split(".")
    path = _flax_parts(mods)
    perm = tuple(range(ndim))
    if name == "text.token_embedding.weight":
        path, leaf = ["text"], "token_embedding"
    elif leaf in ("in_proj_weight", "in_proj_bias"):
        path.append("in_proj")
        leaf, perm = (("kernel", (1, 0)) if leaf == "in_proj_weight"
                      else ("bias", perm))
    elif leaf == "weight" and ndim > 1:
        leaf, perm = "kernel", (3, 2, 0, 1) if ndim == 4 else (1, 0)
    elif leaf == "weight":
        leaf = "scale"
    return "/".join(path + [leaf]), perm


def state_dict_to_flax_params(sd: Mapping) -> Dict[str, np.ndarray]:
    """The port's state dict (CLIP ViT, ModifiedResNet, ConvNeXt or SigLIP)
    -> JAX's flat flax layout ``{"a/b/c": fp32 ndarray}``: the inverse of
    ``flax_params_to_state_dict``."""
    flat: Dict[str, np.ndarray] = {}
    for name, t in sd.items():
        v = t.detach().float().cpu()
        path, perm = jax_param_path(name, v.dim())
        # the JAX leaf's dim perm[d] is the port's d
        if v.dim() > 1:
            v = v.permute(*np.argsort(perm).tolist()).contiguous()
        flat[path] = v.numpy()
    return flat


def save_params_npz(path, params: Mapping) -> None:
    """A param tree (nested or ``/``-flat) -> an ``.npz`` keyed by
    ``/``-joined paths (JAX ``convert.py:208-221``)."""
    np.savez(path, **flatten_params(params))
