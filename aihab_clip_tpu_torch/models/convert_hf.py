"""HuggingFace ``SiglipModel`` snapshots -> the port's SigLIP (counterpart of
``aihab_clip_tpu/models/convert_hf.py``), without ``transformers``.

``config.json`` is read as a dict: HF writes only the values that differ
from its config classes' defaults, so ``SIGLIP_TEXT_DEFAULTS`` and
``SIGLIP_VISION_DEFAULTS`` keep those of ``SiglipTextConfig`` and
``SiglipVisionConfig``.  The weights come from ``models/safetensors.py``.
HF's names map onto the port's modules (``layer_norm1`` -> ``ln_1``,
``fc1`` -> ``c_fc`` ...), every tensor keeps its layout, and the MAP head's
packed ``in_proj_weight``/``in_proj_bias`` split into q/k/v rows, so the
result equals ``flax_params_to_state_dict`` of JAX's converted tree.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import torch

from .safetensors import read_snapshot_weights
from .siglip import SigLIPConfig

# transformers' SiglipTextConfig / SiglipVisionConfig defaults, for the keys
# siglip_config_from_hf reads
SIGLIP_TEXT_DEFAULTS = dict(vocab_size=32000, hidden_size=768,
                            intermediate_size=3072, num_hidden_layers=12,
                            num_attention_heads=12,
                            max_position_embeddings=64)
SIGLIP_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                              num_hidden_layers=12, num_attention_heads=12,
                              image_size=224, patch_size=16)

_LAYER_NAMES = {"self_attn": "attn", "layer_norm1": "ln_1",
                "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
                "mlp.fc2": "mlp.c_proj"}
_MLP = {"fc1": "c_fc", "fc2": "c_proj"}


def siglip_config_from_hf(config: Mapping) -> SigLIPConfig:
    """A snapshot's ``config.json`` dict -> SigLIPConfig (JAX
    ``convert_hf.py:37-54``), HF's defaults where a key is absent."""
    t = {**SIGLIP_TEXT_DEFAULTS, **config.get("text_config", {})}
    v = {**SIGLIP_VISION_DEFAULTS, **config.get("vision_config", {})}
    return SigLIPConfig(
        embed_dim=int(v["hidden_size"]),
        image_resolution=int(v["image_size"]),
        patch_size=int(v["patch_size"]),
        vision_width=int(v["hidden_size"]),
        vision_layers=int(v["num_hidden_layers"]),
        vision_heads=int(v["num_attention_heads"]),
        vision_mlp_dim=int(v["intermediate_size"]),
        context_length=int(t["max_position_embeddings"]),
        vocab_size=int(t["vocab_size"]),
        text_width=int(t["hidden_size"]),
        text_layers=int(t["num_hidden_layers"]),
        text_heads=int(t["num_attention_heads"]),
        text_mlp_dim=int(t["intermediate_size"]))


def _layer_key(tower: str, key: str) -> str:
    """``encoder.layers.<i>.<rest>`` -> ``<tower>.transformer.resblocks.<i>.
    <rest renamed>``."""
    _, _, idx, rest = key.split(".", 3)
    for hf, port in _LAYER_NAMES.items():
        if rest.startswith(hf + ".") and idx.isdigit():
            tail = rest[len(hf) + 1:]
            if hf == "self_attn" and tail.split(".")[0] not in (
                    "q_proj", "k_proj", "v_proj", "out_proj"):
                break
            return f"{tower}.transformer.resblocks.{idx}.{port}.{tail}"
    raise KeyError(f"Unhandled {tower} layer key: {key}")


def _vision_key(key: str, v: torch.Tensor, out: Dict[str, torch.Tensor]):
    parts = key.split(".")
    if key.startswith("embeddings.patch_embedding."):
        out[f"visual.conv1.{parts[-1]}"] = v
    elif key == "embeddings.position_embedding.weight":
        out["visual.positional_embedding"] = v
    elif key.startswith("encoder.layers."):
        out[_layer_key("visual", key)] = v
    elif key.startswith("post_layernorm."):
        out[f"visual.ln_post.{parts[-1]}"] = v
    elif key == "head.probe":
        out["visual.attnpool.probe"] = v
    elif key in ("head.attention.in_proj_weight",
                 "head.attention.in_proj_bias"):
        leaf = "weight" if key.endswith("weight") else "bias"
        for name, part in zip(("q_proj", "k_proj", "v_proj"),
                              v.chunk(3, dim=0)):
            out[f"visual.attnpool.attn.{name}.{leaf}"] = part
    elif key.startswith("head.attention.out_proj."):
        out[f"visual.attnpool.attn.out_proj.{parts[-1]}"] = v
    elif key.startswith("head.layernorm."):
        out[f"visual.attnpool.ln.{parts[-1]}"] = v
    elif key.startswith("head.mlp.") and parts[2] in _MLP:
        out[f"visual.attnpool.mlp.{_MLP[parts[2]]}.{parts[-1]}"] = v
    else:
        raise KeyError(f"Unhandled vision key: {key}")


def _text_key(key: str) -> str:
    parts = key.split(".")
    if key == "embeddings.token_embedding.weight":
        return "text.token_embedding.weight"
    if key == "embeddings.position_embedding.weight":
        return "text.positional_embedding"
    if key.startswith("encoder.layers."):
        return _layer_key("text", key)
    if key.startswith("final_layer_norm."):
        return f"text.ln_final.{parts[-1]}"
    if key.startswith("head."):
        return f"text.head.{parts[-1]}"
    raise KeyError(f"Unhandled text key: {key}")


def hf_siglip_state_dict_to_port(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """A ``SiglipModel`` state dict (any float dtype) -> the port's fp32
    ``SigLIPModel`` state dict (JAX ``convert_hf.py:80-178``).  The
    ``position_ids`` buffers are dropped; an unknown key raises."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in state_dict.items():
        if "position_ids" in key:
            continue
        v = v.float()
        if key.startswith("vision_model."):
            _vision_key(key[len("vision_model."):], v, out)
        elif key.startswith("text_model."):
            out[_text_key(key[len("text_model."):])] = v
        elif key in ("logit_scale", "logit_bias"):
            out[key] = v.reshape(())
        else:
            raise KeyError(f"Unhandled HF key: {key}")
    return out


def find_local_hf_snapshot(repo_id: str) -> Optional[Path]:
    """The newest snapshot directory of ``repo_id`` in the HF hub cache
    (``$HF_HOME/hub``, default ``~/.cache/huggingface/hub``) that holds
    weights; None otherwise.  Never downloads."""
    cache = Path(os.path.expanduser(
        os.environ.get("HF_HOME", "~/.cache/huggingface"))) / "hub"
    repo_dir = cache / f"models--{repo_id.replace('/', '--')}" / "snapshots"
    if not repo_dir.is_dir():
        return None
    snaps = sorted(repo_dir.iterdir(), key=lambda p: p.stat().st_mtime)
    for snap in reversed(snaps):
        if any(snap.glob("*.safetensors")) or any(snap.glob("*.bin")):
            return snap
    return None


def load_local_hf_siglip(repo_id: str
                         ) -> Tuple[SigLIPConfig, Dict[str, torch.Tensor]]:
    """(SigLIPConfig, the port's state dict) of a locally cached HF SigLIP
    snapshot; ``FileNotFoundError`` without one."""
    snap = find_local_hf_snapshot(repo_id)
    if snap is None:
        raise FileNotFoundError(
            f"No local HF snapshot for '{repo_id}' "
            f"(zero-egress: place one under ~/.cache/huggingface/hub)")
    cfg = siglip_config_from_hf(json.loads((snap / "config.json").read_text()))
    return cfg, hf_siglip_state_dict_to_port(read_snapshot_weights(snap))
