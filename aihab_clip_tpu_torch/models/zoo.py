"""Model zoo (counterpart of ``aihab_clip_tpu/models/zoo.py``).

``load(name)`` first maps open_clip's dashed ViT names onto the table's
keys (``_normalize_openclip_name``, JAX ``zoo.py:369-382``: ``ViT-B-16`` ->
``ViT-B/16``, ``ViT-L-14-336`` -> ``ViT-L/14@336px``, ``ViT-bigG-14`` ->
``ViT-bigG/14``), then resolves, in order:
  1. SigLIP names (``zoo.py:82-214``: ``random:``, ``hf-hub:`` and
     registry forms, any ``ViT-{B,L,SO400M}-<p>-SigLIP[2][-<res>]`` tag):
     ``random:`` draws a ``SigLIPModel`` from a seeded ``torch.Generator``;
     any other SigLIP name raises ``SigLIPAssetsMissingError``, because
     reading a local HF snapshot waits for a snapshot in the repository;
  2. ``random:<ARCH>`` -> CLIP parameters drawn from a seeded
     ``torch.Generator`` (development / benchmarks without weights); the
     LAION ConvNeXt tags (``random:convnext_base_w`` ...) resolve too
     (``zoo.py:32-34``);
  3. the converted cache ``<cache_root>/converted/<safe>.npz`` plus
     ``.config.json`` — the JAX package's naming (``zoo.py:344-366``) and
     layout, carried over by ``convert.flax_params_to_state_dict``, so a
     cache written by the JAX package loads here.
Checkpoint download and ``.pt`` conversion wait for checkpoint files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import torch

from ..backend import resolve_device
from .clip import CLIP_ARCHS, CLIPConfig, CLIPModel
from .convert import flax_params_to_state_dict, load_params_npz
from .convnext import register_convnext_archs
from .layers import LayerNorm, set_remat
from .siglip import (SIGLIP_ARCHS, SigLIPConfig, SigLIPModel,
                     init_siglip_random_, siglip_config_for_name)

register_convnext_archs()  # 'random:convnext_*' resolves via CLIP_ARCHS

# the std of a random ConvNeXt layer scale gamma: JAX initialises it to 1e-6,
# which makes every random block an identity to bf16 precision; at 0.1 each
# block's MLP branch moves the residual stream
CONVNEXT_GAMMA_STD = 0.1


def default_cache_root() -> Path:
    """The JAX package's cache root, so its converted caches are shared."""
    return Path(os.path.expanduser("~/.cache/aihab_clip_tpu"))


@dataclasses.dataclass
class CLIPBundle:
    name: str
    config: Any                  # CLIPConfig | SigLIPConfig
    model: Any                   # CLIPModel | SigLIPModel
    source: str  # 'npz-cache' | 'random'
    tokenize_fn: Optional[Callable] = None  # None: the CLIP BPE


# open_clip/timm hub names -> the HF transformers repos holding the same
# weights in SiglipModel format
_SIGLIP_HF_ALIASES = {
    "timm/ViT-SO400M-16-SigLIP2-384": "google/siglip2-so400m-patch16-384",
    "timm/ViT-B-16-SigLIP": "google/siglip-base-patch16-224",
}


class SigLIPAssetsMissingError(FileNotFoundError):
    """A SigLIP model was asked for by name, but its snapshot (weights and
    sentencepiece tokenizer) cannot be read.  The CLIP BPE gives wrong
    token ids for these checkpoints, so there is no silent fallback."""


def is_siglip_name(name: str) -> bool:
    plain = name.replace("random:", "").replace("hf-hub:", "")
    return ("siglip" in name.lower() or plain in SIGLIP_ARCHS
            or plain.split("/")[-1] in SIGLIP_ARCHS)


def _siglip_arch_for(name: str) -> Tuple[Optional[str],
                                         Optional[SigLIPConfig]]:
    """A SigLIP name -> (arch name, config), without building anything:
    the registry, then the open_clip tag grid, then SO400M-16-384 for any
    other name that says SigLIP; (None, None) otherwise."""
    stripped = name.replace("hf-hub:", "").replace("random:", "")
    tail = stripped.split("/")[-1]
    for cand in (stripped, tail):
        if cand in SIGLIP_ARCHS:
            return cand, SIGLIP_ARCHS[cand]
    for cand in (stripped, tail):
        cfg = siglip_config_for_name(cand)
        if cfg is not None:
            return cand, cfg
    if "siglip" in stripped.lower():
        return ("ViT-SO400M-16-SigLIP2-384",
                SIGLIP_ARCHS["ViT-SO400M-16-SigLIP2-384"])
    return None, None


def _load_siglip(name: str, dtype, dev: torch.device, seed: int,
                 random_cfg: Optional[SigLIPConfig]) -> CLIPBundle:
    if not name.startswith("random:"):
        stripped = name.replace("hf-hub:", "")
        repos = [stripped] + ([_SIGLIP_HF_ALIASES[stripped]]
                              if stripped in _SIGLIP_HF_ALIASES else [])
        raise SigLIPAssetsMissingError(
            f"No readable snapshot for SigLIP '{name}' (candidates {repos}): "
            "this package reads no HF snapshot yet.  Use "
            "'random:<arch>' to run without weights.")
    cfg = random_cfg or _siglip_arch_for(name)[1]
    with torch.device("meta"):
        model = SigLIPModel(cfg, dtype=dtype)
    model = model.to_empty(device="cpu")
    init_siglip_random_(model, torch.Generator().manual_seed(seed))
    return CLIPBundle(name, cfg, model.to(dev).eval(), "random")


def _npz_cache_path(key: str, cache_root: Path) -> Path:
    safe = key.replace("/", "-").replace(":", "_").replace("@", "_")
    return cache_root / "converted" / f"{safe}.npz"


def _config_cache_path(key: str, cache_root: Path) -> Path:
    return _npz_cache_path(key, cache_root).with_suffix(".config.json")


def _load_config(path: Path) -> CLIPConfig:
    d = json.loads(path.read_text())
    if isinstance(d["vision_layers"], list):
        d["vision_layers"] = tuple(d["vision_layers"])
    return CLIPConfig(**d)


def _normalize_openclip_name(name: str) -> str:
    """An open_clip dashed ViT name (``ViT-B-16``, ``ViT-L-14-336``, with or
    without a ``random:`` prefix) -> the table's OpenAI-style key
    (``ViT-B/16``, ``ViT-L/14@336px``), only where that key exists; any
    other name unchanged (JAX ``zoo.py:369-382``)."""
    prefix, _, arch = name.rpartition(":")
    m = re.fullmatch(r"(ViT-[A-Za-z]+)-(\d+)(?:-(\d+))?(?:px)?", arch)
    if m:
        mapped = f"{m.group(1)}/{m.group(2)}"
        if m.group(3):
            mapped += f"@{m.group(3)}px"
        if mapped in CLIP_ARCHS:
            return f"{prefix}:{mapped}" if prefix else mapped
    return name


@torch.no_grad()
def init_random_(model: CLIPModel, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator``: normal weights at
    1/sqrt(fan_in), zero biases, unit LayerNorm scales, the CLIP embedding
    scales (class/positional/projection 1/sqrt(width), token 0.02, text
    positional 0.01) and ConvNeXt's layer scales ``gamma`` normal at
    ``CONVNEXT_GAMMA_STD`` (0.1, not JAX's constant 1e-6)."""
    vis_scale = model.config.vision_width ** -0.5
    ln_params = {f"{mn}.{pn}" for mn, m in model.named_modules()
                 if isinstance(m, LayerNorm)
                 for pn, _ in m.named_parameters(recurse=False)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "logit_scale":
            p.fill_(torch.log(torch.tensor(1 / 0.07)).item())
        elif name in ln_params:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "gamma":
            p.normal_(0.0, CONVNEXT_GAMMA_STD, generator=generator)
        elif leaf in ("bias", "in_proj_bias"):
            p.zero_()
        elif name == "text.token_embedding.weight":
            p.normal_(0.0, 0.02, generator=generator)
        elif name == "text.positional_embedding":
            p.normal_(0.0, 0.01, generator=generator)
        elif name == "text.text_projection":
            p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
        elif name in ("visual.class_embedding", "visual.positional_embedding",
                      "visual.proj"):
            p.normal_(0.0, vis_scale, generator=generator)
        else:  # [out, in(, kh, kw)] weights
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


def load(name: str, dtype=torch.float32, device="cuda", seed: int = 0,
         cache_dir: Optional[str] = None,
         random_cfg: Optional[Any] = None, remat: bool = False) -> CLIPBundle:
    """Load a CLIP (ViT or ConvNeXt) or a SigLIP model as a ``CLIPBundle``
    on ``device`` (default the card; raises without one unless
    ``device="cpu"``).
    Parameters are fp32; the towers compute in ``dtype``.  ``random_cfg``
    (a ``CLIPConfig`` or ``SigLIPConfig``) shapes a ``random:`` model.
    ``remat`` checkpoints every transformer block in training
    (``layers.set_remat``), as JAX's ``load(remat=)``."""
    bundle = _load(name, dtype, device, seed, cache_dir, random_cfg)
    if remat:
        set_remat(bundle.model)
    return bundle


def _load(name: str, dtype, device, seed: int, cache_dir: Optional[str],
          random_cfg: Optional[Any]) -> CLIPBundle:
    dev = resolve_device(device)
    name = _normalize_openclip_name(name)
    cache_root = Path(cache_dir) if cache_dir else default_cache_root()

    if isinstance(random_cfg, SigLIPConfig) or (random_cfg is None
                                                and is_siglip_name(name)):
        return _load_siglip(name, dtype, dev, seed, random_cfg)

    if name.startswith("random:"):
        cfg = random_cfg or CLIP_ARCHS[name.split(":", 1)[1]]
        with torch.device("meta"):
            model = CLIPModel(cfg, dtype=dtype)
        model = model.to_empty(device="cpu")
        init_random_(model, torch.Generator().manual_seed(seed))
        return CLIPBundle(name, cfg, model.to(dev).eval(), "random")

    npz = _npz_cache_path(name, cache_root)
    cfg_path = _config_cache_path(name, cache_root)
    if npz.is_file() and cfg_path.is_file():
        cfg = _load_config(cfg_path)
        model = CLIPModel(cfg, dtype=dtype)
        model.load_state_dict(flax_params_to_state_dict(load_params_npz(npz)))
        return CLIPBundle(name, cfg, model.to(dev).eval(), "npz-cache")

    raise FileNotFoundError(
        f"Model '{name}' has no converted cache at {npz} and is not "
        "'random:<ARCH>'; checkpoint download/conversion is not ported yet")
