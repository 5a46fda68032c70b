"""Model zoo (counterpart of ``aihab_clip_tpu/models/zoo.py``).

``load(name)`` resolves, in order:
  1. ``random:<ARCH>`` -> parameters drawn from a seeded ``torch.Generator``
     (development / benchmarks without weights);
  2. the converted cache ``<cache_root>/converted/<safe>.npz`` plus
     ``.config.json`` — the JAX package's naming (``zoo.py:344-366``) and
     layout, carried over by ``convert.flax_params_to_state_dict``, so a
     cache written by the JAX package loads here.
Checkpoint download and ``.pt`` conversion wait for checkpoint files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import torch

from ..backend import resolve_device
from .clip import CLIP_ARCHS, CLIPConfig, CLIPModel
from .convert import flax_params_to_state_dict, load_params_npz


def default_cache_root() -> Path:
    """The JAX package's cache root, so its converted caches are shared."""
    return Path(os.path.expanduser("~/.cache/aihab_clip_tpu"))


@dataclasses.dataclass
class CLIPBundle:
    name: str
    config: CLIPConfig
    model: CLIPModel
    source: str  # 'npz-cache' | 'random'


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


@torch.no_grad()
def init_random_(model: CLIPModel, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator``: normal weights at
    1/sqrt(fan_in), zero biases, unit LayerNorm scales, and the CLIP
    embedding scales (class/positional/projection 1/sqrt(width), token
    0.02, text positional 0.01)."""
    vis_scale = model.config.vision_width ** -0.5
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "logit_scale":
            p.fill_(torch.log(torch.tensor(1 / 0.07)).item())
        elif ".ln_" in name:
            p.fill_(1.0 if leaf == "weight" else 0.0)
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
         random_cfg: Optional[CLIPConfig] = None) -> CLIPBundle:
    """Load a CLIP ViT as a ``CLIPBundle`` on ``device`` (default the card;
    raises without one unless ``device="cpu"``).  Parameters are fp32; the
    towers compute in ``dtype``."""
    dev = resolve_device(device)
    cache_root = Path(cache_dir) if cache_dir else default_cache_root()

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
