"""Combined CLIP model (counterpart of ``aihab_clip_tpu/models/clip.py``).

``CLIPConfig`` is re-declared with the JAX package's field names, so a
config JSON written by either package loads in the other.  ``CLIPModel``
builds CLIP ViT and ConvNeXt towers (``vision_tower="convnext"``; the
ModifiedResNet waits for its port); ``CLIP_ARCHS`` holds the ViT rows of the
JAX table (the OpenAI towers and the LAION ViT-H/14, ViT-g/14 and
ViT-bigG/14), the ``Tiny`` and ``TinyConvNeXt`` development architectures
and, once ``models/zoo`` is imported, the LAION ConvNeXt tag grid.  The
zoo maps open_clip's dashed names (``ViT-B-16``, ``ViT-bigG-14``) onto these
keys, as JAX's does.

  * ``encode_image(images)``               -> pre-projection features
  * ``encode_image(images, project=True)`` -> (pre, projected)
  * ``encode_text(tokens)``                -> (pre, projected)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from .convnext import ConvNeXtVisionTower
from .text import TextTransformer
from .vit import VisionTransformer


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    # vision
    image_resolution: int
    vision_layers: Union[Tuple[int, int, int, int], int]
    vision_width: int
    vision_patch_size: Optional[int]
    # text
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int
    vision_mlp_dim: int = 0          # 0 = 4x width
    text_mlp_dim: int = 0
    vision_heads_override: int = 0   # 0 = width // 64
    act: str = "quick_gelu"
    vision_tower: str = ""
    vision_proj: str = "linear"

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def tower(self) -> str:
        if self.vision_tower:
            return self.vision_tower
        return "vit" if self.is_vit else "rn"

    @property
    def vision_heads(self) -> int:
        if self.vision_heads_override:
            return self.vision_heads_override
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64

    @property
    def vision_preproj_dim(self) -> int:
        """Width of the pre-projection image feature."""
        if self.tower == "convnext":
            return self.vision_width * (2 ** (len(self.vision_layers) - 1))
        return self.vision_width if self.is_vit else self.vision_width * 32


# The ViT rows of the OpenAI CLIP zoo (public shape facts) + a dev arch.
CLIP_ARCHS: Dict[str, CLIPConfig] = {
    "ViT-B/32": CLIPConfig(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12),
    "ViT-B/16": CLIPConfig(512, 224, 12, 768, 16, 77, 49408, 512, 8, 12),
    "ViT-L/14": CLIPConfig(768, 224, 24, 1024, 14, 77, 49408, 768, 12, 12),
    "ViT-L/14@336px": CLIPConfig(768, 336, 24, 1024, 14, 77, 49408, 768, 12, 12),
    "Tiny": CLIPConfig(32, 32, 2, 64, 8, 77, 49408, 64, 1, 2),
    # the LAION-trained open_clip towers (JAX clip.py:111-119), exact GELU
    # as open_clip builds them: ViT-H/14 keeps 20 heads of 64; ViT-g/14
    # (16 heads of 88) and ViT-bigG/14 (16 of 104) override the head count
    # and carry MLPs of 4.36x and 4.92x their widths
    "ViT-H/14": CLIPConfig(1024, 224, 32, 1280, 14, 77, 49408, 1024, 16, 24,
                           act="gelu"),
    "ViT-g/14": CLIPConfig(1024, 224, 40, 1408, 14, 77, 49408, 1024, 16, 24,
                           vision_mlp_dim=6144, vision_heads_override=16,
                           act="gelu"),
    "ViT-bigG/14": CLIPConfig(1280, 224, 48, 1664, 14, 77, 49408, 1280, 20,
                              32, vision_mlp_dim=8192,
                              vision_heads_override=16, act="gelu"),
    # tiny ConvNeXt for tests (width 16 -> pre-projection dim 128)
    "TinyConvNeXt": CLIPConfig(32, 32, (1, 1, 1, 1), 16, None, 77, 49408,
                               64, 1, 2, act="gelu", vision_tower="convnext"),
}


class CLIPModel(nn.Module):
    """Vision tower + text tower + logit scale; fp32 parameters, computing
    in ``dtype``."""

    def __init__(self, config: CLIPConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        cfg = config
        if cfg.tower == "convnext":
            self.visual = ConvNeXtVisionTower(
                cfg.vision_layers, cfg.vision_width, cfg.embed_dim,
                proj=cfg.vision_proj, dtype=dtype)
        elif cfg.tower == "vit":
            self.visual = VisionTransformer(
                cfg.image_resolution, cfg.vision_patch_size, cfg.vision_width,
                cfg.vision_layers, cfg.vision_heads, cfg.embed_dim,
                mlp_dim=cfg.vision_mlp_dim, act=cfg.act, dtype=dtype)
        else:
            raise NotImplementedError(
                f"{cfg.tower!r} (ModifiedResNet) vision towers are not ported "
                "yet: ROADMAP A11")
        self.text = TextTransformer(
            cfg.context_length, cfg.vocab_size, cfg.transformer_width,
            cfg.transformer_layers, cfg.transformer_heads, cfg.embed_dim,
            mlp_dim=cfg.text_mlp_dim, act=cfg.act, dtype=dtype)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor, *, project: bool = False):
        """images [B, H, W, 3] NHWC, normalized."""
        return self.visual(images, project=project)

    def encode_text(self, tokens: torch.Tensor):
        """tokens [B, context] int -> (pre_projection, projected)."""
        return self.text(tokens)
