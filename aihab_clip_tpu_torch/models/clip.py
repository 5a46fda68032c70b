"""Combined CLIP model (counterpart of ``aihab_clip_tpu/models/clip.py``).

``CLIPConfig`` is re-declared with the JAX package's field names, so a
config JSON written by either package loads in the other.  ``CLIPModel``
builds CLIP ViT, ModifiedResNet (``vision_layers`` a tuple of stage depths)
and ConvNeXt towers (``vision_tower="convnext"``); ``CLIP_ARCHS`` holds the
rows of the JAX table (the OpenAI RN50 to RN50x64 and ViT towers, the LAION
ViT-H/14, ViT-g/14 and ViT-bigG/14), the ``Tiny``, ``TinyRN`` and
``TinyConvNeXt`` development architectures and, once ``models/zoo`` is
imported, the LAION ConvNeXt tag grid.  The
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
from .resnet import ModifiedResNet
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


# The OpenAI CLIP zoo (public shape facts), the LAION towers and dev archs.
CLIP_ARCHS: Dict[str, CLIPConfig] = {
    "RN50": CLIPConfig(1024, 224, (3, 4, 6, 3), 64, None, 77, 49408, 512, 8, 12),
    "RN101": CLIPConfig(512, 224, (3, 4, 23, 3), 64, None, 77, 49408, 512, 8, 12),
    "RN50x4": CLIPConfig(640, 288, (4, 6, 10, 6), 80, None, 77, 49408, 640, 10, 12),
    "RN50x16": CLIPConfig(768, 384, (6, 8, 18, 8), 96, None, 77, 49408, 768, 12, 12),
    "RN50x64": CLIPConfig(1024, 448, (3, 15, 36, 10), 128, None, 77, 49408, 1024, 16, 12),
    "ViT-B/32": CLIPConfig(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12),
    "ViT-B/16": CLIPConfig(512, 224, 12, 768, 16, 77, 49408, 512, 8, 12),
    "ViT-L/14": CLIPConfig(768, 224, 24, 1024, 14, 77, 49408, 768, 12, 12),
    "ViT-L/14@336px": CLIPConfig(768, 336, 24, 1024, 14, 77, 49408, 768, 12, 12),
    "Tiny": CLIPConfig(32, 32, 2, 64, 8, 77, 49408, 64, 1, 2),
    # tiny ModifiedResNet for tests (width 8 -> pool embed 256, 4 heads)
    "TinyRN": CLIPConfig(32, 32, (1, 1, 1, 1), 8, None, 77, 49408, 64, 1, 2),
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
            self.visual = ModifiedResNet(
                cfg.vision_layers, cfg.embed_dim, cfg.vision_heads,
                cfg.image_resolution, cfg.vision_width, dtype=dtype)
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


def config_from_state_dict_shapes(
        shapes: Dict[str, Tuple[int, ...]]) -> CLIPConfig:
    """The CLIPConfig of an OpenAI/open_clip CLIP state dict (ViT or
    ModifiedResNet), from its tensor shapes alone (JAX ``clip.py:206-286``).

    Head counts and the activation are not in the shapes: width // 64 heads
    and QuickGELU, unless every inferred field equals a registered row that
    overrides them (the LAION ViT-H/g/bigG: exact GELU, 16 vision heads for
    g and bigG), whose overrides are then taken."""
    is_vit = "visual.proj" in shapes
    if is_vit:
        vision_width = shapes["visual.conv1.weight"][0]
        vision_layers = len({k.split(".")[3] for k in shapes
                             if k.startswith("visual.transformer.resblocks.")})
        patch = shapes["visual.conv1.weight"][-1]
        grid = round((shapes["visual.positional_embedding"][0] - 1) ** 0.5)
        image_resolution = patch * grid
    else:
        vision_layers = tuple(
            len({k[len(f"visual.layer{s}."):].split(".")[0] for k in shapes
                 if k.startswith(f"visual.layer{s}.")}) for s in (1, 2, 3, 4))
        vision_width = shapes["visual.layer1.0.conv1.weight"][0]
        patch = None
        out_width = round(
            (shapes["visual.attnpool.positional_embedding"][0] - 1) ** 0.5)
        image_resolution = out_width * 32
    text_width = int(shapes["ln_final.weight"][0])

    def mlp_dim_of(prefix: str, width: int) -> int:
        key = f"{prefix}.resblocks.0.mlp.c_fc.weight"
        if key in shapes and shapes[key][0] != 4 * width:
            return int(shapes[key][0])
        return 0

    cfg = CLIPConfig(
        embed_dim=int(shapes["text_projection"][1]),
        image_resolution=int(image_resolution),
        vision_layers=(int(vision_layers) if is_vit
                       else tuple(int(c) for c in vision_layers)),
        vision_width=int(vision_width),
        vision_patch_size=int(patch) if patch else None,
        context_length=int(shapes["positional_embedding"][0]),
        vocab_size=int(shapes["token_embedding.weight"][0]),
        transformer_width=text_width,
        transformer_heads=text_width // 64,
        transformer_layers=len({k.split(".")[2] for k in shapes
                                if k.startswith("transformer.resblocks.")}),
        vision_mlp_dim=(mlp_dim_of("visual.transformer", int(vision_width))
                        if is_vit else 0),
        text_mlp_dim=mlp_dim_of("transformer", text_width))
    for arch in CLIP_ARCHS.values():
        if (arch.vision_heads_override or arch.act != cfg.act) and all(
                getattr(arch, f) == getattr(cfg, f) for f in (
                    "embed_dim", "image_resolution", "vision_layers",
                    "vision_width", "vision_patch_size", "context_length",
                    "vocab_size", "transformer_width", "transformer_layers",
                    "vision_mlp_dim", "text_mlp_dim")):
            return dataclasses.replace(
                cfg, vision_heads_override=arch.vision_heads_override,
                act=arch.act, transformer_heads=arch.transformer_heads)
    return cfg
