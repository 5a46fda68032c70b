"""ConvNeXt-CLIP vision tower (counterpart of
``aihab_clip_tpu/models/convnext.py``).

The LAION ConvNeXt-CLIP family (``convnext_base_w`` and the rest of
open_clip's tag grid).  Public input is NHWC, as in the JAX package; each
conv runs on a channels-last view of it (``permute(0, 3, 1, 2)``, no copy),
so the activations stay NHWC throughout.

Block (timm ConvNeXt, channels-last): depthwise 7x7 conv -> LayerNorm (eps
1e-6, fp32) -> Linear 4C -> exact GELU -> Linear C -> layer-scale gamma ->
+ the block input.  The tower: a 4x4 stride-4 stem conv + LN, then per stage
s > 0 an LN + 2x2 stride-2 downsample conv before its blocks, a global mean
pool, ``head_norm`` and the ``linear`` (``head_proj``) or ``mlp``
(``head_fc1`` -> exact GELU -> ``head_fc2``) head.  The pre-projection
feature is the post-``head_norm`` pooled vector.

Module attributes carry the flax names (``stem_conv``, ``down_norm_1``,
``stage2_block5.fc1``, ``head_proj`` ...), so ``models/convert.py`` carries a
JAX parameter tree by name and the PEFT lock groups read it;
``openclip_convnext_state_dict_to_port`` renames an open_clip checkpoint's
timm trunk and head onto them (JAX ``convnext.py:240-352``).
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GatherBlock, LayerNorm, linear


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
              stride: int = 1, padding: int = 0, groups: int = 1):
    """A conv over NHWC ``x`` with an OIHW weight, in x's dtype: run on the
    channels-last view of x, returned as NHWC (no copy either way)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


class ConvNeXtBlock(GatherBlock):
    """One block; under FSDP it gathers its own weights as it runs
    (``GatherBlock``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x, self.dwconv.weight, self.dwconv.bias, padding=3,
                      groups=x.shape[-1])
        y = F.gelu(linear(self.norm(y), self.fc1.weight, self.fc1.bias))
        y = linear(y, self.fc2.weight, self.fc2.bias)
        return x + y * self.gamma.to(x.dtype)


def stage_blocks(depths, start: int, stop: int):
    """(stage, block in its stage, global index) of the blocks [start, stop)
    of the global depth order over all stages."""
    k = 0
    for s, depth in enumerate(depths):
        for b in range(depth):
            if start <= k < stop:
                yield s, b, k
            k += 1


class ConvNeXtVisionTower(nn.Module):
    """ConvNeXt trunk + CLIP projection head; fp32 parameters, computing in
    ``dtype``.  ``forward(x, project=False)`` returns the pre-projection
    pooled feature (``dims[-1]`` wide); ``project=True`` returns ``(pre,
    projected)``."""

    def __init__(self, depths: Tuple[int, ...], width: int, output_dim: int,
                 proj: str = "linear", dtype=torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.proj = proj
        self.dtype = dtype  # compute dtype; parameters stay fp32
        dims = [width * 2 ** i for i in range(len(self.depths))]
        self.stem_conv = nn.Conv2d(3, dims[0], 4, 4)
        self.stem_norm = LayerNorm(dims[0], eps=1e-6)
        for s, depth in enumerate(self.depths):
            if s:
                setattr(self, f"down_norm_{s}",
                        LayerNorm(dims[s - 1], eps=1e-6))
                setattr(self, f"down_conv_{s}",
                        nn.Conv2d(dims[s - 1], dims[s], 2, 2))
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}", ConvNeXtBlock(dims[s]))
        self.head_norm = LayerNorm(dims[-1], eps=1e-6)
        if proj == "mlp":
            self.head_fc1 = nn.Linear(dims[-1], 2 * output_dim)
            self.head_fc2 = nn.Linear(2 * output_dim, output_dim)
        else:
            self.head_proj = nn.Linear(dims[-1], output_dim)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images (in the dtype to compute in) -> stage-0 activations."""
        x = conv_nhwc(x, self.stem_conv.weight, self.stem_conv.bias, stride=4)
        return self.stem_norm(x)

    def blocks(self, x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        """Blocks [start, stop) in depth order, each stage's downsample
        before its first block (``x`` is the activation before ``start``)."""
        for s, b, _ in stage_blocks(self.depths, start, stop):
            if s and b == 0:
                conv = getattr(self, f"down_conv_{s}")
                x = conv_nhwc(getattr(self, f"down_norm_{s}")(x), conv.weight,
                              conv.bias, stride=2)
            x = getattr(self, f"stage{s}_block{b}")(x)
        return x

    def head(self, x: torch.Tensor, *, project: bool = False):
        pre = self.head_norm(x.mean(dim=(1, 2)))
        if not project:
            return pre
        if self.proj == "mlp":
            y = F.gelu(linear(pre, self.head_fc1.weight, self.head_fc1.bias))
            y = linear(y, self.head_fc2.weight, self.head_fc2.bias)
        else:
            y = linear(pre, self.head_proj.weight, self.head_proj.bias)
        return pre, y

    def forward(self, x: torch.Tensor, *, project: bool = False):
        x = self.stem(x.to(self.dtype))
        x = self.blocks(x, 0, sum(self.depths))
        return self.head(x, project=project)


# ---------------------------------------------------------------------------
# tag grid
# ---------------------------------------------------------------------------

# (embed_dim, resolution, width, depths, text_width, text_heads,
#  text_layers, proj) — shape facts of the public open_clip model configs
_CONVNEXT_GRID: Dict[str, tuple] = {
    "convnext_base":        (512, 224, 128, (3, 3, 27, 3), 512, 8, 12,
                             "linear"),
    "convnext_base_w":      (640, 256, 128, (3, 3, 27, 3), 640, 10, 12,
                             "linear"),
    "convnext_base_w_320":  (640, 320, 128, (3, 3, 27, 3), 640, 10, 12,
                             "linear"),
    "convnext_large_d":     (768, 256, 192, (3, 3, 27, 3), 768, 12, 16,
                             "mlp"),
    "convnext_large_d_320": (768, 320, 192, (3, 3, 27, 3), 768, 12, 16,
                             "mlp"),
    "convnext_xxlarge":     (1024, 256, 384, (3, 4, 30, 3), 1024, 16, 24,
                             "linear"),
}


def register_convnext_archs() -> None:
    """Add the LAION tag grid to ``CLIP_ARCHS`` (idempotent), so
    ``random:convnext_base_w`` etc. resolve through the zoo."""
    from .clip import CLIP_ARCHS

    for tag in _CONVNEXT_GRID:
        CLIP_ARCHS.setdefault(tag, convnext_config_for_name(tag))


def convnext_config_for_name(name: str):
    """An open_clip/LAION ConvNeXt tag (or a name embedding one, e.g.
    ``laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft``) -> its
    CLIPConfig; None when the name is no ConvNeXt tag; an unknown ConvNeXt
    variant raises rather than guess its dimensions."""
    from .clip import CLIPConfig

    low = name.lower().replace("-", "_")
    # the longest matching tag, so _320 and _d variants win over prefixes
    best = None
    for tag in _CONVNEXT_GRID:
        if tag in low and (best is None or len(tag) > len(best)):
            best = tag
    if best is None:
        if re.search(r"convnext", low):
            raise ValueError(
                f"Unrecognized ConvNeXt variant in '{name}' — known tags: "
                f"{sorted(_CONVNEXT_GRID)}")
        return None
    (embed, res, width, depths, t_width, t_heads, t_layers,
     proj) = _CONVNEXT_GRID[best]
    return CLIPConfig(
        embed_dim=embed, image_resolution=res, vision_layers=depths,
        vision_width=width, vision_patch_size=None, context_length=77,
        vocab_size=49408, transformer_width=t_width,
        transformer_heads=t_heads, transformer_layers=t_layers,
        act="gelu", vision_tower="convnext", vision_proj=proj)


def convnext_config_from_shapes(shapes: Mapping[str, tuple]):
    """The CLIPConfig of an open_clip ConvNeXt state dict, from its tensor
    shapes (authoritative over the tag table).  The resolution is not in
    the weights: 256 here, as in JAX."""
    from .clip import CLIPConfig

    width = shapes["visual.trunk.stem.0.weight"][0]
    n_stages = 1 + len({k.split(".")[3] for k in shapes
                        if re.match(r"visual\.trunk\.stages\.[1-9]", k)})
    depths = []
    for s in range(n_stages):
        blocks = {k.split(".")[5] for k in shapes
                  if k.startswith(f"visual.trunk.stages.{s}.blocks.")}
        depths.append(len(blocks))
    if "visual.head.proj.weight" in shapes:
        proj = "linear"
        embed = shapes["visual.head.proj.weight"][0]
    else:
        proj = "mlp"
        embed = shapes["visual.head.mlp.fc2.weight"][0]
    t_width = shapes["ln_final.weight"][0]
    t_layers = len({k.split(".")[2] for k in shapes
                    if k.startswith("transformer.resblocks.")})
    return CLIPConfig(
        embed_dim=int(embed), image_resolution=256,
        vision_layers=tuple(int(d) for d in depths),
        vision_width=int(width), vision_patch_size=None, context_length=77,
        vocab_size=int(shapes["token_embedding.weight"][0]),
        transformer_width=int(t_width),
        transformer_heads=int(t_width) // 64,
        transformer_layers=int(t_layers),
        act="gelu", vision_tower="convnext", vision_proj=proj)


def openclip_convnext_state_dict_to_port(state_dict: Mapping[str, torch.Tensor],
                                         resolution: int = 0):
    """An open_clip ``CLIP-convnext_*`` state dict (fp32 tensors, after
    ``convert.clean_state_dict``) -> (CLIPConfig, the port's state dict).
    The trunk follows timm's names under ``visual.trunk.``, the head
    open_clip's under ``visual.head.``, the text tower OpenAI's; every
    weight keeps its layout.  ``resolution`` is not in the weights: 0 warns
    and takes 256, as JAX does.  open_clip exports the head without its
    bias (``proj_bias=False``): a missing ``head_proj`` / ``head_fc2`` bias
    is zeros."""
    from .convert import text_key

    cfg = convnext_config_from_shapes({k: tuple(v.shape)
                                       for k, v in state_dict.items()})
    if resolution:
        cfg = dataclasses.replace(cfg, image_resolution=int(resolution))
    else:
        warnings.warn(
            "ConvNeXt checkpoint resolution is not inferable from weights; "
            f"defaulting to {cfg.image_resolution}px.  Pass resolution= "
            "(224 for convnext_base, 256 for _w/large_d/xxlarge, 320 for "
            "*_320 variants) to silence this and evaluate at the trained "
            "resolution.")
    out: Dict[str, torch.Tensor] = {}
    for key, v in state_dict.items():
        p = key.split(".")
        if not key.startswith("visual."):
            out[text_key(key)] = v
        elif key.startswith("visual.trunk.stem."):
            out[f"visual.stem_{'conv' if p[3] == '0' else 'norm'}.{p[4]}"] = v
        elif key.startswith("visual.trunk.stages.") and p[4] == "downsample":
            mod = "down_norm" if p[5] == "0" else "down_conv"
            out[f"visual.{mod}_{p[3]}.{p[6]}"] = v
        elif key.startswith("visual.trunk.stages.") and p[4] == "blocks":
            blk = f"visual.stage{p[3]}_block{p[5]}"
            if p[6] == "gamma":
                out[f"{blk}.gamma"] = v
            elif p[6] in ("conv_dw", "norm"):
                out[f"{blk}.{'dwconv' if p[6] == 'conv_dw' else 'norm'}."
                    f"{p[7]}"] = v
            elif p[6] == "mlp":
                out[f"{blk}.{p[7]}.{p[8]}"] = v
            else:
                raise KeyError(f"Unhandled block key: {key}")
        elif key.startswith("visual.trunk.head.norm."):
            out[f"visual.head_norm.{p[4]}"] = v
        elif key.startswith("visual.head.proj."):
            out[f"visual.head_proj.{p[3]}"] = v
        elif key.startswith("visual.head.mlp."):
            out[f"visual.head_{p[3]}.{p[4]}"] = v
        else:
            raise KeyError(f"Unhandled checkpoint key: {key}")
    for mod in ("head_proj", "head_fc2"):
        w = out.get(f"visual.{mod}.weight")
        if w is not None and f"visual.{mod}.bias" not in out:
            out[f"visual.{mod}.bias"] = torch.zeros(w.shape[0])
    return cfg, out
