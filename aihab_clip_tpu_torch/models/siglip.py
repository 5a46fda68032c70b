"""SigLIP towers (counterpart of ``aihab_clip_tpu/models/siglip.py``):
MAP-pooled vision transformer + non-causal text tower.

Covers the system's default backbone (``hf-hub:timm/ViT-SO400M-16-SigLIP2-384``,
``configs/base.yaml``):

  * vision: patchify conv (with bias) as a patch matmul + learned position
    embeddings (no CLS token, no ``ln_pre``), pre-LN blocks with tanh-GELU
    and a configurable MLP width (SO400M: 4304), ``ln_post``, and a MAP
    attention-pool head (a learned probe attends over all patch tokens,
    then LN + residual MLP).  SigLIP has no vision projection: the pooled
    feature is the embedding;
  * text: token + position embeddings, non-causal blocks, ``ln_final``,
    last-token pooling, a dense ``head``;
  * every LayerNorm has eps 1e-6.

Module and parameter names follow the JAX package's tree (``visual``/
``text``, ``transformer.resblocks.<i>``, ``attn.{q,k,v,out}_proj``,
``attnpool.{probe,attn,ln,mlp}``), so ``convert.flax_params_to_state_dict``
carries its parameters over.  Self-attention goes through
``ops.attention.attention``, the JAX dispatch: the fused kernel (K6, forward
and backward) for bf16 towers on the card at S in [512, 1536] (SO400M's 576
patch tokens), plain math otherwise (the text tower's S=64, fp32 towers, the
CPU).  The MAP probe's cross-attention stays plain math, as in JAX.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention, dot_product_attention
from .layers import LayerNorm, linear

LN_EPS = 1e-6


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    embed_dim: int               # output embedding width (= vision width)
    image_resolution: int
    patch_size: int
    vision_width: int
    vision_layers: int
    vision_heads: int
    vision_mlp_dim: int
    context_length: int
    vocab_size: int
    text_width: int
    text_layers: int
    text_heads: int
    text_mlp_dim: int

    # API compat with CLIPConfig consumers
    @property
    def is_vit(self) -> bool:
        return True

    @property
    def transformer_layers(self) -> int:
        return self.text_layers

    @property
    def vision_preproj_dim(self) -> int:
        return self.vision_width


# Named SigLIP architectures (public shape facts).
SIGLIP_ARCHS: Dict[str, SigLIPConfig] = {
    # SigLIP / SigLIP2 SO400M patch16 @384
    "ViT-SO400M-16-SigLIP2-384": SigLIPConfig(
        embed_dim=1152, image_resolution=384, patch_size=16,
        vision_width=1152, vision_layers=27, vision_heads=16,
        vision_mlp_dim=4304,
        context_length=64, vocab_size=256000,
        text_width=1152, text_layers=27, text_heads=16, text_mlp_dim=4304),
    "ViT-B-16-SigLIP-224": SigLIPConfig(
        embed_dim=768, image_resolution=224, patch_size=16,
        vision_width=768, vision_layers=12, vision_heads=12,
        vision_mlp_dim=3072,
        context_length=64, vocab_size=32000,
        text_width=768, text_layers=12, text_heads=12, text_mlp_dim=3072),
    # tiny development arch
    "SigLIP-Tiny": SigLIPConfig(
        embed_dim=64, image_resolution=32, patch_size=8,
        vision_width=64, vision_layers=2, vision_heads=2, vision_mlp_dim=128,
        context_length=16, vocab_size=49408,
        text_width=64, text_layers=2, text_heads=2, text_mlp_dim=128),
}

# tower dimensions per open_clip/timm size token: (width, layers, heads, mlp)
_SIGLIP_TOWER_DIMS = {
    "B": (768, 12, 12, 3072),
    "L": (1024, 24, 16, 4096),
    "SO400M": (1152, 27, 16, 4304),
}
_SIGLIP_DEFAULT_RES = {"B": 224, "L": 256, "SO400M": 224}


def siglip_config_for_name(name: str) -> Optional[SigLIPConfig]:
    """Parse an open_clip/timm SigLIP tag ``ViT-<SIZE>-<PATCH>-SigLIP[2][-<RES>]``
    into a config (text tower mirrors the vision dims; vocab 32000 for
    SigLIP1, 256000 for SigLIP2; context 64).  None for tags outside the
    grid, and for resolutions the patch does not divide."""
    m = re.fullmatch(r"ViT-(B|L|SO400M)-(\d+)-SigLIP(2?)(?:-(\d+))?", name)
    if m is None:
        return None
    size, patch, two, res = m.group(1), int(m.group(2)), m.group(3), \
        m.group(4)
    width, layers, heads, mlp = _SIGLIP_TOWER_DIMS[size]
    resolution = int(res) if res else _SIGLIP_DEFAULT_RES[size]
    if resolution % patch:
        return None
    return SigLIPConfig(
        embed_dim=width, image_resolution=resolution, patch_size=patch,
        vision_width=width, vision_layers=layers, vision_heads=heads,
        vision_mlp_dim=mlp,
        context_length=64, vocab_size=256000 if two else 32000,
        text_width=width, text_layers=layers, text_heads=heads,
        text_mlp_dim=mlp)


class SigLIPMLP(nn.Module):
    """c_fc -> tanh-GELU -> c_proj."""

    def __init__(self, width: int, hidden_dim: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden_dim)
        self.c_proj = nn.Linear(hidden_dim, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu_tanh(linear(x, self.c_fc.weight, self.c_fc.bias))
        return linear(h, self.c_proj.weight, self.c_proj.bias)


class SigLIPAttention(nn.Module):
    """Separate q/k/v/out projections (HF Siglip layout); ``kv_in`` of
    another length than ``q_in`` makes it the MAP probe's cross-attention."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} not divisible by heads {heads}")
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, q_in: torch.Tensor,
                kv_in: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv_in = q_in if kv_in is None else kv_in
        q = linear(q_in, self.q_proj.weight, self.q_proj.bias)
        k = linear(kv_in, self.k_proj.weight, self.k_proj.bias)
        v = linear(kv_in, self.v_proj.weight, self.v_proj.bias)
        if q_in.shape[1] == kv_in.shape[1]:
            out = attention(q, k, v, self.heads)
        else:  # the MAP probe: one query, plain math
            out = dot_product_attention(q, k, v, self.heads)
        return linear(out, self.out_proj.weight, self.out_proj.bias)


class SigLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.ln_1 = LayerNorm(width, LN_EPS)
        self.attn = SigLIPAttention(width, heads)
        self.ln_2 = LayerNorm(width, LN_EPS)
        self.mlp = SigLIPMLP(width, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class SigLIPTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, mlp_dim: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            SigLIPBlock(width, heads, mlp_dim) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x)
        return x


class MAPHead(nn.Module):
    """Multihead attention pooling: a learned probe attends over tokens."""

    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.probe = nn.Parameter(torch.empty(1, 1, width))
        self.attn = SigLIPAttention(width, heads)
        self.ln = LayerNorm(width, LN_EPS)
        self.mlp = SigLIPMLP(width, mlp_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, _, w = tokens.shape
        probe = self.probe.to(tokens.dtype).expand(b, 1, w)
        x = self.attn(probe, tokens)
        x = x + self.mlp(self.ln(x))
        return x[:, 0, :]


class SigLIPVisionTower(nn.Module):
    """NHWC images -> pooled embedding (``(pooled, pooled)`` with
    ``project=True``: there is no separate projection)."""

    def __init__(self, config: SigLIPConfig, dtype=torch.float32):
        super().__init__()
        cfg = config
        self.patch_size = cfg.patch_size
        self.dtype = dtype  # compute dtype; parameters stay fp32
        self.conv1 = nn.Conv2d(3, cfg.vision_width, cfg.patch_size,
                               cfg.patch_size, bias=True)
        n_tokens = (cfg.image_resolution // cfg.patch_size) ** 2
        self.positional_embedding = nn.Parameter(
            torch.empty(n_tokens, cfg.vision_width))
        self.transformer = SigLIPTransformer(
            cfg.vision_width, cfg.vision_layers, cfg.vision_heads,
            cfg.vision_mlp_dim)
        self.ln_post = LayerNorm(cfg.vision_width, LN_EPS)
        self.attnpool = MAPHead(cfg.vision_width, cfg.vision_heads,
                                cfg.vision_mlp_dim)

    def patch_kernel(self) -> torch.Tensor:
        """conv1 as a [p*p*3, W] matrix matching NHWC patch rows."""
        w = self.conv1.weight                         # [W, C, p, p]
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])

    def forward(self, x: torch.Tensor, *, project: bool = False):
        x = x.to(self.dtype)
        b, h, w, c = x.shape
        p = self.patch_size
        patches = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = patches.reshape(b, (h // p) * (w // p), p * p * c) @ \
            self.patch_kernel().to(self.dtype)
        x = x + self.conv1.bias.to(self.dtype)
        x = x + self.positional_embedding.to(self.dtype)
        x = self.ln_post(self.transformer(x))
        pooled = self.attnpool(x)
        return (pooled, pooled) if project else pooled


class SigLIPTextTower(nn.Module):
    """tokens [B, context] -> (pre [B, W] at the LAST token, head(pre))."""

    def __init__(self, config: SigLIPConfig, dtype=torch.float32):
        super().__init__()
        cfg = config
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = SigLIPTransformer(
            cfg.text_width, cfg.text_layers, cfg.text_heads, cfg.text_mlp_dim)
        self.ln_final = LayerNorm(cfg.text_width, LN_EPS)
        self.head = nn.Linear(cfg.text_width, cfg.embed_dim)

    def forward(self, tokens: torch.Tensor):
        x = self.token_embedding.weight[tokens.long()].to(self.dtype)
        x = x + self.positional_embedding.to(self.dtype)
        x = self.ln_final(self.transformer(x))
        pre = x[:, -1, :]  # SigLIP pools the last token (fixed-pad inputs)
        return pre, linear(pre, self.head.weight, self.head.bias)


class SigLIPModel(nn.Module):
    """Vision + text towers + ``logit_scale``/``logit_bias``, with
    CLIPModel's encode API; fp32 parameters, computing in ``dtype``."""

    def __init__(self, config: SigLIPConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.visual = SigLIPVisionTower(config, dtype)
        self.text = SigLIPTextTower(config, dtype)
        self.logit_scale = nn.Parameter(torch.tensor(1.0))
        self.logit_bias = nn.Parameter(torch.tensor(0.0))

    def encode_image(self, images: torch.Tensor, *, project: bool = False):
        """images [B, H, W, 3] NHWC, normalized."""
        return self.visual(images, project=project)

    def encode_text(self, tokens: torch.Tensor):
        return self.text(tokens)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        """Pairwise sigmoid logits (the SigLIP objective):
        exp(t) * cos(img, txt) + b."""
        _, img = self.visual(images, project=True)
        _, txt = self.text(tokens)
        img = img / img.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        txt = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return self.logit_scale.exp() * img @ txt.T + self.logit_bias


@torch.no_grad()
def init_siglip_random_(model: SigLIPModel,
                        generator: torch.Generator) -> None:
    """Draw every parameter from ``generator``: normal weights at
    1/sqrt(fan_in), zero biases, unit LayerNorm scales, vision positions
    and the probe at 1/sqrt(width), token 0.02, text positions 0.01,
    ``logit_scale`` 1 and ``logit_bias`` 0 (the JAX package's values)."""
    for module in model.modules():
        if isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (nn.Linear, nn.Conv2d)):
            w = module.weight
            w.normal_(0.0, w[0].numel() ** -0.5, generator=generator)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 0.02, generator=generator)
    vis = model.config.vision_width ** -0.5
    model.visual.positional_embedding.normal_(0.0, vis, generator=generator)
    model.visual.attnpool.probe.normal_(0.0, vis, generator=generator)
    model.text.positional_embedding.normal_(0.0, 0.01, generator=generator)
    model.logit_scale.fill_(1.0)
    model.logit_bias.zero_()


def siglip_normalize_stats():
    """SigLIP checkpoints use 0.5/0.5 normalization, not CLIP's stats."""
    return (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
