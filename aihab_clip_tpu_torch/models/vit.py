"""CLIP Vision Transformer tower (counterpart of
``aihab_clip_tpu/models/vit.py``).

Public input is NHWC, as in the JAX package.  ``forward`` returns the
post-``ln_post`` CLS feature (pre-projection) and, with ``project=True``,
the pair ``(pre, projected)``.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import LayerNorm, Transformer


class VisionTransformer(nn.Module):
    def __init__(self, input_resolution: int, patch_size: int, width: int,
                 layers: int, heads: int, output_dim: int, mlp_dim: int = 0,
                 act: str = "quick_gelu", dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype  # compute dtype; parameters stay fp32
        # stride = kernel = patch conv, OIHW weight; applied as a patch matmul
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        n_tokens = (input_resolution // patch_size) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.empty(n_tokens, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, mlp_dim=mlp_dim,
                                       act=act)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

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
        cls = self.class_embedding.to(self.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
        x = self.transformer(self.ln_pre(x))
        pre = self.ln_post(x[:, 0, :])
        if not project:
            return pre
        return pre, pre @ self.proj.to(pre.dtype)
