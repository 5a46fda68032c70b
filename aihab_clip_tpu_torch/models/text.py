"""CLIP text transformer tower (counterpart of
``aihab_clip_tpu/models/text.py``): token + positional embedding -> causal
transformer -> ln_final -> pool at the EOT position (argmax of the token
ids) -> ``(pre_projection, projected)``."""

from __future__ import annotations

import torch
from torch import nn

from .layers import LayerNorm, Transformer


class TextTransformer(nn.Module):
    def __init__(self, context_length: int, vocab_size: int, width: int,
                 layers: int, heads: int, embed_dim: int, mlp_dim: int = 0,
                 act: str = "quick_gelu", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype  # compute dtype; parameters stay fp32
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, causal=True,
                                       mlp_dim=mlp_dim, act=act)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor):
        """tokens [B, context_length] int -> (pre [B, W], projected [B, E])."""
        x = self.token_embedding.weight[tokens.long()].to(self.dtype)
        x = x + self.positional_embedding.to(self.dtype)
        x = self.ln_final(self.transformer(x))
        pre = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return pre, pre @ self.text_projection.to(pre.dtype)
