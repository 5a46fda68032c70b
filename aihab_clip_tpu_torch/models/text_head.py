"""Prompt-ensemble text classifier head (counterpart of
``aihab_clip_tpu/models/text_head.py``): encode each class's template
prompts, L2-normalize, mean over templates, re-normalize, stack ->
[dim, n_classes].  Works for ``CLIPModel`` and ``SigLIPModel`` alike:
both expose ``encode_text(tokens) -> (pre, projected)``.  Without a
``tokenize_fn`` the prompts take the CLIP BPE, truncated to the model's
context (64 for SigLIP), as in the JAX package."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..tokenizer import tokenize


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp_min(eps)


def compute_text_weights(model: nn.Module, tokens: torch.Tensor,
                         num_classes: int, num_templates: int) -> torch.Tensor:
    """[C*T, ctx] tokens -> [dim, C] ensemble classifier weights."""
    expected = num_classes * num_templates
    if tokens.shape[0] != expected:
        raise ValueError(
            f"Prompt token count mismatch: got {tokens.shape[0]}, expected "
            f"{expected} (= num_classes {num_classes} * num_templates "
            f"{num_templates}).")
    _, feats = model.encode_text(tokens)
    feats = l2_normalize(feats.float())
    feats = feats.reshape(num_classes, num_templates, -1).mean(dim=1)
    return l2_normalize(feats).T


@torch.inference_mode()
def build_text_head(model: nn.Module, prompts: Sequence[str],
                    num_classes: int, num_templates: int,
                    batch_size: int = 256,
                    context_length: Optional[int] = None,
                    tokenize_fn=None) -> Dict[str, Any]:
    """Tokenize (``tokenize_fn(texts, context_length) -> [N, ctx]`` ints,
    default the CLIP BPE) + batched encode.  Returns {'text_weights'
    [dim, C] fp32, 'text_weights_before' [C, T, pre] fp32,
    'prompt_tokens' [C*T, ctx] int32, 'num_templates'}, tensors on the
    model's device."""
    ctx = context_length or model.config.context_length
    tok = tokenize_fn or (lambda texts, context_length: tokenize(
        texts, context_length=context_length, truncate=True))
    device = model.logit_scale.device
    tokens = torch.from_numpy(np.asarray(tok(list(prompts), ctx),
                                         dtype=np.int32)).to(device)
    pre, post = [], []
    for start in range(0, tokens.shape[0], batch_size):
        p, q = model.encode_text(tokens[start:start + batch_size])
        pre.append(p.float())
        post.append(q.float())
    pre, post = torch.cat(pre), torch.cat(post)
    post = l2_normalize(post).reshape(num_classes, num_templates, -1).mean(1)
    return {
        "text_weights": l2_normalize(post).T.contiguous(),
        "text_weights_before": pre.reshape(num_classes, num_templates, -1),
        "prompt_tokens": tokens,
        "num_templates": num_templates,
    }


def classifier_logits(image_features: torch.Tensor, text_weights: torch.Tensor,
                      scale: float = 100.0) -> torch.Tensor:
    """scale * normalize(img) @ text_weights (logit_scale intentionally
    ignored, as in the reference's PEFT evaluation)."""
    return scale * l2_normalize(image_features.float()) @ text_weights
