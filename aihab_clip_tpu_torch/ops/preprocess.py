"""Eval preprocessing on the device (counterpart of
``aihab_clip_tpu/ops/preprocess.py:76-162``).

The deterministic CLIP eval transform — antialiased bicubic resize of the
shorter side, center crop, normalize — as two separable resize matmuls
with host-built weight matrices.  The matmuls stay ``torch.matmul`` (the
JAX package left them to XLA) and run in full fp32: ``eval_transform``
turns TF32 off for both cuBLAS and cuDNN, because TF32 keeps about three
decimal digits and would move pixel values.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# CLIP visual normalization statistics
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _np_keys_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    w1 = (a + 2) * x3 - (a + 3) * x2 + 1
    w2 = a * x3 - 5 * a * x2 + 8 * a * x - 4 * a
    return np.where(x <= 1, w1, np.where(x < 2, w2, 0.0))


def _resize_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] antialiased-bicubic resize weights (``jax.image.resize``'s
    weight matrix: scale out/in, Keys a=-0.5, antialias support scaling)."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    w = _np_keys_cubic(x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    ok = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(ok[:, None], w, 0).astype(np.float32)


@lru_cache(maxsize=32)
def _eval_weight_mats(h: int, w: int, resolution: int):
    """Rh [res, h], Rw [res, w]: resize-shorter-side (torchvision: the long
    side truncated) + center crop (torchvision: ``round`` offsets) as two
    1-D weight matrices."""
    if h <= w:
        nh, nw = resolution, int(resolution * w / h)
    else:
        nh, nw = int(resolution * h / w), resolution
    mh = _resize_weight_mat(h, nh)
    mw = _resize_weight_mat(w, nw)
    top, left = (int(round((nh - resolution) / 2.0)),
                 int(round((nw - resolution) / 2.0)))
    return mh[top:top + resolution], mw[left:left + resolution]


def normalize_stats_for(config):
    """Pixel normalization stats for a model family: SigLIP checkpoints use
    0.5/0.5 (``models/siglip.py:siglip_normalize_stats``), everything else
    CLIP's stats."""
    from ..models.siglip import SigLIPConfig, siglip_normalize_stats

    if isinstance(config, SigLIPConfig):
        return siglip_normalize_stats()
    return CLIP_MEAN, CLIP_STD


def eval_transform(images_u8: torch.Tensor, resolution: int,
                   dtype=torch.float32, mean=CLIP_MEAN,
                   std=CLIP_STD) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, res, res, 3] normalized ``dtype`` (NHWC),
    on the images' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w = images_u8.shape[1:3]
    rh, rw = _eval_weight_mats(int(h), int(w), resolution)
    dev = images_u8.device
    x = images_u8.to(torch.float32).permute(0, 3, 1, 2)       # [B, C, H, W]
    x = torch.matmul(torch.from_numpy(rh).to(dev), x)         # [B, C, r, W]
    x = torch.matmul(x, torch.from_numpy(rw).to(dev).T)       # [B, C, r, r]
    m = torch.tensor(mean, dtype=torch.float32, device=dev)[:, None, None]
    s = torch.tensor(std, dtype=torch.float32, device=dev)[:, None, None]
    x = (x * (1.0 / 255.0) - m) / s
    return x.to(dtype).permute(0, 2, 3, 1).contiguous()
