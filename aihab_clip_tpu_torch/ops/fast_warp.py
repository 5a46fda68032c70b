"""Matmul-formulated train augmentation (counterpart of
``aihab_clip_tpu/ops/fast_warp.py:46-188``).

  * crop + flip + resize are separable: per-image 1-D bicubic weight
    matrices Wy [B, out, H] and Wx [B, out, W], built with broadcast
    arithmetic, applied as two batched matmuls.  Antialiasing widens the
    kernel support by the per-image downscale factor, like PIL/torchvision;
  * rotation is the 3-shear decomposition R(θ) = Shx(-tan θ/2) · Shy(sin θ)
    · Shx(-tan θ/2), each shear a per-row 1-D fractional translation as one
    [S, S, S] weight tensor shared by the batch, so the angle is drawn once
    per batch step (the JAX path's documented relaxation); rows that leave
    the image lose weight mass, which is torchvision's zero fill.

These are plain fp32 products (XLA work in JAX, no TPU kernel): they run as
``torch.einsum`` with TF32 off, as ``eval_transform`` runs its matmuls.  The
random draws come from a ``torch.Generator`` on the host, so the boxes and
the angle differ from ``jax.random``'s for the same seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .preprocess import (CLIP_MEAN, CLIP_STD, _cubic_kernel,
                         _random_resized_crop_params, normalize)

CROP_MODES = ("random", "bottom", "center")


def _full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _linear_weight(t: torch.Tensor) -> torch.Tensor:
    return (1.0 - t.abs()).clamp_min(0.0)


def _resample_matrix(starts: torch.Tensor, scales: torch.Tensor,
                     out_size: int, in_size: int, method: str = "bicubic",
                     antialias: bool = True) -> torch.Tensor:
    """Per-image 1-D resampling weights W [B, out_size, in_size]: sample o
    maps to source coordinate starts + (o + 0.5) * scales - 0.5; the
    support widens by max(scale, 1) with antialiasing; rows sum to 1."""
    dev = starts.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    src = starts[:, None] + (o[None, :] + 0.5) * scales[:, None] - 0.5
    widen = scales.clamp_min(1.0) if antialias else torch.ones_like(scales)
    t = (i[None, None, :] - src[:, :, None]) / widen[:, None, None]
    w = _cubic_kernel(t) if method == "bicubic" else _linear_weight(t)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-8)


def separable_resize_crop(images: torch.Tensor, boxes: torch.Tensor,
                          out_size: int,
                          flip_mask: Optional[torch.Tensor] = None,
                          method: str = "bicubic", antialias: bool = True,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Crop + (flip) + resize as two batched matmuls.  images [B, H, W, C]
    (uint8 or float); boxes [B, 4] (top, left, crop_h, crop_w); flip_mask
    [B] bool, a horizontal mirror."""
    _full_fp32()
    b, h, w, c = images.shape
    boxes = boxes.to(images.device, torch.float32)
    top, left, ch, cw = boxes.unbind(-1)
    wy = _resample_matrix(top, ch / out_size, out_size, h, method, antialias)
    wx = _resample_matrix(left, cw / out_size, out_size, w, method, antialias)
    if flip_mask is not None:
        flip = flip_mask.to(images.device)[:, None, None]
        wx = torch.where(flip, wx.flip(1), wx)
    img = images.to(torch.float32)
    tmp = torch.einsum("boh,bhwc->bowc", wy, img)
    return torch.einsum("bpw,bowc->bopc", wx, tmp).to(out_dtype)


def _shear_matrix_x(offsets: torch.Tensor, size: int,
                    method: str = "bicubic") -> torch.Tensor:
    """Per-row translation weights S [size(y), size(x_out), size(x_in)] for
    out[y, x] = in[y, x + offsets[y]], not renormalised (mass that leaves
    the image is the zero fill)."""
    x = torch.arange(size, dtype=torch.float32, device=offsets.device)
    src = x[None, :] + offsets[:, None]
    t = x[None, None, :] - src[:, :, None]
    return _cubic_kernel(t) if method == "bicubic" else _linear_weight(t)


def rotate_shear(images: torch.Tensor, theta: float,
                 method: str = "bicubic") -> torch.Tensor:
    """Rotate a square batch [B, S, S, C] about its center by ``theta``
    radians with the 3-shear decomposition; zero fill outside the source."""
    _full_fp32()
    b, s, s2, c = images.shape
    if s != s2:
        raise ValueError(f"rotate_shear expects square images, got {s}x{s2}")
    y = torch.arange(s, dtype=torch.float32, device=images.device) \
        - (s - 1) / 2.0
    theta = torch.as_tensor(theta, dtype=torch.float32, device=images.device)
    sx = _shear_matrix_x(-torch.tan(theta / 2.0) * y, s, method)
    sy = _shear_matrix_x(torch.sin(theta) * y, s, method)
    x = images.to(torch.float32)
    x = torch.einsum("yxj,byjc->byxc", sx, x)   # shear x, per row
    x = torch.einsum("xyj,bjxc->byxc", sy, x)   # shear y, per column
    return torch.einsum("yxj,byjc->byxc", sx, x)


def train_boxes(generator: torch.Generator, n: int, h: int, w: int,
                resolution: int, crop_mode: str) -> torch.Tensor:
    """[n, 4] crop boxes of ``fast_train_transform``: RandomResizedCrop
    draws, or the bottom-aligned / centered square (``fast_warp.py:162-175``)."""
    if crop_mode == "random":
        return _random_resized_crop_params(generator, n, h, w)
    if crop_mode == "bottom":
        side = float(min(h, w, resolution))
        box = (float(h) - side, (w - side) // 2.0, side, side)
    elif crop_mode == "center":
        side = float(min(h, w))
        box = ((h - side) / 2.0, (w - side) / 2.0, side, side)
    else:
        raise ValueError(f"crop_mode {crop_mode!r} not in {CROP_MODES}")
    return torch.tensor(box, dtype=torch.float32).expand(n, 4)


def fast_train_transform(images_u8: torch.Tensor, generator: torch.Generator,
                         resolution: int, crop_mode: str = "random",
                         flip: bool = False, rotation: bool = False,
                         dtype=torch.float32, method: str = "bicubic",
                         antialias: bool = True, mean=CLIP_MEAN,
                         std=CLIP_STD) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> augmented, normalized [B, res, res, 3] in
    ``dtype`` on the images' device: per-image crop (and flip) through the
    separable matmuls, one rotation angle in [-30, 30] degrees per batch
    through the shears, clipped to 0..255, normalized.  The draws (boxes,
    flips, angle) come from ``generator`` on the host."""
    b, h, w, _ = images_u8.shape
    boxes = train_boxes(generator, b, h, w, resolution, crop_mode)
    flips = (torch.rand(b, generator=generator) < 0.5) if flip else None
    out = separable_resize_crop(images_u8, boxes, resolution, flip_mask=flips,
                                method=method, antialias=antialias)
    if rotation:
        deg = -30.0 + 60.0 * torch.rand((), generator=generator).item()
        out = rotate_shear(out, math.radians(deg), method=method)
    return normalize(out.clamp(0.0, 255.0), mean, std, dtype=dtype)
