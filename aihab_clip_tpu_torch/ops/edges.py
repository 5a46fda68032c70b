"""Edge-map augmentations (Canny) and multi-view transforms (counterpart of
``aihab_clip_tpu/ops/edges.py``), on uint8 ``torch`` tensors on their own
device, without OpenCV.

``canny_*`` compute ``cv2.Canny(img, t1, t2)`` (aperture 3, L1 gradient)
bit for bit in integer arithmetic, for every plane of a batch at once:

  * the 3x3 Sobel ``dx``/``dy`` with replicated borders, magnitude
    ``|dx| + |dy|``;
  * non-maximum suppression with OpenCV's fixed-point tan(22.5) test
    (``CANNY_SHIFT`` 15) and its asymmetric ``>`` / ``>=`` neighbour tests,
    pixels outside the image at magnitude 0;
  * thresholds floored (and swapped when ``t1 > t2``): a kept pixel above
    the high one is strong, above the low one weak;
  * hysteresis: 8-connected growth from the strong pixels through the weak
    ones, a dilation iterated to its fixed point; the host reads whether it
    moved only every ``HYSTERESIS_CHECK`` steps.

``rgb_to_gray`` is ``cv2.COLOR_RGB2GRAY``'s fixed point (OpenCV 5: weights
9798, 19235, 3735 over 2^15, rounded); ``edge_blend`` is ``cv2.addWeighted``
on uint8: fp32 ``fma(a, alpha, fma(b, beta, gamma))`` as its vector path
computes it, rounded half to even, saturated.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

CANNY_SHIFT = 15
TG22 = int(0.4142135623730950488016887242097 * (1 << CANNY_SHIFT) + 0.5)
GRAY_WEIGHTS = (9798, 19235, 3735)   # R, G, B over 2^15
GRAY_SHIFT = 15
HYSTERESIS_CHECK = 16


def _replicate_pad(x: torch.Tensor) -> torch.Tensor:
    """[P, H, W] -> [P, H + 2, W + 2], the border replicated."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], 1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], 2)


def _sobel(planes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [P, H, W] -> int32 (dx, dy) of the 3x3 Sobel."""
    h, w = planes.shape[1:]
    r = _replicate_pad(planes.to(torch.int32))
    left, right = r[:, :, :w], r[:, :, 2:]
    hx = right - left                               # [-1 0 1] per row
    dx = hx[:, :h] + 2 * hx[:, 1:h + 1] + hx[:, 2:]
    up, down = r[:, :h], r[:, 2:]
    vy = down - up                                  # [-1 0 1] per column
    dy = vy[:, :, :w] + 2 * vy[:, :, 1:w + 1] + vy[:, :, 2:]
    return dx, dy


def _dilate(e: torch.Tensor) -> torch.Tensor:
    """bool [P, H, W]: the 3x3 (8-connected) dilation, nothing outside."""
    h = e.clone()
    h[:, :, 1:] |= e[:, :, :-1]
    h[:, :, :-1] |= e[:, :, 1:]
    v = h.clone()
    v[:, 1:] |= h[:, :-1]
    v[:, :-1] |= h[:, 1:]
    return v


def canny_planes(planes: torch.Tensor, threshold1: float = 10,
                 threshold2: float = 50) -> torch.Tensor:
    """``cv2.Canny`` of each uint8 plane of [P, H, W] -> uint8 0/255."""
    if planes.dtype != torch.uint8 or planes.ndim != 3:
        raise TypeError(f"want uint8 [P, H, W] planes, got {planes.dtype} "
                        f"{tuple(planes.shape)}")
    low, high = sorted((float(threshold1), float(threshold2)))
    low, high = math.floor(low), math.floor(high)
    dx, dy = _sobel(planes)
    ax, ay = dx.abs(), dy.abs()
    m = ax + ay
    mp = torch.nn.functional.pad(m, (1, 1, 1, 1))   # outside: magnitude 0

    def at(dr, dc):
        return mp[:, 1 + dr:mp.shape[1] - 1 + dr, 1 + dc:mp.shape[2] - 1 + dc]

    y = ay << CANNY_SHIFT
    tg22x = ax * TG22
    tg67x = tg22x + (ax << (CANNY_SHIFT + 1))
    horizontal = y < tg22x
    vertical = ~horizontal & (y > tg67x)
    same_sign = (dx ^ dy) >= 0
    keep_h = (m > at(0, -1)) & (m >= at(0, 1))
    keep_v = (m > at(-1, 0)) & (m >= at(1, 0))
    keep_d = torch.where(same_sign, (m > at(-1, -1)) & (m > at(1, 1)),
                         (m > at(-1, 1)) & (m > at(1, -1)))
    weak = (m > low) & torch.where(horizontal, keep_h,
                                   torch.where(vertical, keep_v, keep_d))
    edges = weak & (m > high)
    count = int(edges.sum())
    while True:
        for _ in range(HYSTERESIS_CHECK):
            edges = weak & _dilate(edges)
        grown = int(edges.sum())
        if grown == count:
            break
        count = grown
    return edges.to(torch.uint8) * 255


def _batched(images: torch.Tensor, ndim: int) -> Tuple[torch.Tensor, bool]:
    single = images.ndim == ndim - 1
    return (images[None] if single else images), single


def canny_rgb(images_u8: torch.Tensor, threshold1: float = 10,
              threshold2: float = 50) -> torch.Tensor:
    """Per-channel Canny edge maps of a uint8 [B, H, W, 3] (or [H, W, 3])
    batch, merged back into 3 channels (reference ``CannyTransformRGB``)."""
    batch, single = _batched(images_u8, 4)
    b, h, w, c = batch.shape
    planes = batch.permute(0, 3, 1, 2).reshape(b * c, h, w)
    out = canny_planes(planes, threshold1, threshold2)
    out = out.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()
    return out[0] if single else out


def rgb_to_gray(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] RGB -> uint8 [...], ``cv2.COLOR_RGB2GRAY``."""
    x = images_u8.to(torch.int32)
    r, g, b = GRAY_WEIGHTS
    y = (x[..., 0] * r + x[..., 1] * g + x[..., 2] * b
         + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return y.to(torch.uint8)


def canny_grayscale(images_u8: torch.Tensor, threshold1: float = 10,
                    threshold2: float = 50) -> torch.Tensor:
    """Grayscale Canny edge map (reference ``CannyTransformGS``):
    uint8 [B, H, W, 3] -> [B, H, W] (or [H, W, 3] -> [H, W])."""
    batch, single = _batched(images_u8, 4)
    out = canny_planes(rgb_to_gray(batch), threshold1, threshold2)
    return out[0] if single else out


def edge_augment(images_u8: torch.Tensor, threshold1: float = 10,
                 threshold2: float = 50, alpha: float = 0.5,
                 beta: float = 0.5, gamma: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference ``EdgeAug``: (original, edge-map) pairs; callers
    concatenate along the batch (doubling the effective batch size)."""
    return images_u8, canny_rgb(images_u8, threshold1, threshold2)


def add_weighted(a_u8: torch.Tensor, alpha: float, b_u8: torch.Tensor,
                 beta: float, gamma: float) -> torch.Tensor:
    """``cv2.addWeighted`` on uint8: ``fma(a, alpha, fma(b, beta, gamma))``
    in fp32 (each fused step exact in fp64, then rounded to fp32), rounded
    half to even, saturated."""
    f32, f64 = torch.float32, torch.float64
    w = [float(torch.tensor(v, dtype=f32)) for v in (alpha, beta, gamma)]
    t = (b_u8.to(f64) * w[1] + w[2]).to(f32)
    t = (a_u8.to(f64) * w[0] + t.to(f64)).to(f32)
    return torch.round(t).clamp(0, 255).to(torch.uint8)


def edge_blend(images_u8: torch.Tensor, threshold1: float = 10,
               threshold2: float = 50, alpha: float = 0.5, beta: float = 0.5,
               gamma: float = 0.0) -> torch.Tensor:
    """Weighted blend of each image and its RGB edge map
    (``cv2.addWeighted`` semantics)."""
    edges = canny_rgb(images_u8, threshold1, threshold2)
    return add_weighted(images_u8, alpha, edges, beta, gamma)


def split_generator(generator: torch.Generator) -> List[torch.Generator]:
    """Two independent generators on ``generator``'s device, seeded from
    draws of it (the counterpart of ``jax.random.split``)."""
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(int(s))
            for s in seeds]


def two_view_batch(images_u8: torch.Tensor, generator: torch.Generator,
                   transform: Callable, transform2: Optional[Callable] = None,
                   **kw) -> List[torch.Tensor]:
    """Two augmented views of the same batch (SupCon-style):
    ``transform(images, generator, **kw)`` is a train transform with the
    port's signature (``ops.preprocess.train_transform``,
    ``ops.fast_warp.fast_train_transform``); the views draw from two
    independent generators split from ``generator`` (reference
    ``SupConTwoViewTransform`` / ``TwoViewTransform``)."""
    g1, g2 = split_generator(generator)
    t2 = transform2 or transform
    return [transform(images_u8, g1, **kw), t2(images_u8, g2, **kw)]
