"""The fine-tune's train augment in plain float32: per image a
RandomResizedCrop box (scale 0.5-1, ratio 3/4-4/3, ten attempts, torchvision's
fallback), the crop resized by separable antialiased bicubic weights
(Keys a = -0.5, the support widened by the downscale factor, rows summing
to one), then one rotation a batch, uniform in [-30, 30] degrees, as three
shears x-y-x (each row moved by a cubic fractional translation, mass that
leaves the image lost, which is a zero fill), clipped to 0..255 and
normalised.

The draws come from a CPU ``torch.Generator`` in this order: one
[B, 22] uniform block for the boxes (ten areas, ten log-ratios, the top and
the left), then one uniform scalar for the angle.
"""

from __future__ import annotations

import math

import torch


def cubic(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    x = t.abs()
    near = (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
    far = a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
    return torch.where(x <= 1, near, torch.where(x < 2, far,
                                                 torch.zeros_like(x)))


def crop_boxes(gen: torch.Generator, n: int, h: int, w: int):
    """[n, 4] (top, left, height, width)."""
    u = torch.rand(n, 22, generator=gen)
    area = (0.5 + 0.5 * u[:, :10]) * h * w
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    ratio = torch.exp(lo + (hi - lo) * u[:, 10:20])
    cw = torch.round(torch.sqrt(area * ratio))
    ch = torch.round(torch.sqrt(area / ratio))
    fits = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    boxes = []
    for i in range(n):
        ok = torch.nonzero(fits[i])
        if len(ok):
            j = int(ok[0])
            bh, bw = float(ch[i, j]), float(cw[i, j])
            top = math.floor(float(u[i, 20]) * (h - bh + 1))
            left = math.floor(float(u[i, 21]) * (w - bw + 1))
        else:
            bw = float(w) if w / h <= 4 / 3 else float(round(h * 4 / 3))
            bh = float(round(w / (3 / 4))) if w / h < 3 / 4 else float(h)
            top, left = round((h - bh) / 2), round((w - bw) / 2)
        boxes.append((top, left, bh, bw))
    return torch.tensor(boxes, dtype=torch.float32)


def _resample(start, length, n_out: int, n_in: int, device):
    """[B, n_out, n_in] weights: output o samples start + (o + 0.5) *
    length / n_out - 0.5."""
    scale = (length / n_out).to(device)
    o = torch.arange(n_out, device=device, dtype=torch.float32)
    i = torch.arange(n_in, device=device, dtype=torch.float32)
    src = start.to(device)[:, None] + (o[None] + 0.5) * scale[:, None] - 0.5
    wts = cubic((i[None, None] - src[..., None])
                / scale.clamp_min(1.0)[:, None, None])
    return wts / wts.sum(-1, keepdim=True).clamp_min(1e-8)


def _shear(offsets, size: int):
    """[size, size, size]: out[y, x] = in[y, x + offsets[y]] (cubic)."""
    x = torch.arange(size, dtype=torch.float32, device=offsets.device)
    return cubic(x[None, None] - (x[None, :] + offsets[:, None])[..., None])


def augment(images_u8: torch.Tensor, gen: torch.Generator, res: int, mean,
            std) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32 [B, res, res, 3]."""
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    box = crop_boxes(gen, b, h, w)
    wy = _resample(box[:, 0], box[:, 2], res, h, dev)
    wx = _resample(box[:, 1], box[:, 3], res, w, dev)
    x = torch.einsum("boh,bhwc->bowc", wy, images_u8.float())
    x = torch.einsum("bpw,bowc->bopc", wx, x)
    theta = math.radians(-30.0 + 60.0 * float(torch.rand((), generator=gen)))
    y = torch.arange(res, dtype=torch.float32, device=dev) - (res - 1) / 2.0
    theta_t = torch.tensor(theta, dtype=torch.float32, device=dev)
    sx = _shear(-torch.tan(theta_t / 2) * y, res)
    sy = _shear(torch.sin(theta_t) * y, res)
    x = torch.einsum("yxj,byjc->byxc", sx, x)
    x = torch.einsum("xyj,bjxc->byxc", sy, x)
    x = torch.einsum("yxj,byjc->byxc", sx, x)
    m = torch.tensor(mean, device=dev)
    s = torch.tensor(std, device=dev)
    return (x.clamp(0, 255) / 255.0 - m) / s
