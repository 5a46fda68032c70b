"""Preprocessing on the device (counterpart of
``aihab_clip_tpu/ops/preprocess.py``).

The deterministic CLIP eval transform — antialiased bicubic resize of the
shorter side, center crop, normalize — as two separable resize matmuls
with host-built weight matrices.  The matmuls stay ``torch.matmul`` (the
JAX package left them to XLA) and run in full fp32: ``eval_transform``
turns TF32 off for both cuBLAS and cuDNN, because TF32 keeps about three
decimal digits and would move pixel values.  The pieces of the train
augmentation that ``ops/fast_warp.py`` builds on: ``normalize``, the Keys
cubic kernel and the RandomResizedCrop box draw (from a ``torch.Generator``).

``train_transform`` is the JAX package's exact train augment (``aug_impl:
exact``, ``preprocess.py:335-413``): per image one affine map from output to
input pixels (crop box, then flip, then a rotation about the output centre),
sampled by gathering 4 x 4 bicubic (or 2 x 2 bilinear) taps of the source
with edge clamping (``affine_warp``), samples outside the source set to 0,
then after a rotation every output pixel whose rotated position leaves the
crop frame set to 0 (the reference rotates the cropped image with fill 0),
clipped to 0..255 and normalized.  Plain PyTorch (JAX left it to XLA).  Its
draws come from a ``torch.Generator``, so it equals JAX's only given the
same maps: ``warp_normalize`` takes them.
"""

from __future__ import annotations

from functools import lru_cache

import math

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


def normalize(images: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
              dtype=torch.float32) -> torch.Tensor:
    """[..., 3] pixels in 0..255 (uint8 or float) -> normalized ``dtype``
    (``preprocess.py:41``)."""
    x = images.to(torch.float32) * (1.0 / 255.0)
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((x - m) / s).to(dtype)


def _cubic_kernel(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Keys cubic convolution kernel (a=-0.5 = Catmull-Rom, PIL's BICUBIC;
    ``preprocess.py:169``)."""
    at = t.abs()
    at2, at3 = at * at, at * at * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    return torch.where(at <= 1.0, w1,
                       torch.where(at < 2.0, w2, torch.zeros_like(at)))


def _random_resized_crop_params(generator: torch.Generator, n: int, h: int,
                                w: int, scale=(0.5, 1.0),
                                ratio=(3.0 / 4.0, 4.0 / 3.0)) -> torch.Tensor:
    """``n`` crop boxes [n, 4] fp32 (top, left, crop_h, crop_w) following
    torchvision RandomResizedCrop (``preprocess.py:293-330``): 10 attempts
    of (area, log-ratio) draws, the first that fits wins, else the largest
    center crop within the ratio bounds.  Drawn on the host from
    ``generator``."""
    attempts = 10
    u = torch.rand(n, 2 * attempts + 2, generator=generator)
    target_area = (scale[0] + (scale[1] - scale[0]) * u[:, :attempts]) * h * w
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u[:, attempts:2 * attempts])
    cw = torch.round(torch.sqrt(target_area * aspect))
    ch = torch.round(torch.sqrt(target_area / aspect))
    ok = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    idx = ok.int().argmax(-1, keepdim=True)          # first success
    any_ok = ok.any(-1)
    cw_s = cw.gather(-1, idx)[:, 0]
    ch_s = ch.gather(-1, idx)[:, 0]
    top = torch.floor(u[:, -2] * (h - ch_s + 1))
    left = torch.floor(u[:, -1] * (w - cw_s + 1))

    in_ratio = w / h
    fb_w = float(w) if in_ratio <= ratio[1] else float(round(h * ratio[1]))
    fb_h = float(round(w / ratio[0])) if in_ratio < ratio[0] else float(h)
    fb_top, fb_left = float(round((h - fb_h) / 2.0)), \
        float(round((w - fb_w) / 2.0))
    box = torch.stack([
        torch.where(any_ok, top, torch.full_like(top, fb_top)),
        torch.where(any_ok, left, torch.full_like(left, fb_left)),
        torch.where(any_ok, ch_s, torch.full_like(ch_s, fb_h)),
        torch.where(any_ok, cw_s, torch.full_like(cw_s, fb_w))], -1)
    return box.float()


# ---------------------------------------------------------------------------
# The exact train augment: per-image affine maps, gathered taps
# ---------------------------------------------------------------------------


def _gather_pixels(flat: torch.Tensor, h: int, w: int, iy: torch.Tensor,
                   ix: torch.Tensor) -> torch.Tensor:
    """flat [B, H*W, C]; iy/ix [B, N] integer -> [B, N, C] in fp32, the
    indices clamped to the image (``preprocess.py:179-185``)."""
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    c = flat.shape[-1]
    return torch.gather(flat, 1, idx.unsqueeze(-1).expand(-1, -1, c)).float()


def _sample_bicubic(flat, h: int, w: int, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Sample [B, H*W, C] at float coordinates ys/xs [B, N] -> [B, N, C]:
    the separable 4 x 4 Keys cubic, taps clamped to the edge, normalised by
    the weights' sum (``preprocess.py:188-207``)."""
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ty, tx = ys - y0, xs - x0
    y0i, x0i = y0.long(), x0.long()
    acc = wsum = 0.0
    for dy in range(-1, 3):
        wy = _cubic_kernel(ty - dy)
        for dx in range(-1, 3):
            wgt = (wy * _cubic_kernel(tx - dx)).unsqueeze(-1)
            acc = acc + wgt * _gather_pixels(flat, h, w, y0i + dy, x0i + dx)
            wsum = wsum + wgt
    return acc / torch.clamp(wsum, min=1e-8)


def _sample_bilinear(flat, h: int, w: int, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """The 2 x 2 bilinear sample (``preprocess.py:210-223``)."""
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ty, tx = (ys - y0).unsqueeze(-1), (xs - x0).unsqueeze(-1)
    y0i, x0i = y0.long(), x0.long()
    p00 = _gather_pixels(flat, h, w, y0i, x0i)
    p01 = _gather_pixels(flat, h, w, y0i, x0i + 1)
    p10 = _gather_pixels(flat, h, w, y0i + 1, x0i)
    p11 = _gather_pixels(flat, h, w, y0i + 1, x0i + 1)
    top = p00 * (1 - tx) + p01 * tx
    bot = p10 * (1 - tx) + p11 * tx
    return top * (1 - ty) + bot * ty


def _out_coords(out_size: int, device) -> torch.Tensor:
    """Homogeneous output pixel centres [3, N] (x + 0.5, y + 0.5, 1), row
    by row."""
    ys, xs = torch.meshgrid(
        torch.arange(out_size, dtype=torch.float32, device=device),
        torch.arange(out_size, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5,
                        torch.ones(out_size * out_size, device=device)], 0)


def _apply_affine(mats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """[B, 2, 3] maps of [3, N] coordinates -> [B, 2, N], each row summed in
    fp32 elementwise (no TF32 matmul on a card)."""
    return (mats[:, :, 0:1] * coords[0] + mats[:, :, 1:2] * coords[1]
            + mats[:, :, 2:3] * coords[2])


def affine_warp(images: torch.Tensor, matrices: torch.Tensor, out_size: int,
                method: str = "bicubic", fill: float = 0.0) -> torch.Tensor:
    """Warp a batch with per-image affine maps from output to input pixel
    coordinates (``preprocess.py:226-258``).  images [B, H, W, C] (uint8 or
    float); matrices [B, 2, 3] map (x, y, 1) of an output pixel centre to its
    continuous input position; samples outside the image get ``fill``.
    Returns fp32 [B, out_size, out_size, C]."""
    b, h, w, c = images.shape
    coords = _out_coords(out_size, images.device)
    src = _apply_affine(matrices.to(images.device, torch.float32), coords)
    sample = _sample_bicubic if method == "bicubic" else _sample_bilinear
    out = sample(images.reshape(b, h * w, c), h, w, src[:, 1] - 0.5,
                 src[:, 0] - 0.5)
    inside = ((src[:, 0] >= 0.0) & (src[:, 0] <= w)
              & (src[:, 1] >= 0.0) & (src[:, 1] <= h)).unsqueeze(-1)
    out = torch.where(inside, out, torch.full_like(out, fill))
    return out.reshape(b, out_size, out_size, c)


def _crop_matrix(top, left, ch, cw, out_size: int) -> torch.Tensor:
    """Affine maps [..., 2, 3] from output pixels to a crop box (resize
    semantics; ``preprocess.py:261-270``)."""
    sx, sy = cw / out_size, ch / out_size
    zeros = torch.zeros_like(sx)
    return torch.stack([torch.stack([sx, zeros, left], -1),
                        torch.stack([zeros, sy, top], -1)], -2)


def _rotation_matrix(theta: torch.Tensor, out_size: int) -> torch.Tensor:
    """Rotation by ``theta`` (radians) about the output centre, in output
    pixel coordinates (``preprocess.py:273-284``)."""
    c, s = torch.cos(theta), torch.sin(theta)
    cx = out_size / 2.0
    tx = cx - c * cx + s * cx
    ty = cx - s * cx - c * cx
    return torch.stack([torch.stack([c, -s, tx], -1),
                        torch.stack([s, c, ty], -1)], -2)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 2 x 3 affine a(b(x)) (``preprocess.py:287-293``)."""
    last = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    a3 = torch.cat([a, last.expand(*a.shape[:-2], 1, 3)], -2)
    b3 = torch.cat([b, last.expand(*b.shape[:-2], 1, 3)], -2)
    return (a3 @ b3)[..., :2, :]


def train_matrices(generator: torch.Generator, b: int, h: int, w: int,
                   resolution: int, crop_mode: str = "random",
                   flip: bool = False, rotation: bool = False):
    """The per-image maps of ``train_transform`` (``preprocess.py:364-388``),
    drawn on the host from ``generator``: the crop boxes
    (``fast_warp.train_boxes``: RandomResizedCrop, bottom or centre), then a
    flip per image (probability 1/2), then an angle per image uniform in
    [-30, 30] degrees.  Returns (maps [B, 2, 3], rotations [B, 2, 3] or
    None), fp32 on the CPU."""
    from .fast_warp import train_boxes

    boxes = train_boxes(generator, b, h, w, resolution, crop_mode)
    mats = _crop_matrix(boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3],
                        resolution)
    if flip:
        do = torch.rand(b, generator=generator) < 0.5
        flip_mat = torch.tensor([[-1.0, 0.0, float(resolution)],
                                 [0.0, 1.0, 0.0]])
        ident = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        mats = _compose(mats, torch.where(do[:, None, None], flip_mat, ident))
    rots = None
    if rotation:
        theta = -30.0 + 60.0 * torch.rand(b, generator=generator)
        rots = _rotation_matrix(torch.deg2rad(theta), resolution)
        mats = _compose(mats, rots)
    return mats, rots


def warp_normalize(images_u8: torch.Tensor, mats: torch.Tensor, rots,
                   resolution: int, dtype=torch.float32,
                   method: str = "bicubic", mean=CLIP_MEAN,
                   std=CLIP_STD) -> torch.Tensor:
    """``train_transform`` on given maps (``preprocess.py:389-413``): the
    warp, then with ``rots`` the crop-frame mask (an output pixel whose
    rotated position leaves the [0, resolution] frame is 0), clipped to
    0..255, normalized to ``dtype``."""
    warped = affine_warp(images_u8, mats, resolution, method=method)
    if rots is not None:
        src = _apply_affine(rots.to(warped.device, torch.float32),
                            _out_coords(resolution, warped.device))
        inside = ((src[:, 0] >= 0.0) & (src[:, 0] <= resolution)
                  & (src[:, 1] >= 0.0) & (src[:, 1] <= resolution))
        mask = inside.reshape(-1, resolution, resolution, 1)
        warped = torch.where(mask, warped, torch.zeros_like(warped))
    return normalize(warped.clamp(0.0, 255.0), mean, std, dtype=dtype)


def train_transform(images_u8: torch.Tensor, generator: torch.Generator,
                    resolution: int, crop_mode: str = "random",
                    flip: bool = False, rotation: bool = False,
                    dtype=torch.float32, method: str = "bicubic",
                    mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> augmented, normalized [B, res, res, 3] in
    ``dtype`` on the images' device: the exact per-image augment
    (``aug_impl: exact``), its maps drawn from ``generator``
    (``train_matrices``), applied by ``warp_normalize``.  The signature is
    ``fast_warp.fast_train_transform``'s, so the two are interchangeable."""
    b, h, w, _ = images_u8.shape
    mats, rots = train_matrices(generator, b, h, w, resolution, crop_mode,
                                flip, rotation)
    return warp_normalize(images_u8, mats, rots, resolution, dtype=dtype,
                          method=method, mean=mean, std=std)
