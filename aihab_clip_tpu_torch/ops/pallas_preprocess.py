"""The uint8 -> CLIP-normalized conversion on Hopper (K18), with its plain
version (counterpart of ``aihab_clip_tpu/ops/pallas_preprocess.py``).

``normalize_u8_pallas`` computes ``x * scale_c + shift_c`` over uint8 NHWC
with ``scale_c = 1 / (255 std_c)`` and ``shift_c = -mean_c / std_c`` in fp32
(``_phase_tables``, ``:38-46``), stored in ``dtype``: on CUDA tensors the
``normalize_u8`` kernel of ``csrc/preprocess.cu``, on CPU tensors the plain
version, which rounds the product and the sum apart as the kernel does, so
the two agree bit for bit.  The TPU kernel's 384-lane phase layout is a
fact of its 128-lane registers: the kernel converts 48 bytes (16 pixels) a
thread, six warp-coalesced 8-byte pieces in whose bytes the channel is
fixed, and the ragged end a byte at a time with the channel i % 3.  Its
launches are counted in ``normalize_u8_pallas.launches``.

``normalize_u8(use_pallas=True)`` launches the kernel on CUDA tensors and
raises there when it cannot, as JAX's comment demands (``:119-122``);
otherwise it runs ``ops/preprocess.normalize``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ._build import launch
from .preprocess import CLIP_MEAN, CLIP_STD, normalize


def _phase_tables(mean, std, lanes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-lane scale/shift rows of the RGB phase pattern (``:38``):
    scale = 1/(255*std_c), shift = -mean_c/std_c, c = lane % 3, fp32."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    ch = np.arange(lanes) % 3
    scale = (1.0 / (255.0 * std))[ch]
    shift = (-mean / std)[ch]
    return scale.astype(np.float32), shift.astype(np.float32)


@lru_cache(maxsize=16)
def _phase_args(mean: Tuple[float, ...], std: Tuple[float, ...]):
    """The kernel's six float arguments (scale_0..2, shift_0..2) of one
    (mean, std), computed once: the per-call numpy work cost more than the
    kernel at the eval batch."""
    scale, shift = _phase_tables(mean, std, 3)
    return (*map(float, scale), *map(float, shift))


def _check_u8(images_u8: torch.Tensor) -> None:
    if images_u8.dtype != torch.uint8:
        raise ValueError("normalize_u8_pallas expects uint8 input")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError("expects 3-channel input")


def normalize_u8_pallas_plain(images_u8: torch.Tensor, mean=CLIP_MEAN,
                              std=CLIP_STD, dtype=torch.bfloat16):
    """Plain version of ``normalize_u8_pallas`` (same signature)."""
    _check_u8(images_u8)
    scale, shift = (torch.from_numpy(t).to(images_u8.device)
                    for t in _phase_tables(mean, std, 3))
    return (images_u8.float() * scale + shift).to(dtype)


def normalize_u8_pallas(images_u8: torch.Tensor, mean=CLIP_MEAN,
                        std=CLIP_STD, dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> (x/255 - mean)/std as x * scale_c + shift_c in
    ``dtype`` (bf16 or fp32).  Kernel ``normalize_u8`` on CUDA tensors; the
    plain version on CPU tensors."""
    _check_u8(images_u8)
    if not images_u8.is_cuda:
        return normalize_u8_pallas_plain(images_u8, mean, std, dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"normalize_u8's kernel stores bf16 or fp32, not "
                        f"{dtype}")
    x = images_u8.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("normalize_u8's kernel needs 16-byte aligned input")
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    launch("aihab_normalize_u8", x.device, x.data_ptr(), y.data_ptr(),
           int(dtype == torch.float32), x.numel(),
           *_phase_args(tuple(map(float, mean)), tuple(map(float, std))))
    normalize_u8_pallas.launches += 1
    return y


def normalize_u8(images_u8: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                 dtype=torch.bfloat16, use_pallas: bool = False):
    """The fused uint8 normalize (``:109``): with ``use_pallas`` the kernel
    on CUDA tensors, with no fallback; otherwise ``preprocess.normalize``
    (JAX: the jnp path off the TPU and by default)."""
    if use_pallas and images_u8.is_cuda:
        return normalize_u8_pallas(images_u8, mean, std, dtype)
    return normalize(images_u8, mean, std, dtype)


COUNTED = (normalize_u8_pallas,)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
