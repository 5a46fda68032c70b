"""Seeded photos with structure, made on the device in a few large calls.

Each image is the sum of three random colour fields, 4, 16 and 64 cells a
side, each upsampled bicubically to the full side with a random weight of
its own, then given a random contrast and brightness and a little noise a
pixel.  Images differ in colour, layout and texture, so a tower's features,
and the logits that follow, depend on the image; uniform noise, the same
to a tower at every draw, gives nearly one feature for every image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SCALES = (4, 16, 64)
CHUNK = 256


def _fields(gen: torch.Generator, n: int, d: int, device) -> torch.Tensor:
    """[n, 3, d, d] float32 in 0..1."""
    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    mix = rand(n, len(SCALES))
    mix = mix / mix.sum(1, keepdim=True)
    x = torch.zeros(n, 3, d, d, device=device)
    for j, cells in enumerate(SCALES):
        cells = min(cells, d)
        field = F.interpolate(rand(n, 3, cells, cells), size=(d, d),
                              mode="bicubic", align_corners=False)
        x += mix[:, j, None, None, None] * field
    contrast = 0.5 + 2.0 * rand(n, 1, 1, 1)
    bright = 0.3 * (rand(n, 1, 1, 1) - 0.5)
    noise = 0.02 * torch.randn(n, 3, d, d, generator=gen, device=device)
    return 0.5 + (x - 0.5) * contrast + bright + noise


def smooth_images(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uint8 images of ``shape`` (``[..., d, d, 3]``) on ``device``, drawn
    from ``gen`` (a generator on that device) in chunks of ``CHUNK``."""
    *lead, d, d2, c = shape
    assert d == d2 and c == 3, shape
    n = 1
    for k in lead:
        n *= k
    out = torch.empty(n, d, d, 3, dtype=torch.uint8, device=device)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        x = _fields(gen, m, d, device)
        out[i:i + m] = (x.clamp(0, 1) * 255).round().to(torch.uint8
                                                         ).permute(0, 2, 3, 1)
    return out.view(*lead, d, d, 3)
