"""The port's decode of a list of blobs on one route as one batch
(``ops/jpeg.decode_blobs``), in the form the JPEG tests compare: a uint8
tensor [N, dim, dim, 3] with zeros where a blob is None, and the ok
mask."""

import numpy as np
import torch

from aihab_clip_tpu_torch.ops import jpeg as J


def decode_batch(blobs, dim, route="native", prescale_min=0, device="cpu"):
    images = J.decode_blobs(blobs, dim, route, prescale_min, device)
    ok = np.array([img is not None for img in images])
    batch = np.stack([np.zeros((dim, dim, 3), np.uint8) if img is None
                      else img for img in images])
    return torch.from_numpy(batch), ok
