"""The port's edge maps (``aihab_clip_tpu_torch/ops/edges.py``) against the
JAX package's (``aihab_clip_tpu/ops/edges.py``, which calls OpenCV): Canny
per channel and on grey, the grey conversion and the blend, bit for bit,
over thresholds (one pair swapped, one fractional), odd sizes, 1-pixel
images and frames, random and smooth photo-like draws, one image and a
batch; the two-view helper against the port's train transform."""

import cv2
import numpy as np
import pytest
import torch

from aihab_clip_tpu.ops import edges as jax_edges

from aihab_clip_tpu_torch.ops import edges
from aihab_clip_tpu_torch.ops.preprocess import train_transform

THRESHOLDS = [(10, 50), (50, 150), (100, 50), (10.7, 50.2)]
SIZES = [(1, 1), (1, 9), (7, 1), (2, 3), (17, 23), (64, 65), (101, 37)]


def _smooth(rng, h, w):
    """Sums of oriented sinusoids plus a little noise: long edges."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.01, 0.2, 2)
            img[..., c] += 60 * np.sin(fx * x + fy * y + rng.uniform(0, 6))
    img += rng.normal(0, 4, img.shape)
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def _framed(rng, h, w):
    """A flat image inside a 1-pixel frame of another value."""
    img = np.full((h, w, 3), 90, np.uint8)
    img[0], img[-1], img[:, 0], img[:, -1] = 200, 10, 160, 40
    return img


DRAWS = {"random": lambda rng, h, w: rng.integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8),
         "smooth": _smooth, "framed": _framed}


@pytest.mark.parametrize("draw", sorted(DRAWS))
@pytest.mark.parametrize("t1,t2", THRESHOLDS)
def test_canny_rgb_and_grayscale_bit_for_bit(draw, t1, t2):
    rng = np.random.default_rng([sorted(DRAWS).index(draw),
                                 THRESHOLDS.index((t1, t2))])
    for h, w in SIZES:
        img = DRAWS[draw](rng, h, w)
        got = edges.canny_rgb(torch.from_numpy(img), t1, t2).numpy()
        np.testing.assert_array_equal(got, jax_edges.canny_rgb(img, t1, t2),
                                      err_msg=f"{draw} {h}x{w}")
        got = edges.canny_grayscale(torch.from_numpy(img), t1, t2).numpy()
        np.testing.assert_array_equal(
            got, jax_edges.canny_grayscale(img, t1, t2),
            err_msg=f"grey {draw} {h}x{w}")
    batch = np.stack([DRAWS[draw](rng, 48, 57) for _ in range(3)])
    np.testing.assert_array_equal(
        edges.canny_rgb(torch.from_numpy(batch), t1, t2).numpy(),
        jax_edges.canny_rgb(batch, t1, t2))
    np.testing.assert_array_equal(
        edges.canny_grayscale(torch.from_numpy(batch), t1, t2).numpy(),
        jax_edges.canny_grayscale(batch, t1, t2))


def test_rgb_to_gray_is_cv2s():
    rng = np.random.default_rng(1)
    for shape in [(1, 1, 3), (3, 5, 3), (224, 224, 3), (400, 300, 3)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(
            edges.rgb_to_gray(torch.from_numpy(img)).numpy(),
            cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("alpha,beta,gamma", [(0.5, 0.5, 0.0),
                                              (0.7, 0.3, 5.0),
                                              (1.3, -0.4, 7.7)])
def test_edge_blend_bit_for_bit(alpha, beta, gamma):
    rng = np.random.default_rng(2)
    batch = np.stack([_smooth(rng, 37, 53) for _ in range(2)])
    for imgs in (batch, batch[0]):
        got = edges.edge_blend(torch.from_numpy(imgs), 10, 50, alpha, beta,
                               gamma).numpy()
        np.testing.assert_array_equal(
            got, jax_edges.edge_blend(imgs, 10, 50, alpha, beta, gamma))
    a = rng.integers(0, 256, (5, 33, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (5, 33, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        edges.add_weighted(torch.from_numpy(a), alpha, torch.from_numpy(b),
                           beta, gamma).numpy(),
        cv2.addWeighted(a, alpha, b, beta, gamma))


def test_edge_augment_pairs():
    rng = np.random.default_rng(3)
    batch = np.stack([_smooth(rng, 30, 40) for _ in range(2)])
    orig, edge = edges.edge_augment(torch.from_numpy(batch))
    j_orig, j_edge = jax_edges.edge_augment(batch)
    np.testing.assert_array_equal(orig.numpy(), j_orig)
    np.testing.assert_array_equal(edge.numpy(), j_edge)


def test_canny_refuses_other_dtypes():
    with pytest.raises(TypeError, match="uint8"):
        edges.canny_planes(torch.zeros(1, 4, 4, dtype=torch.float32))


def test_two_view_batch_draws_two_generators():
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(np.stack([_smooth(rng, 48, 48)
                                      for _ in range(3)]))
    kw = dict(resolution=32, crop_mode="random", flip=True, rotation=True)
    views = edges.two_view_batch(imgs, torch.Generator().manual_seed(7),
                                 train_transform, **kw)
    g1, g2 = edges.split_generator(torch.Generator().manual_seed(7))
    torch.testing.assert_close(views[0], train_transform(imgs, g1, **kw),
                               rtol=0, atol=0)
    torch.testing.assert_close(views[1], train_transform(imgs, g2, **kw),
                               rtol=0, atol=0)
    assert views[0].shape == (3, 32, 32, 3)
    assert not torch.equal(views[0], views[1])
    # a second transform for the second view
    other = edges.two_view_batch(imgs, torch.Generator().manual_seed(7),
                                 train_transform, lambda x, g, **k: x, **kw)
    assert torch.equal(other[1], imgs)
