"""The port's K18 (``ops/pallas_preprocess.py``) against the JAX package's:
the phase tables; the plain ``normalize_u8_pallas`` against JAX's
interpret-mode kernel at the shapes of ``tests/test_pallas_preprocess.py``
(fp32 at 1e-6, bf16 within one ulp); the same refusals; and
``normalize_u8(use_pallas=True)`` taking the plain route on the CPU.  The
CUDA kernel against its plain version bit for bit on a card:
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.ops import pallas_preprocess as jpp
from aihab_clip_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD

from aihab_clip_tpu_torch.ops import pallas_preprocess as pp
from aihab_clip_tpu_torch.ops.preprocess import normalize

SHAPES = [(2, 32, 32, 3), (1, 17, 13, 3), (3, 224, 224, 3)]


def test_phase_tables_equal_jax():
    for lanes in (3, 384):
        for got, ref in zip(pp._phase_tables(CLIP_MEAN, CLIP_STD, lanes),
                            jpp._phase_tables(CLIP_MEAN, CLIP_STD, lanes)):
            assert got.dtype == np.float32 and got.shape == (lanes,)
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_normalize_matches_jax_kernel_fp32(rng, shape):
    imgs = rng.integers(0, 256, size=shape, dtype=np.uint8)
    pp.reset_launch_counts()
    out = pp.normalize_u8_pallas(torch.from_numpy(imgs), dtype=torch.float32)
    assert pp.launch_counts() == {"normalize_u8_pallas": 0}
    ref = np.asarray(jpp.normalize_u8_pallas(jnp.asarray(imgs),
                                             dtype=jnp.float32,
                                             interpret=True))
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_normalize_matches_jax_kernel_bf16(rng, shape):
    imgs = rng.integers(0, 256, size=shape, dtype=np.uint8)
    out = pp.normalize_u8_pallas(torch.from_numpy(imgs)).float().numpy()
    ref = np.asarray(jpp.normalize_u8_pallas(jnp.asarray(imgs),
                                             interpret=True), np.float32)
    # one bf16 ulp of each value: 2^(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out - ref) <= ulp)


def test_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="uint8"):
        pp.normalize_u8_pallas(torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError, match="3-channel"):
        pp.normalize_u8_pallas(torch.zeros(1, 4, 4, 1, dtype=torch.uint8))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_normalize_u8_on_cpu_is_the_plain_route(rng, use_pallas):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 9, 9, 3),
                                         dtype=np.uint8))
    pp.reset_launch_counts()
    out = pp.normalize_u8(imgs, dtype=torch.float32, use_pallas=use_pallas)
    assert torch.equal(out, normalize(imgs, dtype=torch.float32))
    assert pp.normalize_u8_pallas.launches == 0
