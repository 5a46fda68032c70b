"""The port's int8 serving engine and int8 PEFT prefix against the JAX
package on the same weights: ``ClassifierEngine(quantize="int8")`` on a
SigLIP tower, its refusals, and one train loss with ``prefix_quant``.  The
int8 tower itself: ``tests/test_torch_quant_siglip.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
from aihab_clip_tpu.train import peft as jax_peft

import aihab_clip_tpu_torch.models.zoo as zoo
from aihab_clip_tpu_torch.models.convert import flax_params_to_state_dict
from aihab_clip_tpu_torch.serving import ClassifierEngine
from aihab_clip_tpu_torch.train import peft

from test_torch_peft import _head, siglip_tiny  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, so the CPU's fp32 sums (and the int8 codes
    rounded from them) do not depend on the machine's core count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The JAX int8 engine on random:SigLIP-Tiny and the port's on the same
    weights (the port's random init replaced by the carry)."""
    ref = JaxEngine(model="random:SigLIP-Tiny", batch_size=4, flat=True,
                    quantize="int8", verbose=False)
    sd = flax_params_to_state_dict(ref.bundle.params)
    mp = pytest.MonkeyPatch()
    mp.setattr(zoo, "init_siglip_random_",
               lambda model, generator: model.load_state_dict(sd))
    try:
        port = ClassifierEngine(model="random:SigLIP-Tiny", batch_size=4,
                                flat=True, quantize="int8", verbose=False,
                                device="cpu")
    finally:
        mp.undo()
    return ref, port


def test_int8_engine_matches_jax(engines):
    """The JAX CPU engine runs its ``impl="xla"`` int8 reference (bf16 LN
    outputs quantized, its own attention), the port the kernels' plain
    versions: they agree at the int8 level, where a logit of 100 * cos
    magnifies a feature's int8 noise.  Measured max|dprob| 9.8e-3 (limit
    2e-2); top-1 equal."""
    ref, port = engines
    assert port.quantize == "int8" and port._packed is None
    imgs = np.random.default_rng(3).integers(0, 256, (6, 224, 224, 3),
                                             dtype=np.uint8)
    want = np.concatenate([ref.classify_batch(imgs[:4]),
                           ref.classify_batch(imgs[4:])])
    got = np.concatenate([port.classify_batch(imgs[:4]),
                          port.classify_batch(imgs[4:])])
    assert got.shape == (6, 20)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= 2e-2


def test_int8_engine_options():
    # a CLIP ViT tower is served in int8 too (models/quant_vit.py)
    tiny = ClassifierEngine(model="random:Tiny", quantize="int8", device="cpu",
                            verbose=False)
    assert set(tiny._qparams["transformer"]["resblocks_0"]) == {
        "attn/in_proj", "attn/out_proj", "mlp/c_fc", "mlp/c_proj", "ln_1",
        "ln_2"}
    with pytest.raises(ValueError, match="unknown quantize mode"):
        ClassifierEngine(model="random:SigLIP-Tiny", quantize="int4",
                         device="cpu", verbose=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ClassifierEngine(model="random:SigLIP-Tiny", quantize="int8",
                             verbose=False)


# ---------------------------------------------------------------------------
# the int8 frozen prefix of the PEFT step
# ---------------------------------------------------------------------------


def test_prefix_quant_loss_matches_jax(siglip_tiny):  # noqa: F811
    """One train loss with ``prefix_quant=True`` (fused prefix 1, center
    crop, fp32) against JAX's with its ``_quantize_prefix`` at 1e-4;
    ``_quantize_prefix`` quantizes only the frozen prefix."""
    b, params, model = siglip_tiny
    head, tpc = _head(b, params)
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, 8).astype(np.int32)
    valid = np.array([True] * 7 + [False])
    base = dict(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                crop_mode="center", num_templates=tpc, fused_prefix=1,
                prefix_quant=True)
    mask = jax_peft.build_lock_mask(b.params, 2, 2, unlocked_groups=2)
    trainable, frozen = jax_peft.partition_params(params, mask)
    jcfg = jax_peft.PEFTConfig(**base)
    jq = jax_peft._quantize_prefix(b.model, jcfg, frozen)
    loss_fn = jax_peft._build_loss_fn(b.model, jcfg, head["text_weights"],
                                      head["prompt_tokens"])
    ref_loss, _ = loss_fn(trainable, frozen, jnp.asarray(images),
                          jnp.asarray(labels), jnp.asarray(valid),
                          jax.random.key(0), jq)
    peft.build_lock_mask(model, 2, 2, unlocked_groups=2)
    cfg = peft.PEFTConfig(**base)
    qprefix = peft._quantize_prefix(model, cfg)
    assert list(qprefix) == ["resblocks_0"]
    assert peft._pack_prefix(model, cfg) is None
    fn = peft._build_loss_fn(
        model, cfg, torch.from_numpy(np.asarray(head["text_weights"])), None)
    with torch.no_grad():
        loss, _ = fn(torch.from_numpy(images), torch.from_numpy(labels),
                     torch.from_numpy(valid), torch.Generator().manual_seed(0),
                     qprefix)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-4)
    for p in model.parameters():
        p.requires_grad_(True)


def test_prefix_quant_needs_siglip_for_now(siglip_tiny):  # noqa: F811
    """``prefix_quant`` is taken for SigLIP and, since the CLIP ViT int8
    prefix (K14) is ported, for a CLIP ViT too (every ``PEFTConfig`` field
    is ported, so ``peft`` keeps no option check): its
    ``_quantize_prefix`` holds ``quantize_vit_block`` dicts (the CLIP loss:
    ``tests/test_torch_quant_vit.py``)."""
    from aihab_clip_tpu_torch.models import load

    _, _, model = siglip_tiny
    cfg = peft.PEFTConfig(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                          prefix_quant=True)
    assert peft._quantize_prefix(model, dataclasses.replace(
        cfg, fused_prefix=0)) is None
    clip = load("random:Tiny", device="cpu").model
    qprefix = peft._quantize_prefix(clip, dataclasses.replace(
        cfg, fused_prefix=2))
    assert list(qprefix) == ["resblocks_0", "resblocks_1"]
    assert "attn/in_proj" in qprefix["resblocks_0"]
