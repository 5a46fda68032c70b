"""The PEFT train step of the wide CLIP towers in the port against the JAX
package, at a tiny depth: one loss and its gradients through
``train.peft._build_loss_fn`` with a fused prefix of one block (the plain K1
on the CPU, or the plain K14 with ``prefix_quant``; JAX's interpret-mode
Pallas) and one trainable block under autograd, center crop, fp32.  Towers:
two heads of 88 and of 104 (ViT-g/14's and ViT-bigG/14's head widths, exact
gelu run as gelu_poly, patch 14), and a patch-14 tower at 336 px, S = 577
(ViT-L/14@336px's sequence, QuickGELU).  With the bf16-kernel prefix: the
loss at 1e-4, every trainable leaf's gradient at 1e-4 (relative to its
largest entry) and a cosine of 0.9999.  With the int8 prefix: the loss at
3e-3, each gradient at 4e-3 and a cosine of 0.99999 (int8 code flips, see
``INT8_TOL``), which the same step with the bf16 prefix fails.  Frozen
leaves get no gradient.

Departure D5 (ROADMAP Queue C): JAX's hybrid encode runs its trainable
suffix blocks with QuickGELU whatever the tower's act
(``fast_vit._canonical_clip_block``'s default, ``fast_vit.py:133, 730``), as
its scanned encode does (D2).  The port's suffix runs each block's own MLP,
so a GELU tower trains with the gelu it serves with.  The GELU towers are
held against JAX's step with its suffix given the tower's act, and the
unchanged JAX step is shown to differ."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.models import CLIPBundle
from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models import CLIPModel as JaxModel
from aihab_clip_tpu.models import fast_vit as jax_fast_vit
from aihab_clip_tpu.train import peft as jax_peft

from aihab_clip_tpu_torch.models import CLIPConfig, fast_vit
from aihab_clip_tpu_torch.models.convert import _convert_key, flatten_params
from aihab_clip_tpu_torch.train import peft

from test_torch_peft import _head, _port_model

_TEXT = dict(embed_dim=32, context_length=77, vocab_size=49408,
             transformer_width=64, transformer_heads=1, transformer_layers=1)
TOWERS = {
    "hd88": dict(_TEXT, image_resolution=28, vision_layers=2,
                 vision_width=176, vision_patch_size=14, vision_mlp_dim=768,
                 vision_heads_override=2, act="gelu"),
    "hd104": dict(_TEXT, image_resolution=28, vision_layers=2,
                  vision_width=208, vision_patch_size=14,
                  vision_mlp_dim=1024, vision_heads_override=2, act="gelu"),
    "s577": dict(_TEXT, image_resolution=336, vision_layers=2,
                 vision_width=128, vision_patch_size=14),
}


@pytest.fixture(autouse=True)
def _exact_act(monkeypatch):
    monkeypatch.delenv("AIHAB_ERF_IMPL", raising=False)
    monkeypatch.delenv("AIHAB_NO_GELU_POLY", raising=False)


def _seeded_params(model, cfg, seed):
    """The JAX tree's shapes (``eval_shape`` of its init, which runs no
    forward) filled from numpy: weights N(0, 1 / fan_in), LN scales
    1 + 0.05 N, biases and 1-D embeddings 0.05 N (so no bias is zero and no
    LN scale one), the logit scale log(1 / 0.07)."""
    rng = np.random.default_rng(seed)
    res = cfg.image_resolution
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, res, res, 3)),
                            jnp.zeros((1, cfg.context_length), jnp.int32))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if leaf.ndim == 0:
            return jnp.asarray(np.log(1 / 0.07), jnp.float32)
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if "'scale'" in name:
            return jnp.asarray(1 + 0.05 * n)
        if leaf.ndim == 1:
            return jnp.asarray(0.05 * n)
        return jnp.asarray(n / np.sqrt(np.prod(leaf.shape[:-1])))

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


@functools.lru_cache(maxsize=None)
def _tower(name):
    """(name, JAX bundle, its numpy-seeded params, port model on them)."""
    kw = TOWERS[name]
    cfg = JaxConfig(**kw)
    model = JaxModel(cfg)
    params = _seeded_params(model, cfg, 32)
    b = CLIPBundle(name=f"random:peft-{name}", config=cfg, model=model,
                   params=params, source="random")
    return name, b, params, _port_model(params, CLIPConfig(**kw))


# the int8 prefix once, at S = 577 (K14's normalised-P attention at the
# longest sequence; the wide head widths' int8 blocks are held in
# tests/test_torch_large_vit.py)
CASES = [("hd88", False), ("hd104", False), ("s577", False), ("s577", True)]


@pytest.mark.parametrize("tower_name,prefix_quant", CASES)
def test_hybrid_step_matches_jax(tower_name, prefix_quant, monkeypatch):
    name, b, params, model = _tower(tower_name)
    # JAX's TPU gate sends S = 577 to its head-group split K13, whose
    # out-projection quantizes per head group; the port's plan (and JAX's at
    # S <= 512) is the merged K14, which quantizes whole rows
    monkeypatch.setattr(jax_fast_vit, "ATTN_WHOLE_KERNEL_MAX_BYTES", 2 ** 40)
    if b.config.act != "quick_gelu":   # D5: JAX's suffix with the tower's act
        monkeypatch.setattr(jax_fast_vit, "_canonical_clip_block",
                            functools.partial(
                                jax_fast_vit._canonical_clip_block,
                                act=b.config.act))
    res = b.config.image_resolution
    head, tpc = _head(b, params)
    rng = np.random.default_rng(33)
    images = rng.integers(0, 256, (2, res + 8, res + 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, 2).astype(np.int32)
    valid = np.ones(2, bool)
    base = dict(resolution=res, num_classes=20, lr=1e-3, epochs=1,
                crop_mode="center", num_templates=tpc, fused_prefix=1,
                prefix_quant=prefix_quant)

    mask = jax_peft.build_lock_mask(b.params, 2, 1, unlocked_groups=2)
    trainable, frozen = jax_peft.partition_params(params, mask)
    jcfg = jax_peft.PEFTConfig(**base)
    jq = jax_peft._quantize_prefix(b.model, jcfg, frozen)
    loss_fn = jax_peft._build_loss_fn(b.model, jcfg, head["text_weights"],
                                      head["prompt_tokens"])

    def jax_loss(t):
        return loss_fn(t, frozen, jnp.asarray(images), jnp.asarray(labels),
                       jnp.asarray(valid), jax.random.key(0), jq)[0]

    ref_loss, grads = jax.jit(jax.value_and_grad(jax_loss))(trainable)

    ref = {}
    for key, g in flatten_params(grads).items():
        pname, g = _convert_key(key, g)
        ref[pname] = np.asarray(g, np.float32).ravel()
    port_mask = peft.build_lock_mask(model, 2, 1, unlocked_groups=2)
    assert any(port_mask.get(n, False) for n in ref)
    tol = INT8_TOL if prefix_quant else BF16_TOL
    misses = _misses(_port_step(model, head, base, images, labels, valid),
                     float(ref_loss), ref, port_mask, tol)
    assert not misses, (name, misses)
    if prefix_quant:
        # the control: the same step with the bf16 prefix (no quantization)
        # fails the int8 tolerance
        control = _port_step(model, head, dict(base, prefix_quant=False),
                             images, labels, valid)
        assert _misses(control, float(ref_loss), ref, port_mask, tol)


# (loss relative |d|, each trainable gradient's max |d| relative to its
# largest entry, its least cosine).  The int8 prefix: an fp32 sum taken in
# another order puts a value on the other side of an int8 rounding
# boundary, and the flipped code moves its row by one code step times a
# weight; at S = 577 the port's int8 step read loss 3.2e-4, gradient 4.3e-4,
# 1 - cosine 2.4e-7 from JAX's, and its bf16-prefix step 5.8e-2, 2.0e-2 and
# 6.7e-5, so the limits sit about ten times above the first
BF16_TOL = (1e-4, 1e-4, 0.9999)
INT8_TOL = (3e-3, 4e-3, 0.99999)


def _port_step(model, head, base, images, labels, valid):
    """The port's loss and gradients {name: flat grad} of one step; frozen
    leaves get no gradient."""
    cfg = peft.PEFTConfig(**base)
    pprefix = (peft._quantize_prefix(model, cfg) if cfg.prefix_quant
               else peft._pack_prefix(model, cfg))
    fn = peft._build_loss_fn(
        model, cfg, torch.from_numpy(np.asarray(head["text_weights"])), None)
    model.zero_grad(set_to_none=True)
    loss, _ = fn(torch.from_numpy(images), torch.from_numpy(labels),
                 torch.from_numpy(valid), torch.Generator().manual_seed(0),
                 pprefix)
    loss.backward()
    grads = {n: (None if p.grad is None else p.grad.numpy().ravel().copy())
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return loss.item(), grads


def _misses(got, ref_loss, ref, mask, tol):
    """What of ``got`` = (loss, grads) lies outside ``tol`` of JAX's step."""
    loss, grads = got
    loss_rel, grad_tol, cos_min = tol
    misses = []
    if abs(loss - ref_loss) > loss_rel * abs(ref_loss) + 1e-4:
        misses.append(("loss", loss, ref_loss))
    for pname, g in grads.items():
        if not mask.get(pname, False):
            assert g is None, pname
            continue
        assert g is not None, pname
        scale = max(np.abs(ref[pname]).max(), 1e-12)
        d = np.abs(g - ref[pname]).max()
        if d > grad_tol * scale + 1e-7:
            misses.append((pname, "max |d|", d / scale))
        if np.abs(ref[pname]).max() > 1e-8:
            cos = g @ ref[pname] / np.linalg.norm(g) / np.linalg.norm(
                ref[pname])
            if cos < cos_min:
                misses.append((pname, "cosine", cos))
    return misses


@pytest.mark.parametrize("tower_name", ["hd88", "hd104"])
def test_jax_suffix_runs_quick_gelu_on_a_gelu_tower(tower_name):
    """D5 pinned: on a GELU tower the port's hybrid differs from JAX's own
    (QuickGELU suffix) by far more than the tolerance above."""
    name, b, params, model = _tower(tower_name)
    res = b.config.image_resolution
    x = np.random.default_rng(34).standard_normal(
        (2, res, res, 3)).astype(np.float32)
    _, ref = jax_fast_vit.vit_encode_hybrid(
        params, jnp.asarray(x), b.config, 1, project=True, dtype=jnp.float32,
        interpret=True)
    with torch.no_grad():
        _, got = fast_vit.vit_encode_hybrid(model, torch.from_numpy(x),
                                        model.config, 1, project=True,
                                        dtype=torch.float32)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() > 1e-3 * np.abs(ref).max()
