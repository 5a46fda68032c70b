"""The port's K17 (``ops/block_kernel.mlp_block_train``) and its tower
(``models/fast_vit.vit_encode_train``) against the JAX package's, on CPU
tensors (the plain forward and backward): ``mlp_block_train``'s output and
all seven gradients against JAX's interpret-mode kernels at 1e-4 relative
(``tests/test_block_kernel.py:195-230``); ``vit_encode_train``'s loss at
1e-5 and every parameter gradient at 5e-5 against JAX's on carried weights
(``:232-262``); and the gate ``use_fused_train_encode``.  The CUDA kernels
against their plain versions on a card: ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models import fast_vit as jax_fast_vit
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.ops.block_kernel import _mlp_train_fwd_call
from aihab_clip_tpu.ops.block_kernel import \
    mlp_block_train as jax_mlp_block_train

from aihab_clip_tpu_torch.models import CLIP_ARCHS, CLIPConfig, CLIPModel
from aihab_clip_tpu_torch.models import fast_vit
from aihab_clip_tpu_torch.models.convert import (_convert_key,
                                                 flatten_params,
                                                 flax_params_to_state_dict,
                                                 load_params_npz)
from aihab_clip_tpu_torch.models.siglip import SIGLIP_ARCHS
from aihab_clip_tpu_torch.ops import block_kernel as bk

NAMES = ("dx", "dgamma", "dbeta", "dwfc", "dbfc", "dwpr", "dbpr")
# tests/test_block_kernel.py:240
TINY = dict(embed_dim=32, image_resolution=32, vision_layers=3,
            vision_width=128, vision_patch_size=8, context_length=77,
            vocab_size=49408, transformer_width=64, transformer_heads=2,
            transformer_layers=2)


def _jax(config):
    return JaxConfig(**dataclasses.asdict(config))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _mlp_args(rng, m=70, w=128, hidden=256):
    return (rng.standard_normal((m, w)).astype(np.float32),
            rng.standard_normal(w).astype(np.float32),
            rng.standard_normal(w).astype(np.float32),
            (rng.standard_normal((w, hidden)) * 0.05).astype(np.float32),
            rng.standard_normal(hidden).astype(np.float32) * 0.1,
            (rng.standard_normal((hidden, w)) * 0.05).astype(np.float32),
            rng.standard_normal(w).astype(np.float32) * 0.1)


@pytest.mark.parametrize("plain", [False, True])
def test_mlp_block_train_matches_jax(rng, plain):
    """Forward and all seven gradients of sum(sin(out)) against JAX's
    interpret-mode forward and backward kernels, at 1e-4 relative; the
    plain-ops Function (the card's comparison path) gives the same."""
    args = _mlp_args(rng)
    jargs = tuple(map(jnp.asarray, args))
    ref = jax_mlp_block_train(*jargs, interpret=True)
    ref_g = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_mlp_block_train(
        *a, interpret=True))), argnums=tuple(range(7)))(*jargs)
    fn = bk.mlp_block_train_plain if plain else bk.mlp_block_train
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    bk.reset_launch_counts()
    out = fn(*ins)
    out.sin().sum().backward()
    assert _rel(out.detach().numpy(), ref) < 1e-4
    for name, t, g in zip(NAMES, ins, ref_g):
        assert t.grad.shape == t.shape, name
        assert _rel(t.grad.numpy(), g) < 1e-4, (name, _rel(t.grad.numpy(), g))
    assert bk.mlp_block_train_fwd.launches == 0
    assert bk.mlp_block_train_bwd.launches == 0


def test_mlp_block_train_bf16_rounds_as_jax(rng):
    """bf16 forward: h_pre and y round where JAX's kernel rounds them; the
    plain pieces against JAX's interpret-mode forward within 2 bf16 ulps of
    max|ref|."""
    args = _mlp_args(rng, m=40)
    jargs = [jnp.asarray(a, jnp.bfloat16) if a.ndim == 2 else jnp.asarray(a)
             for a in args]
    ref_y, ref_h = _mlp_train_fwd_call(*jargs, True, 128)
    targs = [torch.from_numpy(a).bfloat16() if a.ndim == 2
             else torch.from_numpy(a) for a in args]
    y, h_pre = bk.mlp_block_train_fwd(*targs)
    assert y.dtype == h_pre.dtype == torch.bfloat16
    for got, ref in ((y, ref_y), (h_pre, ref_h)):
        ref = np.asarray(ref, np.float32)
        lim = 2 * 2 ** -8 * np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= lim


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    bundle = jax_load("random:tiny-trainfused", random_cfg=JaxConfig(**TINY),
                      seed=11)
    path = tmp_path_factory.mktemp("trainfused") / "params.npz"
    save_params_npz(path, bundle.params)
    cfg = CLIPConfig(**TINY)
    model = CLIPModel(cfg)
    model.load_state_dict(flax_params_to_state_dict(load_params_npz(path)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tw = rng.standard_normal((TINY["embed_dim"], 5)).astype(np.float32)
    return bundle, model, cfg, x, tw


def test_vit_encode_train_matches_jax(carried):
    """The fused-MLP tower's loss sum(sin(f @ tw)) at 1e-5 and every
    visual parameter's gradient at 5e-5 against JAX's ``vit_encode_train``
    (interpret-mode K17) on the same weights.  JAX's own test scales the
    logits by 100 to compare two graphs of one framework, which agree
    exactly; across the frameworks the features differ by fp32 summation
    order (~6e-7 relative, as the canonical towers do), which that factor
    would lift to ~1e-3 in the loss."""
    bundle, model, cfg, x, tw = carried

    def jax_loss(params):
        _, f = jax_fast_vit.vit_encode_train(
            params, jnp.asarray(x), bundle.config, project=True,
            dtype=jnp.float32, interpret=True)
        return jnp.sum(jnp.sin(f @ tw))

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(bundle.params)
    model.zero_grad(set_to_none=True)
    _, f = fast_vit.vit_encode_train(model, torch.from_numpy(x), cfg,
                                     project=True, dtype=torch.float32)
    loss = torch.sin(f @ torch.from_numpy(tw)).sum()
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) / abs(float(ref_loss)) < 1e-5
    named = dict(model.named_parameters())
    checked = 0
    for key, g in flatten_params(ref_grads).items():
        name, g = _convert_key(key, g)
        if not name.startswith("visual."):
            continue
        assert named[name].grad is not None, name
        assert _rel(named[name].grad.numpy(), g) < 5e-5, name
        checked += 1
    assert checked == sum(1 for n in named if n.startswith("visual."))
    model.zero_grad(set_to_none=True)


def test_vit_encode_train_mlp_is_quick_gelu(carried):
    """JAX's quirk, kept: the MLP runs QuickGELU whatever ``config.act``
    says, so a gelu config encodes exactly as the quick_gelu one."""
    _, model, cfg, x, _ = carried
    with torch.no_grad():
        a = fast_vit.vit_encode_train(model, torch.from_numpy(x), cfg,
                                      dtype=torch.float32)
        b = fast_vit.vit_encode_train(
            model, torch.from_numpy(x), dataclasses.replace(cfg, act="gelu"),
            dtype=torch.float32)
    assert torch.equal(a, b)


def test_use_fused_train_encode_gates(carried, monkeypatch):
    _, model, cfg, _, _ = carried
    vitb = CLIP_ARCHS["ViT-B/16"]
    # the CPU (JAX: any backend but the TPU) never dispatches it
    assert not fast_vit.use_fused_train_encode(model, vitb)
    monkeypatch.setattr(fast_vit, "_on_card", lambda m: True)
    monkeypatch.setattr(jax_fast_vit, "dispatch_backend", lambda: "tpu")
    for config in (vitb, cfg):
        assert fast_vit.use_fused_train_encode(model, config)
        assert jax_fast_vit.use_fused_train_encode(None, _jax(config))
    for kwargs in (dict(mesh=object()), dict(dtype=torch.float32)):
        assert not fast_vit.use_fused_train_encode(model, vitb, **kwargs)
    for config in (CLIP_ARCHS["TinyConvNeXt"],
                   SIGLIP_ARCHS["ViT-SO400M-16-SigLIP2-384"]):
        assert not fast_vit.use_fused_train_encode(model, config)
    # JAX's VMEM budget refuses ViT-L's 16.8 MB bf16 weight pair; K17
    # streams weight tiles, so the port takes it
    vitl = CLIP_ARCHS["ViT-L/14"]
    assert not jax_fast_vit.use_fused_train_encode(None, _jax(vitl))
    assert fast_vit.use_fused_train_encode(model, vitl)
