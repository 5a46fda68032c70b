"""The port's LoRA (``train/lora.py``, the LoRA mode of ``finetune``, the
``lora_adapters.npz`` format and ``ClassifierEngine(lora=)``) against the
JAX package on the same weights and the same adapters: the target paths
under the converter's names, the merge (fp32, atol 1e-6), two-epoch LoRA
trails on CLIP-Tiny and on SigLIP-Tiny with ``scan_blocks`` + ``tune_text``
(JAX's initial A injected into the port; losses within 1e-4, equal test
top-1), each package's adapter file served by the other's engine."""

import dataclasses
import operator

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.data.bulk_load import ImageArrayDataset as JaxDataset
from aihab_clip_tpu.data.pipeline import SplitView as JaxView
from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
from aihab_clip_tpu.models import build_text_head as jax_text_head
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
from aihab_clip_tpu.train import lora as jax_lora
from aihab_clip_tpu.train import peft as jax_peft

import aihab_clip_tpu_torch.models.zoo as zoo
from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
from aihab_clip_tpu_torch.models import (CLIPConfig, CLIPModel, SigLIPConfig,
                                         SigLIPModel)
from aihab_clip_tpu_torch.models.convert import (_convert_key, flatten_params,
                                                 flax_adapters_to_port,
                                                 flax_params_to_state_dict,
                                                 jax_kernel_path,
                                                 port_adapters_to_flax)
from aihab_clip_tpu_torch.serving import ClassifierEngine
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.train import lora, peft

TINY_CLIP = dict(embed_dim=32, image_resolution=24, vision_layers=3,
                 vision_width=64, vision_patch_size=8, context_length=77,
                 vocab_size=49408, transformer_width=64, transformer_heads=1,
                 transformer_layers=2)
ENGINE = "torch-lora-vit"
ENGINE_CFG = dict(embed_dim=32, image_resolution=32, vision_layers=2,
                  vision_width=128, vision_patch_size=8, context_length=77,
                  vocab_size=49408, transformer_width=64, transformer_heads=1,
                  transformer_layers=2)


def _port_model(params, config):
    cls = SigLIPModel if isinstance(config, SigLIPConfig) else CLIPModel
    model = cls(config)
    model.load_state_dict(flax_params_to_state_dict(params))
    return model.eval()


@pytest.fixture(scope="module")
def clip_tiny():
    b = jax_load("random:tiny-lora", random_cfg=JaxCLIPConfig(**TINY_CLIP),
                 seed=1)
    return b, b.params, _port_model(b.params, CLIPConfig(**TINY_CLIP))


@pytest.fixture(scope="module")
def siglip_tiny():
    b = jax_load("random:SigLIP-Tiny", seed=2)
    rng = np.random.default_rng(9)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        b.params)
    model = _port_model(params, SigLIPConfig(**dataclasses.asdict(b.config)))
    return b, params, model


def _random_adapters(params, towers, include_mlp, rank=4, seed=0):
    """JAX-layout adapters with A and B both random (so the delta is not
    zero)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    out = {}
    for path in jax_lora.lora_target_paths(params, towers=towers,
                                           include_mlp=include_mlp):
        n_in, n_out = flat[path].shape
        out["/".join(path)] = {
            "a": rng.standard_normal((n_in, rank)).astype(np.float32),
            "b": 0.1 * rng.standard_normal((rank, n_out)).astype(np.float32)}
    return out


def _flat_npz(adapters):
    """JAX's runner's file layout: {"<kernel path>/a|b": array}."""
    return {f"{k}/{n}": np.asarray(v) for k, ab in adapters.items()
            for n, v in ab.items()}


# ---------------------------------------------------------------------------
# targets, init and merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tower", ["clip", "siglip"])
@pytest.mark.parametrize("towers", [("visual",), ("visual", "text")])
@pytest.mark.parametrize("include_mlp", [False, True])
def test_target_paths_match_jax(tower, towers, include_mlp, clip_tiny,
                                siglip_tiny):
    _, params, model = clip_tiny if tower == "clip" else siglip_tiny
    ref = jax_lora.lora_target_paths(params, towers=towers,
                                     include_mlp=include_mlp)
    got = lora.lora_target_paths(model, towers=towers,
                                 include_mlp=include_mlp)
    assert got == [_convert_key("/".join(p), np.zeros((1, 1)))[0]
                   for p in ref]
    assert [jax_kernel_path(n) for n in got] == ["/".join(p) for p in ref]
    mods = {n.split(".")[-2] if n.endswith(".weight") else "in_proj"
            for n in got}
    assert bool(mods & {"c_fc", "c_proj"}) == include_mlp


def test_lora_init_draws(clip_tiny):
    """A from the explicit generator (the same seed, the same A), N(0,1)/r
    in fp32; B zero; shapes in JAX's layout; every tensor a leaf that
    requires a gradient, on the model's device."""
    _, _, model = clip_tiny
    one = lora.lora_init(model, 4, torch.Generator().manual_seed(7926))
    two = lora.lora_init(model, 4, torch.Generator().manual_seed(7926))
    w = model.get_parameter("visual.transformer.resblocks.0.attn.in_proj_weight")
    ab = one["visual.transformer.resblocks.0.attn.in_proj_weight"]
    assert ab["a"].shape == (w.shape[1], 4) and ab["b"].shape == (4, w.shape[0])
    assert ab["a"].dtype == torch.float32 and not ab["b"].any()
    for name in one:
        assert torch.equal(one[name]["a"], two[name]["a"])
        assert one[name]["a"].requires_grad and one[name]["a"].is_leaf
    a = torch.cat([ab["a"].flatten() for ab in one.values()])
    assert abs(a.std().item() * 4 - 1.0) < 0.1
    with pytest.raises(ValueError, match="no LoRA target"):
        lora.lora_init(model, 4, torch.Generator(), towers=("nothing",))


@pytest.mark.parametrize("tower", ["clip", "siglip"])
def test_zero_init_is_the_identity(tower, clip_tiny, siglip_tiny):
    _, _, model = clip_tiny if tower == "clip" else siglip_tiny
    adapters = lora.lora_init(model, 4, torch.Generator().manual_seed(0),
                              towers=("visual", "text"), include_mlp=True)
    base = {n: p.detach() for n, p in model.named_parameters()}
    merged = lora.merged_params(model, adapters, 16.0)
    assert merged.keys() == base.keys()
    for name in base:
        assert torch.equal(merged[name], base[name]), name


@pytest.mark.parametrize("tower", ["clip", "siglip"])
def test_merge_changes_only_targets(tower, clip_tiny, siglip_tiny):
    _, params, model = clip_tiny if tower == "clip" else siglip_tiny
    adapters = flax_adapters_to_port(_flat_npz(
        _random_adapters(params, ("visual",), False)))
    base = {n: p.detach() for n, p in model.named_parameters()}
    merged = lora.merged_params(model, adapters, 16.0)
    changed = {n for n in base if not torch.equal(merged[n], base[n])}
    assert changed == set(adapters)
    # the context: every target reads W_eff inside, the base after; the
    # state dict never sees another name
    keys = list(model.state_dict())
    with lora.lora_applied(model, adapters, 16.0):
        for name in adapters:
            assert torch.equal(operator.attrgetter(name)(model).detach(),
                               merged[name])
    assert list(model.state_dict()) == keys
    for name, p in model.named_parameters():
        assert isinstance(p, torch.nn.Parameter) and torch.equal(p, base[name])


@pytest.mark.parametrize("tower", ["clip", "siglip"])
@pytest.mark.parametrize("alpha", [16.0, 3.0])
def test_lora_merge_matches_jax(tower, alpha, clip_tiny, siglip_tiny):
    """JAX's lora_merge and the port's on the same adapters (carried
    through the npz format): every leaf within 1e-6 in fp32."""
    _, params, model = clip_tiny if tower == "clip" else siglip_tiny
    jax_adapters = _random_adapters(params, ("visual", "text"), True,
                                    seed=3)
    ref = jax_lora.lora_merge(
        params, {k: {n: jax.numpy.asarray(v) for n, v in ab.items()}
                 for k, ab in jax_adapters.items()}, alpha)
    ref = dict(_convert_key(k, v)
               for k, v in flatten_params(ref).items())
    got = lora.lora_merge(dict(model.state_dict()),
                          flax_adapters_to_port(_flat_npz(jax_adapters)),
                          alpha)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name], atol=1e-6,
                                   rtol=0, err_msg=name)
    # the file format both ways: the port's writer gives JAX's keys back
    back = port_adapters_to_flax(flax_adapters_to_port(
        _flat_npz(jax_adapters)))
    flat = _flat_npz(jax_adapters)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    assert lora.lora_param_count(flax_adapters_to_port(flat)) == \
        jax_lora.lora_param_count(jax_adapters)


# ---------------------------------------------------------------------------
# the LoRA finetune trail
# ---------------------------------------------------------------------------


class _Log:
    def __init__(self):
        self.rows = []

    def log(self, row):
        self.rows.append(row)


def _dataset(cls, n=24, size=32, seed=12):
    rng = np.random.default_rng(seed)
    return cls(images=rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
               labels=rng.integers(0, 20, n), l2_labels=np.zeros(n, np.int64),
               poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
               poly_word_labels=[""] * n,
               file_names=[f"{i}.jpg" for i in range(n)],
               plot_idx=list(range(n)), image_sources=["synthetic"] * n)


def _inject_jax_init(monkeypatch, params, seed, rank, towers, include_mlp):
    """The port's lora_init returns JAX's initial adapters (JAX draws A
    from jax.random, the port from a torch.Generator)."""
    ref = jax_lora.lora_init(params, rank, jax.random.key(seed + 7919),
                             towers=towers, include_mlp=include_mlp)
    flat = _flat_npz(jax.tree.map(np.asarray, ref))

    def fake(model, rank_, generator, *, towers=("visual",),
             include_mlp=False):
        assert rank_ == rank
        return {n: {k: t.requires_grad_() for k, t in ab.items()}
                for n, ab in flax_adapters_to_port(flat).items()}

    monkeypatch.setattr(lora, "lora_init", fake)


@pytest.mark.parametrize("case", ["clip", "siglip_scan_tune_text"])
def test_lora_finetune_trail_matches_jax(case, clip_tiny, siglip_tiny,
                                         monkeypatch):
    """Two epochs of LoRA on the same weights and initial adapters: the
    per-epoch train losses and the test loss within 1e-4, the same test
    top-1 and confusion matrix; the base weights bit-identical; the
    returned params are W_eff, and the adapters within JAX's by
    ``tests/test_peft.py``'s statistics."""
    clip = case == "clip"
    b, params, model = clip_tiny if clip else siglip_tiny
    prompts, tpc = gen_prompts(use_hierarchy=False, use_descriptive=False)
    head = jax_text_head(b.model, params, prompts, 20, tpc)
    res = 24 if clip else 32
    base = dict(resolution=res, num_classes=20, lr=5e-3, epochs=2,
                crop_mode="center", lora_rank=4, lora_alpha=8.0,
                lora_mlp=clip, tune_text=not clip, scan_blocks=not clip,
                num_templates=tpc)
    towers = ("visual",) if clip else ("visual", "text")
    _inject_jax_init(monkeypatch, params, 0, 4, towers, clip)
    jds, ds = _dataset(JaxDataset, size=res), _dataset(ImageArrayDataset,
                                                      size=res)
    train_idx, test_idx = np.arange(16), np.arange(16, 24)
    kw = dict(unlocked_groups=2, unlocked_text_layers=1, seed=0,
              verbose=False)
    if clip:
        kw_j = dict(text_weights=head["text_weights"])
        kw_p = dict(text_weights=torch.from_numpy(
            np.asarray(head["text_weights"])))
    else:
        kw_j = dict(prompt_tokens=head["prompt_tokens"])
        kw_p = dict(prompt_tokens=torch.from_numpy(
            np.asarray(head["prompt_tokens"])))
    jlog, log = _Log(), _Log()
    ref = jax_peft.finetune(
        b.model, params, JaxView(jds, train_idx, 8, shuffle=True, seed=3),
        None, JaxView(jds, test_idx, 8), jax_peft.PEFTConfig(**base),
        logger=jlog, **kw_j, **kw)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = peft.finetune(
        model, SplitView(ds, train_idx, 8, shuffle=True, seed=3), None,
        SplitView(ds, test_idx, 8), peft.PEFTConfig(**base), logger=log,
        device="cpu", **kw_p, **kw)
    losses = [r["train_loss"] for r in log.rows]
    assert len(losses) == 2
    np.testing.assert_allclose(losses, [r["train_loss"] for r in jlog.rows],
                               atol=1e-4)
    np.testing.assert_allclose(out["test"]["loss"], ref["test"]["loss"],
                               atol=1e-4)
    assert out["test"]["top1"] == ref["test"]["top1"]
    np.testing.assert_array_equal(out["test"]["cm"], ref["test"]["cm"])
    for name, p in model.named_parameters():
        assert torch.equal(p, start[name]), name
    assert not any(out["mask"].values())
    # JAX's LoRA report fields
    for key in ("method", "lora_rank", "lora_alpha", "num_adapted_kernels",
                "num_trainable", "lora_params"):
        assert out["report"][key] == ref["report"][key], key
    # the adapters moved, and agree with JAX's
    ref_ad = flax_adapters_to_port(_flat_npz(
        jax.tree.map(np.asarray, ref["adapters"])))
    assert out["adapters"].keys() == ref_ad.keys()
    for name, ab in out["adapters"].items():
        assert ab["b"].abs().max() > 0, name
        for leaf in ("a", "b"):
            diff = np.abs(ab[leaf].numpy() - ref_ad[name][leaf].numpy())
            assert diff.max() <= 5e-3 * (1 + np.abs(
                ref_ad[name][leaf].numpy()).max()), (name, leaf)
    # the returned params are W_eff under the plain names
    merged = lora.merged_params(model, out["adapters"], 8.0)
    assert out["params"].keys() == dict(model.named_parameters()).keys()
    for name in merged:
        assert torch.equal(out["params"][name], merged[name])


def test_lora_rejects_resume(clip_tiny):
    _, _, model = clip_tiny
    ds = _dataset(ImageArrayDataset, n=8, size=24)
    cfg = peft.PEFTConfig(resolution=24, num_classes=20, lr=1e-3, epochs=1,
                          lora_rank=4)
    with pytest.raises(ValueError, match="not supported with LoRA"):
        peft.finetune(model, SplitView(ds, np.arange(8), 4), None, None, cfg,
                      text_weights=torch.zeros(32, 20), device="cpu",
                      verbose=False, resume_from="ckpt")


@pytest.mark.parametrize("path", ["vit_scan", "siglip_scan", "model_remat"])
def test_remat_under_lora_gives_the_same_gradients(path, clip_tiny,
                                                   siglip_tiny):
    """A checkpointed block recomputes in the backward, which runs outside
    the ``lora_applied`` block that swapped W_eff in: the recompute reads
    the forward's W_eff, so the loss and the adapters' gradients with
    remat are those without it (the scanned encodes and the model flag)."""
    from aihab_clip_tpu_torch.models import fast_siglip, fast_vit
    from aihab_clip_tpu_torch.models.layers import set_remat

    b, params, model = siglip_tiny if path == "siglip_scan" else clip_tiny
    res = 32 if path == "siglip_scan" else 24
    adapters = {n: {k: t.clone().requires_grad_() for k, t in ab.items()}
                for n, ab in flax_adapters_to_port(_flat_npz(
                    _random_adapters(params, ("visual",), True))).items()}
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, res, res, 3)).astype(np.float32))

    def grads(remat):
        with lora.lora_applied(model, adapters, 8.0):
            if path == "vit_scan":
                _, out = fast_vit.vit_encode_scan(
                    model, images, model.config, project=True,
                    dtype=torch.float32, remat=remat)
            elif path == "siglip_scan":
                _, out = fast_siglip.siglip_encode_scan(
                    model, images, model.config, project=True,
                    dtype=torch.float32, remat=remat)
            else:
                set_remat(model, remat)
                _, out = model.encode_image(images, project=True)
        loss = out.square().sum()
        loss.backward()
        set_remat(model, False)
        model.zero_grad(set_to_none=True)
        got = {(n, k): t.grad for n, ab in adapters.items()
               for k, t in ab.items()}
        for ab in adapters.values():
            for t in ab.values():
                t.grad = None
        return loss.detach(), got

    l0, g0 = grads(False)
    l1, g1 = grads(True)
    assert torch.equal(l0, l1)
    for key, g in g0.items():
        assert g is not None and g.abs().max() > 0, key
        torch.testing.assert_close(g1[key], g, rtol=1e-6, atol=1e-7,
                                   msg=str(key))


# ---------------------------------------------------------------------------
# the adapters file, served by either engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora_cache")
    bundle = jax_zoo.load("random:" + ENGINE,
                          random_cfg=JaxCLIPConfig(**ENGINE_CFG), seed=5)
    npz = jax_zoo._npz_cache_path(ENGINE, root)
    npz.parent.mkdir(parents=True)
    save_params_npz(npz, bundle.params)
    jax_zoo._save_config(jax_zoo._config_cache_path(ENGINE, root),
                         bundle.config)
    return root, bundle.params


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engines_serve_each_others_adapters(writer, model_root, tmp_path,
                                            monkeypatch):
    """A ``lora_adapters.npz`` written by one package (the vision and text
    towers adapted, attention and MLP): both engines load it and answer the
    same batch within 1e-4 with the same top-1; the text head is the
    unmerged base's in both (JAX's quirk, ``serving.py:152-156``)."""
    root, params = model_root
    monkeypatch.setattr(jax_zoo, "default_cache_root", lambda: root)
    monkeypatch.setattr(zoo, "default_cache_root", lambda: root)
    flat = _flat_npz(_random_adapters(params, ("visual", "text"), True,
                                      rank=2, seed=11))
    path = tmp_path / "lora_adapters.npz"
    if writer == "port":
        flat = port_adapters_to_flax(flax_adapters_to_port(flat))
    np.savez(path, **flat)
    ref = JaxEngine(model=ENGINE, batch_size=4, flat=True, lora=str(path),
                    lora_alpha=4.0, verbose=False)
    port = ClassifierEngine(model=ENGINE, batch_size=4, flat=True,
                            lora=str(path), lora_alpha=4.0, verbose=False,
                            device="cpu")
    plain = ClassifierEngine(model=ENGINE, batch_size=4, flat=True,
                             verbose=False, device="cpu")
    imgs = np.random.default_rng(1).integers(0, 256, (3, 224, 224, 3),
                                             dtype=np.uint8)
    want, got = ref.classify_batch(imgs), port.classify_batch(imgs)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - plain.classify_batch(imgs)).max() > 1e-3
    assert torch.equal(port._text_weights, plain._text_weights)
    np.testing.assert_allclose(port._text_weights.numpy(),
                               np.asarray(ref._text_weights), atol=1e-5)


def test_engine_quantizes_the_merged_weights(model_root, tmp_path,
                                             monkeypatch):
    """``quantize="int8"`` with ``lora``: the int8 weights are those of
    W_eff (the merge comes before the quantization, as in JAX)."""
    from aihab_clip_tpu_torch.models.quant_vit import quantize_vit_params

    root, params = model_root
    monkeypatch.setattr(zoo, "default_cache_root", lambda: root)
    flat = _flat_npz(_random_adapters(params, ("visual",), False, rank=2))
    path = tmp_path / "a.npz"
    np.savez(path, **flat)
    eng = ClassifierEngine(model=ENGINE, batch_size=2, flat=True,
                           lora=str(path), quantize="int8", verbose=False,
                           device="cpu")
    plain = ClassifierEngine(model=ENGINE, batch_size=2, flat=True,
                             verbose=False, device="cpu")
    with torch.no_grad():
        merged = lora.lora_merge(dict(plain.bundle.model.named_parameters()),
                                 flax_adapters_to_port(flat), 16.0)
        for name, p in plain.bundle.model.named_parameters():
            p.copy_(merged[name])
    want = quantize_vit_params(plain.bundle.model, plain.bundle.config)

    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), where

    same(eng._qparams, want, "")
    assert not torch.equal(
        eng._qparams["transformer"]["resblocks_0"]["attn/in_proj"]["w8"],
        quantize_vit_params(ClassifierEngine(
            model=ENGINE, batch_size=2, flat=True, verbose=False,
            device="cpu").bundle.model, plain.bundle.config)
        ["transformer"]["resblocks_0"]["attn/in_proj"]["w8"])
