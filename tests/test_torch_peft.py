"""The port's PEFT loop against the JAX package on the same weights: the
lock masks (CLIP and SigLIP, including SigLIP's text-head group quirk) and
a two-epoch ``finetune`` trail; plus the pieces around them (data view,
schedule, objective tail, tracker) and the options this package does not
carry yet.  The hybrid encode and the train objective:
``tests/test_torch_peft_step.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from aihab_clip_tpu.data.bulk_load import ImageArrayDataset as JaxDataset
from aihab_clip_tpu.data.pipeline import SplitView as JaxView
from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
from aihab_clip_tpu.models import build_text_head as jax_text_head
from aihab_clip_tpu.models import fast_vit as jax_fast_vit
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models import siglip as jax_siglip
from aihab_clip_tpu.train.evaluate import masked_ce_metrics as jax_masked_ce
from aihab_clip_tpu.train import peft as jax_peft
from aihab_clip_tpu.train.prolip import cosine_lr as jax_cosine_lr
from aihab_clip_tpu.train.tracker import ClassificationTracker as JaxTracker

from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
from aihab_clip_tpu_torch.models import CLIPConfig, SigLIPConfig
from aihab_clip_tpu_torch.models.convert import (_convert_key,
                                                 flatten_params,
                                                 flax_params_to_state_dict)
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.train import peft
from aihab_clip_tpu_torch.train.evaluate import masked_ce_metrics
from aihab_clip_tpu_torch.train.prolip import cosine_lr
from aihab_clip_tpu_torch.train.tracker import ClassificationTracker

TINY_CLIP = dict(embed_dim=32, image_resolution=24, vision_layers=3,
                 vision_width=64, vision_patch_size=8, context_length=77,
                 vocab_size=49408, transformer_width=64, transformer_heads=1,
                 transformer_layers=2)


def _noisy(params, seed):
    """JAX init plus seeded noise, so no bias is zero and no LN scale one."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)


def _port_model(params, config, model_cls=None):
    from aihab_clip_tpu_torch.models import CLIPModel, SigLIPModel

    cls = model_cls or (SigLIPModel if isinstance(config, SigLIPConfig)
                        else CLIPModel)
    model = cls(config)
    model.load_state_dict(flax_params_to_state_dict(params))
    return model.eval()


def _port_names(flat_jax_keys):
    """JAX '/'-joined parameter paths -> the port's parameter names."""
    return {_convert_key(k, np.zeros((1, 1, 1, 1)))[0] for k in flat_jax_keys}


@pytest.fixture(scope="module")
def siglip_tiny():
    """(JAX bundle, noisy JAX params, port model on the same weights)."""
    b = jax_load("random:SigLIP-Tiny", seed=2)
    params = _noisy(b.params, 9)
    model = _port_model(params, SigLIPConfig(**dataclasses.asdict(b.config)))
    return b, params, model


@pytest.fixture(scope="module")
def clip_tiny():
    b = jax_load("random:tiny-peft", random_cfg=JaxCLIPConfig(**TINY_CLIP),
                 seed=1)
    return b, _port_model(b.params, CLIPConfig(**TINY_CLIP))


# ---------------------------------------------------------------------------
# lock masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tower", ["clip", "siglip"])
@pytest.mark.parametrize("unlocked_groups", [0, 1, 2, "all"])
@pytest.mark.parametrize("text", [(False, 0), (True, 0), (True, 1)])
def test_lock_mask_matches_jax(tower, unlocked_groups, text, clip_tiny,
                               siglip_tiny, request):
    b, model = (clip_tiny if tower == "clip" else siglip_tiny[::2])
    cfg = b.config
    tune_text, text_layers = text
    u = cfg.vision_layers + 2 if unlocked_groups == "all" else unlocked_groups
    ref = jax_peft.build_lock_mask(
        b.params, cfg.vision_layers, cfg.transformer_layers,
        unlocked_groups=u, tune_text=tune_text,
        unlocked_text_layers=text_layers)
    flat = {"/".join(k): bool(v)
            for k, v in traverse_util.flatten_dict(ref).items()}
    mask = peft.build_lock_mask(model, cfg.vision_layers,
                                cfg.transformer_layers, unlocked_groups=u,
                                tune_text=tune_text,
                                unlocked_text_layers=text_layers)
    assert set(mask) == _port_names(flat)
    assert {n for n, v in mask.items() if v} == \
        _port_names(k for k, v in flat.items() if v)
    for name, param in model.named_parameters():
        assert param.requires_grad == mask[name]
    report = peft.trainable_report(mask)
    ref_report = jax_peft.trainable_report(ref)
    for key in ("num_trainable", "num_frozen", "fraction_trainable"):
        assert report[key] == ref_report[key]


def test_siglip_text_head_quirk(siglip_tiny):
    """SigLIP's text ``head`` Dense sits in group 0 (``peft.py:98-105``): at
    unlocked_text_layers=1 only ``text.ln_final`` trains, in both packages."""
    b, _, model = siglip_tiny
    mask = peft.build_lock_mask(model, 2, 2, unlocked_groups=0,
                                tune_text=True, unlocked_text_layers=1)
    assert sorted(n for n, v in mask.items() if v) == [
        "text.ln_final.bias", "text.ln_final.weight"]
    ref = jax_peft.build_lock_mask(b.params, 2, 2, tune_text=True,
                                   unlocked_text_layers=1)
    assert not any(traverse_util.flatten_dict(ref["text"]["head"]).values())


# ---------------------------------------------------------------------------
# the finetune trail
# ---------------------------------------------------------------------------


def _head(bundle, params):
    prompts, tpc = gen_prompts(use_hierarchy=False, use_descriptive=False)
    head = jax_text_head(bundle.model, params, prompts, 20, tpc)
    return head, tpc



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


def test_finetune_trail_matches_jax(siglip_tiny):
    """Two epochs of PEFT on SigLIP-Tiny (24 images at 32 px, batch 8,
    center crop, tune_text with the text head recomputed in-step): the port
    with its fused prefix on (K5/K4 plain versions) against JAX's
    ``finetune`` with the canonical module.  Per-epoch train losses and the
    final test loss within 1e-4, equal test top-1; trained leaves agree by
    ``tests/test_peft.py``'s statistics; frozen leaves stay bit-identical."""
    b, params, model = siglip_tiny
    head, tpc = _head(b, params)
    base = dict(resolution=32, num_classes=20, lr=2e-3, epochs=2,
                crop_mode="center", tune_text=True, num_templates=tpc)
    kw = dict(unlocked_groups=2, unlocked_text_layers=1, seed=0,
              verbose=False)
    jds, ds = _dataset(JaxDataset), _dataset(ImageArrayDataset)
    train_idx, test_idx = np.arange(16), np.arange(16, 24)
    jlog, log = _Log(), _Log()
    ref = jax_peft.finetune(
        b.model, params, JaxView(jds, train_idx, 8, shuffle=True, seed=3),
        None, JaxView(jds, test_idx, 8),
        jax_peft.PEFTConfig(fused_prefix=0, **base),
        prompt_tokens=head["prompt_tokens"], logger=jlog, **kw)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    try:
        out = peft.finetune(
            model, SplitView(ds, train_idx, 8, shuffle=True, seed=3), None,
            SplitView(ds, test_idx, 8),
            peft.PEFTConfig(fused_prefix=1, **base),
            prompt_tokens=torch.from_numpy(np.asarray(head["prompt_tokens"])),
            logger=log, device="cpu", **kw)
    finally:
        trained = {n: p.detach().clone() for n, p in model.named_parameters()}
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
    losses = [r["train_loss"] for r in log.rows]
    ref_losses = [r["train_loss"] for r in jlog.rows]
    assert len(losses) == 2
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4)
    np.testing.assert_allclose(out["test"]["loss"], ref["test"]["loss"],
                               atol=1e-4)
    assert out["test"]["top1"] == ref["test"]["top1"]
    np.testing.assert_array_equal(out["test"]["cm"], ref["test"]["cm"])
    ref_params = dict(_convert_key(k, v)
                      for k, v in flatten_params(ref["params"]).items())
    changed = 0
    for name, mask in out["mask"].items():
        if not mask:
            assert torch.equal(trained[name], start[name]), name
            continue
        changed += not torch.equal(trained[name], start[name])
        diff = np.abs(trained[name].numpy() - ref_params[name])
        tight = np.mean(diff <= 5e-3 * (1 + np.abs(ref_params[name])))
        assert tight >= 0.98, (name, tight)
        assert diff.max() <= 0.1, (name, diff.max())
    assert changed > 0
    assert out["report"]["num_trainable"] == ref["report"]["num_trainable"]
    rows = len(out["tracker"].misclassified) + \
        len(out["tracker"].accurate_classified)
    assert rows == 8


# ---------------------------------------------------------------------------
# the pieces around the step
# ---------------------------------------------------------------------------


def test_batches_match_jax():
    jds, ds = _dataset(JaxDataset, n=13), _dataset(ImageArrayDataset, n=13)
    idx = np.arange(1, 13)
    for epoch in (0, 1, 5):
        ref = list(JaxView(jds, idx, 5, shuffle=True, seed=7).batches(epoch))
        got = list(SplitView(ds, idx, 5, shuffle=True, seed=7).batches(epoch))
        assert len(got) == len(ref) == 3
        for a, r in zip(got, ref):
            for field in ("images", "labels", "valid", "indices"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(r, field))
            assert a.n_valid == r.n_valid
    assert len(SplitView(ds, idx, 5, drop_remainder=True)) == 2


def test_schedule_objective_and_tracker_match_jax():
    for epoch in range(6):
        assert cosine_lr(5e-5, epoch, 5) == jax_cosine_lr(5e-5, epoch, 5)
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((6, 20)).astype(np.float32) * 4
    labels = rng.integers(0, 20, 6).astype(np.int32)
    valid = np.array([True, True, False, True, True, False])
    loss, (correct, n_valid) = masked_ce_metrics(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(valid))
    ref_loss, (ref_correct, ref_n) = jax_masked_ce(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    assert int(correct) == int(ref_correct) and float(n_valid) == float(ref_n)
    meta = [{"file_name": f"{i}.jpg", "image_source": "s"} for i in range(4)]
    mine, ref = ClassificationTracker(), JaxTracker()
    mine.track_batch(logits, labels, valid, meta)
    ref.track_batch(logits, labels, valid, meta)
    assert mine.misclassified == ref.misclassified
    assert mine.accurate_classified == ref.accurate_classified


def test_fused_prefix_length_matches_jax_on_the_accelerator(monkeypatch):
    """Auto prefix on the card equals JAX's on the TPU; 0 off the card."""
    monkeypatch.setattr(jax_fast_vit, "dispatch_backend", lambda: "tpu")
    monkeypatch.setattr(peft, "resolve_device",
                        lambda device: torch.device("cuda"))
    for name in ("ViT-SO400M-16-SigLIP2-384", "ViT-B-16-SigLIP-224"):
        cfg = jax_siglip.SIGLIP_ARCHS[name]
        port_cfg = SigLIPConfig(**dataclasses.asdict(cfg))
        for u in (1, 11, 27, 40):
            assert peft.peft_fused_prefix_len(port_cfg, u, "cuda") == \
                jax_fast_vit.peft_fused_prefix_len(cfg, u)
    so400m = SigLIPConfig(**dataclasses.asdict(
        jax_siglip.SIGLIP_ARCHS["ViT-SO400M-16-SigLIP2-384"]))
    assert peft.peft_fused_prefix_len(so400m, 11, "cuda") == 17
    monkeypatch.undo()
    assert peft.peft_fused_prefix_len(so400m, 11, "cpu") == 0


@pytest.mark.parametrize("change,kwargs", [
    ({"lora_rank": 4}, {}),
    ({"scan_blocks": True}, {}), ({"device_dataset": "chunked"}, {}),
    ({}, {"mesh": object()}),
    ({}, {"fsdp": True}), ({}, {"resume_from": "ckpt"}),
    ({}, {"checkpoint_fn": print}), ({}, {"profile_dir": "trace"}),
])
def test_unported_options_raise(siglip_tiny, change, kwargs):
    model = siglip_tiny[2]
    ds = _dataset(ImageArrayDataset, n=8)
    cfg = peft.PEFTConfig(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                          **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        peft.finetune(model, SplitView(ds, np.arange(8), 4), None, None, cfg,
                      text_weights=torch.zeros(64, 20), device="cpu",
                      verbose=False, **kwargs)


def test_finetune_argument_checks(siglip_tiny, clip_tiny):
    _, _, model = siglip_tiny
    ds = _dataset(ImageArrayDataset, n=8)
    view = SplitView(ds, np.arange(8), 4)
    cfg = peft.PEFTConfig(resolution=32, num_classes=20, lr=1e-3, epochs=1)
    with pytest.raises(ValueError, match="frozen bottom depth"):
        peft.finetune(model, view, None, None,
                      dataclasses.replace(cfg, fused_prefix=2),
                      text_weights=torch.zeros(64, 20), unlocked_groups=2,
                      device="cpu", verbose=False)
    with pytest.raises(ValueError, match="text_weights"):
        peft.finetune(model, view, None, None, cfg, device="cpu",
                      verbose=False)
    with pytest.raises(ValueError, match="prompt_tokens"):
        peft.finetune(model, view, None, None,
                      dataclasses.replace(cfg, tune_text=True), device="cpu",
                      verbose=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            peft.finetune(model, view, None, None, cfg,
                          text_weights=torch.zeros(64, 20), verbose=False)
    # a CLIP ViT's fused prefix runs vit_encode_hybrid (K1 over a pack of
    # the prefix blocks), on the CPU through the plain versions
    _, clip = clip_tiny
    ccfg = dataclasses.replace(cfg, fused_prefix=1)
    assert len(peft._pack_prefix(clip, ccfg)["blocks"]) == 1
    with torch.no_grad():
        pre, proj = peft._encode_projected(clip, ccfg,
                                           torch.zeros(1, 24, 24, 3))
    assert pre.shape == (1, 64) and proj.shape == (1, 32)
