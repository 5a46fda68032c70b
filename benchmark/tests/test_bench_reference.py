"""The plain reference against the port at a tiny size on the CPU: the
classifier of both families through the harness, the fine-tune step, the
tokenizer, the augment and the lock mask."""

import json

import numpy as np
import pytest
import torch

from benchmark import checks, harness, system
from benchmark.reference import augment, clip_bpe, towers, train
from conftest import tiny_config

SEED = 2 ** 31 + 4242


def run(cell, seconds=0.5, **options):
    import time

    return harness.run_cell(cell, SEED, seconds, False, "cpu",
                            time.perf_counter(), options)


@pytest.mark.parametrize("family", ["siglip", "clip_vit"])
def test_classify_cell_matches_reference(tiny_cell, family):
    cell = tiny_cell("so400m-classify-b64", family,
                     {"batch": 4, "pool_batches": 3, "check_rows": 8,
                      "warmup_batches": 1},
                     {"logit_gap": 1e-3, "logit_rms": 1e-3})
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] < 1e-3
    assert res["failed"] == 0 and res["attempted"] > 0


def test_serve_cell_matches_reference(tiny_cell):
    cell = tiny_cell("so400m-classify-b64", "siglip",
                     dict(json.loads((harness.BENCH / "traffic"
                                      / "serve_open.json").read_text()),
                          batch=8, rate_per_s=100, pool_images=16,
                          check_rows=16),
                     {"logit_gap": 1e-3, "logit_rms": 1e-3})
    res = run(cell, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["run"]["requests"] == 100


def peft_cell(tiny_cell):
    traffic = dict(json.loads((harness.BENCH / "traffic"
                               / "peft_step_b16.json").read_text()),
                   batch=4, image_size=40, pool_batches=4, unlocked_groups=2)
    return tiny_cell("so400m-classify-b64", "siglip", traffic,
                     {"loss_gap_1": 1e-4, "loss_gap_2": 1e-4,
                      "loss_gap_3": 1e-4, "grad_gap": 1e-3,
                      "change_gap": 1e-3, "grad_diff": 1e-3})


def test_peft_cell_matches_reference(tiny_cell):
    """In float32 the program and the reference run the same algorithm:
    every checked step's loss, not only the first, agrees."""
    res = run(peft_cell(tiny_cell))
    assert res["correct"], res["checks"]
    assert res["run"]["leaves_left_out"] == 2   # the two k_proj biases
    for k in (2, 3):
        assert res["checks"][f"loss_gap_{k}"]["value"] < 1e-4


def test_bf16_reference_reads_parameters_rounded(tiny_cell):
    """The reference in bfloat16: its products' operands rounded, and with
    ``reads`` every parameter read rounded too, the gradient passing
    through to the float32 leaf.  A fine-tune run holds the program to it
    as well, and ``--look`` adds what the first step moved."""
    w = torch.tensor([1.0 + 2 ** -10, 3.0], requires_grad=True)
    both = towers.Bf16({"a": w}, reads=True)
    products = towers.Bf16({"a": w}, reads=False)
    assert both["a"][0].item() == 1.0 and products["a"][0].item() > 1.0
    assert products.round(w)[0].item() == 1.0
    both["a"].sum().backward()
    assert torch.equal(w.grad, torch.ones(2))
    res = run(peft_cell(tiny_cell), look=True)
    look = res["run"]["look"]
    assert look["first_step"]["matrix"]["elements"] > 0
    assert len(look["bf16_reads"]["losses"]) == 3
    assert len(res["run"]["bf16_losses"]) == 3
    for k in (1, 2, 3):
        assert res["run"]["readings"][f"bf16_loss_gap_{k}"] < 0.05


def test_bpe_copy_matches_the_port():
    from aihab_clip_tpu_torch.tokenizer import tokenize

    prompts = json.loads(checks.PROMPTS.read_text())["prompts"]
    for ctx in (16, 64, 77):
        np.testing.assert_array_equal(
            clip_bpe.tokenize(prompts, ctx),
            tokenize(prompts, context_length=ctx, truncate=True))


def test_frozen_prompts_match_the_port():
    from aihab_clip_tpu_torch.templates import gen_prompts

    prompts, per = gen_prompts(use_hierarchy=True, use_descriptive=True)
    frozen = json.loads(checks.PROMPTS.read_text())
    assert frozen["prompts"] == prompts
    assert frozen["templates_per_class"] == per


def test_augment_matches_the_port():
    from aihab_clip_tpu_torch.ops.fast_warp import fast_train_transform

    g = torch.Generator().manual_seed(7)
    images = torch.randint(0, 256, (3, 53, 47, 3), generator=g,
                           dtype=torch.uint8)
    want = fast_train_transform(images, torch.Generator().manual_seed(11),
                                32, rotation=True, mean=towers.HALF,
                                std=towers.HALF)
    got = augment.augment(images, torch.Generator().manual_seed(11), 32,
                          towers.HALF, towers.HALF)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("family", ["siglip", "clip_vit"])
@pytest.mark.parametrize("groups,text_layers", [(2, 1), (4, 0), (1, 3)])
def test_trainable_set_matches_the_lock_mask(family, groups, text_layers):
    from aihab_clip_tpu_torch.train.peft import build_lock_mask

    cfg = tiny_config(family)
    weights = towers.make_weights(cfg, SEED, "cpu")
    model, pcfg = system.port_model(cfg, weights, "cpu", torch.float32)
    mask = build_lock_mask(model, pcfg.vision_layers,
                           pcfg.transformer_layers, unlocked_groups=groups,
                           tune_text=True, unlocked_text_layers=text_layers)
    want = {n for n, v in mask.items() if v}
    assert set(train.trainable(weights, cfg, groups, True,
                               text_layers)) == want


def test_image_features_match_the_port_module():
    for family in ("siglip", "clip_vit"):
        cfg = tiny_config(family)
        weights = towers.make_weights(cfg, SEED, "cpu")
        model, _ = system.port_model(cfg, weights, "cpu", torch.float32)
        params = {k: v.float() for k, v in weights.items()}
        x = torch.randn(2, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(1))
        _, want = model.encode_image(x, project=True)
        torch.testing.assert_close(towers.image_features(x, params, cfg),
                                   want, atol=1e-4, rtol=1e-4)
