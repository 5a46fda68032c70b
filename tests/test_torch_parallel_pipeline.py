"""The port's GPipe pipeline (``aihab_clip_tpu_torch/parallel/pipeline.py``,
``train/pipeline_peft.py``) against the JAX package's on the 8-device
virtual CPU mesh: ``pipeline_encode`` over 2 stage ranks at 2 and 4
microbatches and its gradients (images and stage parameters), the composed
(data 2, stage 2) layout on 4 ranks, ``make_pipeline_train_step`` (loss,
updated blocks and head, frozen layers bit-identical) with
``stack_stage_params``' shapes, and departure D6 (JAX's ``_block`` runs
QuickGELU whatever the tower's activation; the port runs the tower's).

The port's ranks run as gloo subprocesses (``tests/torch_parallel_worker.
py``), one module-scoped launch per world size.  Tolerances are the JAX
suite's (``tests/test_pipeline_parallel.py``): forward 2e-4, gradients
5e-4, the step's loss 1e-5; the updated parameters within its Adam-aware
bound (|d| <= 2.05 lr) and within 1e-6 wherever JAX's gradient exceeds
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.parallel import pipeline as jax_pipeline
from aihab_clip_tpu.train import peft as jax_peft
from aihab_clip_tpu.train import pipeline_peft as jax_pipeline_peft

import torch_parallel_worker as worker
from aihab_clip_tpu_torch.models import CLIPConfig, CLIPModel
from aihab_clip_tpu_torch.models.convert import (flax_params_to_state_dict,
                                                 jax_param_path)
from aihab_clip_tpu_torch.parallel import pipeline
from aihab_clip_tpu_torch.train.pipeline_peft import stacked_layer_mask

PIPE = dict(embed_dim=32, image_resolution=16, vision_layers=4,
            vision_width=64, vision_patch_size=8, context_length=77,
            vocab_size=49408, transformer_width=64, transformer_heads=2,
            transformer_layers=2)
LR, CLASSES, UNLOCKED, LAUNCH_S = 1e-3, 5, 2, 150
BLK = "visual.transformer.resblocks.0."


@pytest.fixture(scope="module")
def bundle():
    b = jax_load("random:tiny-pipe", random_cfg=JaxCLIPConfig(**PIPE),
                 seed=7)
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        b.params)
    return b.model, params


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    tw = rng.standard_normal((PIPE["embed_dim"], CLASSES))
    return dict(images=rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
                u8=rng.integers(0, 256, (8, 24, 24, 3), dtype=np.uint8),
                labels=rng.integers(0, CLASSES, 8).astype(np.int32),
                tw=(tw / np.linalg.norm(tw, axis=0)).astype(np.float32))


def _launch(bundle, data, world, tmp_path_factory):
    workdir = tmp_path_factory.mktemp(f"pipe{world}")
    _, params = bundle
    torch.save(dict(
        pipe_config=PIPE, pipe_state_dict=flax_params_to_state_dict(params),
        pipe_images=data["images"], pipe_u8=data["u8"],
        pipe_labels=data["labels"],
        pipe_text_weights=torch.from_numpy(data["tw"]), pipe_classes=CLASSES,
        pipe_unlocked=UNLOCKED, lr=LR, resolution=16, num_classes=CLASSES,
        tune_text=False, num_templates=1), workdir / "inputs.pt")
    return worker.launch("pipeline", world, workdir, LAUNCH_S)


@pytest.fixture(scope="module")
def ranks2(bundle, data, tmp_path_factory):
    return _launch(bundle, data, 2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(bundle, data, tmp_path_factory):
    return _launch(bundle, data, 4, tmp_path_factory)


def _jax_encode(bundle, images, mesh, n_micro, grads=True, n_stages=2):
    model, params = bundle
    stacked = jax_pipeline.place_stage_params(
        mesh, jax_pipeline.stack_stage_params(params, PIPE["vision_layers"],
                                              n_stages))
    cfg = JaxCLIPConfig(**PIPE)

    def loss(stacked, x):
        pre = jax_pipeline.pipeline_encode(
            params, stacked, x, cfg, mesh, num_microbatches=n_micro,
            dtype=jnp.float32)
        return jnp.sum(pre.astype(jnp.float32) ** 2)

    pre, post = jax_pipeline.pipeline_encode(
        params, stacked, jnp.asarray(images), cfg, mesh,
        num_microbatches=n_micro, project=True, dtype=jnp.float32)
    if not grads:
        return np.asarray(pre), np.asarray(post), None, None
    g_stacked, g_x = jax.grad(loss, argnums=(0, 1))(stacked,
                                                    jnp.asarray(images))
    return np.asarray(pre), np.asarray(post), g_stacked, np.asarray(g_x)


def _jax_leaf(tree, key, ndim):
    """The JAX stacked leaf of a port block parameter name, in the port's
    layout ([stages, layers, ...] kept in front)."""
    path, perm = jax_param_path(BLK + key, ndim)
    leaf = tree
    for part in path.split("/")[3:]:
        leaf = leaf[part]
    leaf = np.asarray(leaf)
    return leaf.transpose((0, 1) + tuple(2 + p for p in perm))


@pytest.fixture(scope="module")
def jax_stage2(bundle, data):
    mesh = jax_pipeline.make_pipeline_mesh(2)
    return {m: _jax_encode(bundle, data["images"], mesh, m, grads=m == 2)
            for m in (2, 4)}


def _check_encode(got, ref, grads=True):
    pre, post, g_stacked, g_x = ref
    np.testing.assert_allclose(got["pre"].numpy(), pre, atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(got["post"].numpy(), post, atol=2e-4,
                               rtol=2e-4)
    if not grads:
        return
    np.testing.assert_allclose(got["g_x"].numpy(), g_x, atol=5e-4, rtol=5e-4)
    for key, g in got["g_stage"].items():
        ref_g = _jax_leaf(g_stacked, key, g.ndim - 1)[got["stage"]]
        np.testing.assert_allclose(g.numpy(), ref_g, atol=5e-4, rtol=5e-4,
                                   err_msg=key)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_encode_matches_jax(ranks2, jax_stage2, n_micro):
    for r in range(2):
        _check_encode(ranks2[r][f"m{n_micro}"], jax_stage2[n_micro],
                      grads=n_micro == 2)
    assert {ranks2[r]["m2"]["stage"] for r in range(2)} == {0, 1}


def test_composed_data_stage_mesh_matches_jax(ranks4, bundle, data):
    mesh = jax_pipeline.make_pipeline_mesh(2, data_parallel=2)
    ref = _jax_encode(bundle, data["images"], mesh, 2)
    for r in range(4):
        _check_encode(ranks4[r]["dp_pp"], ref)


def _jax_step(bundle, data, mesh):
    model, params = bundle
    cfg = jax_peft.PEFTConfig(resolution=16, num_classes=CLASSES, lr=LR,
                              epochs=1, crop_mode="center",
                              compute_dtype=jnp.float32)
    opt, step = jax_pipeline_peft.make_pipeline_train_step(
        model, cfg, jnp.asarray(data["tw"]), None, mesh, num_microbatches=2,
        unlocked_layers=UNLOCKED)
    trainable = jax_pipeline_peft.init_pipeline_trainable(
        params, JaxCLIPConfig(**PIPE), mesh)
    new, _, m = step(trainable, params, opt.init(trainable),
                     jnp.asarray(data["u8"]), jnp.asarray(data["labels"]),
                     jnp.ones(8, bool), jax.random.key(5), LR)
    return float(m["loss"]), int(m["correct"]), jax.device_get(new)


def _check_step(got, ref, bundle, stage):
    loss, correct, new = ref
    _, params = bundle
    assert got["loss"] == pytest.approx(loss, rel=1e-5, abs=1e-5)
    assert got["correct"] == correct
    mask = stacked_layer_mask(PIPE["vision_layers"], 2, UNLOCKED)[stage]
    sd = flax_params_to_state_dict(params)
    for key, leaf in got["blocks"].items():
        ref_leaf = _jax_leaf(new["blocks"], key, leaf.ndim - 1)[stage]
        for i in range(leaf.shape[0]):
            orig = sd[f"visual.transformer.resblocks.{2 * stage + i}.{key}"]
            if mask[i]:
                diff = np.abs(leaf[i].numpy() - ref_leaf[i])
                assert diff.max() <= 2.05 * LR, (key, i, diff.max())
                assert not torch.equal(leaf[i], orig), (key, i)
            else:   # locked: bit-identical to the weights it started from
                assert torch.equal(leaf[i], orig), (key, i)
    head = flax_params_to_state_dict({"visual": new["head"]})
    for key, t in got["head"].items():
        diff = np.abs(t.numpy() - head[f"visual.{key}"].numpy())
        assert diff.max() <= 2.05 * LR, (key, diff.max())


def test_pipeline_train_step_matches_jax(ranks2, bundle, data):
    ref = _jax_step(bundle, data, jax_pipeline.make_pipeline_mesh(2))
    for r in range(2):
        _check_step(ranks2[r]["step"], ref, bundle, ranks2[r]["m2"]["stage"])


def test_composed_pipeline_train_step_matches_jax(ranks4, bundle, data):
    ref = _jax_step(bundle, data,
                    jax_pipeline.make_pipeline_mesh(2, data_parallel=2))
    for r in range(4):
        _check_step(ranks4[r]["dp_step"], ref, bundle,
                    ranks4[r]["dp_pp"]["stage"])


def _port_model(params, act="quick_gelu"):
    model = CLIPModel(CLIPConfig(**PIPE, act=act))
    model.load_state_dict(flax_params_to_state_dict(params))
    return model


def test_stack_stage_params_shapes_match_jax(bundle):
    _, params = bundle
    mine = pipeline.stack_stage_params(_port_model(params), 4, 2)
    ref = jax_pipeline.stack_stage_params(params, 4, 2)
    for key, t in mine.items():
        assert t.shape[:2] == (2, 2), key
        np.testing.assert_array_equal(t.numpy(),
                                      _jax_leaf(ref, key, t.ndim - 2))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.stack_stage_params(_port_model(params), 4, 3)
    np.testing.assert_array_equal(
        stacked_layer_mask(4, 2, 3).numpy(),
        np.asarray(jax_pipeline_peft.stacked_layer_mask(4, 2, 3)))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_d6_stage_blocks_run_the_tower_act(bundle, data, act):
    """D6: JAX's ``_block`` is QuickGELU whatever the tower says; the port's
    stage blocks run the tower's act, so they equal the canonical module's
    blocks for both acts, and JAX's stage only for a QuickGELU tower."""
    _, params = bundle
    model = _port_model(params, act)
    x = torch.from_numpy(data["images"])
    from aihab_clip_tpu_torch.models.fast_vit import _stem, _vit_embed

    with torch.no_grad():
        h = _vit_embed(_stem(model.visual, torch.float32), x,
                       model.config)
        stacked = pipeline.stack_stage_params(model, 4, 1)
        mine = pipeline._stage_forward({k: v[0] for k, v in stacked.items()},
                                       h, model.visual.transformer
                                       .resblocks[0])
        canon = model.visual.transformer(h)
    ref = np.asarray(jax_pipeline._stage_forward(
        jax.tree.map(lambda t: t[0], jax_pipeline.stack_stage_params(
            params, 4, 1)), jnp.asarray(h.numpy()),
        model.config.vision_heads))
    torch.testing.assert_close(mine, canon, atol=1e-5, rtol=1e-5)
    if act == "quick_gelu":
        np.testing.assert_allclose(mine.numpy(), ref, atol=2e-4, rtol=2e-4)
    else:
        assert np.abs(mine.numpy() - ref).max() > 1e-3
