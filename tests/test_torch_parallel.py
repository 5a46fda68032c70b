"""The port's data, tensor and FSDP parallelism (``aihab_clip_tpu_torch/
parallel``) against the JAX package's on the 8-device virtual CPU mesh:
``process_shard_indices`` bit for bit, ``param_pspec`` and the port's
parameter shardings, one PEFT step on 2 gloo ranks (DP, TP, FSDP, the
scanned encode under TP) and on 4 (dp 2 x tp 2, FSDP with TP) against
JAX's DP, ``make_mesh(model_parallel=2)`` and FSDP steps, and a DP, TP
and FSDP evaluation against JAX's evaluation on a data mesh.  Each weight
read as JAX cuts it: under TP both towers' blocks (SigLIP's MAP head too)
as shards, under FSDP every tower block (LoRA's merge, the scanned
encodes, ConvNeXt, RN) gathering its own weights as it runs, each against
JAX's mesh step and bit for bit against the same step with every weight
gathered whole (the control, ``peft._make_train_step(control=True)``).

The JAX side runs in this process; the port's ranks run as subprocesses
(``tests/torch_parallel_worker.py``: gloo, a free port, a hard timeout),
one module-scoped launch per world size computing every result the tests
read.  Tolerances are the JAX suite's (``tests/test_parallel.py``): the
loss within rel 1e-4; the
gradients within atol 2e-5 (fp32; the sums over ranks and over the batch
round apart) and parameters after one Adam step within JAX's Adam-aware
bound (``tests/test_pipeline_parallel.py``: |d| <= 2.05 lr) against JAX's,
and within 1e-6 wherever JAX's gradient exceeds 1e-4 (there the first Adam
step is -lr sign(g) in both; below, where the gradient is rounding noise,
the sign is noise too)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
from aihab_clip_tpu.models import CLIPModel as JaxCLIPModel
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models import siglip as jax_siglip
from aihab_clip_tpu.parallel import make_mesh as jax_make_mesh
from aihab_clip_tpu.parallel import param_shardings as jax_param_shardings
from aihab_clip_tpu.parallel import shard_batch as jax_shard_batch
from aihab_clip_tpu.parallel import shard_params as jax_shard_params
from aihab_clip_tpu.parallel.distributed import \
    process_shard_indices as jax_shard_indices
from aihab_clip_tpu.parallel.mesh import param_pspec as jax_pspec
from aihab_clip_tpu.train.evaluate import evaluate as jax_evaluate
from aihab_clip_tpu.train import peft as jax_peft

import torch_parallel_worker as worker
from aihab_clip_tpu_torch.models import CLIP_ARCHS, SIGLIP_ARCHS, zoo
from aihab_clip_tpu_torch.models.convert import (flatten_params,
                                                 flax_params_to_state_dict,
                                                 jax_kernel_path,
                                                 jax_param_path,
                                                 state_dict_to_flax_params)
from aihab_clip_tpu_torch.parallel import distributed, mesh as port_mesh
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.tokenizer import tokenize

from test_torch_resnet import tiny_rn_params

TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2,
            vision_width=128, vision_patch_size=8, context_length=77,
            vocab_size=49408, transformer_width=128, transformer_heads=2,
            transformer_layers=2)
LR, B, UNLOCKED = 1e-3, 8, 2
LAUNCH_S = 150
# the towers whose frozen prefix runs per rank under DP (their embed dims)
PREFIX_TOWERS = {"random:SigLIP-Tiny": 64, "random:TinyConvNeXt": 32}
# the other towers' steps: FSDP per block for ConvNeXt and RN, TP for
# SigLIP (both towers' blocks and the MAP head cut), each at its unlock
# depth (the last block or stage, and the head)
TOWER_UNLOCKED = {"convnext": 2, "rn": 2, "siglip": 2}
SIGLIP = dataclasses.asdict(SIGLIP_ARCHS["SigLIP-Tiny"])


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def bundle():
    """JAX's tiny dry-run tower with noise on every leaf; the prompt tokens
    (the CLIP BPE, the port's equal to JAX's) and random unit text
    weights."""
    b = jax_load("random:dryrun", random_cfg=JaxCLIPConfig(**TINY), seed=0)
    params = _noisy(b.params, 3)
    prompts, tpc = gen_prompts(use_hierarchy=False, use_descriptive=False)
    w = np.random.default_rng(5).standard_normal((TINY["embed_dim"], 20))
    head = {"prompt_tokens": np.asarray(tokenize(prompts, context_length=77,
                                                 truncate=True)),
            "text_weights": (w / np.linalg.norm(w, axis=0)).astype(
                np.float32)}
    return b.model, params, head, tpc


def _port_draw(name, seed):
    """The port's random draw of a tower in JAX's layout (JAX's own init
    compiles for seconds more)."""
    sd = zoo.load(name, device="cpu", seed=seed).model.state_dict()
    return traverse_util.unflatten_dict(state_dict_to_flax_params(sd),
                                        sep="/")


@pytest.fixture(scope="module")
def towers(bundle):
    """{tower: (JAX model, JAX config, noisy params, port config dict,
    prompt tokens)}: TinyConvNeXt (the port's draw: gammas at N(0, 0.1)),
    TinyRN (BatchNorm statistics drawn) and SigLIP-Tiny (2 heads a tower),
    their prompt tokens random ids of its context."""
    tpc = bundle[3]
    out = {}
    cx = dataclasses.asdict(CLIP_ARCHS["TinyConvNeXt"])
    jcfg = JaxCLIPConfig(**cx)
    out["convnext"] = (JaxCLIPModel(jcfg), jcfg,
                       _noisy(_port_draw("random:TinyConvNeXt", 3), 4), cx)
    rn = dataclasses.asdict(CLIP_ARCHS["TinyRN"])
    jcfg = JaxCLIPConfig(**rn)
    out["rn"] = (JaxCLIPModel(jcfg), jcfg, tiny_rn_params(5), rn)
    jcfg = jax_siglip.SigLIPConfig(**SIGLIP)
    out["siglip"] = (jax_siglip.SigLIPModel(jcfg), jcfg,
                     _noisy(_port_draw("random:SigLIP-Tiny", 11), 12),
                     SIGLIP)
    rng = np.random.default_rng(13)
    for name, (m, c, p, d) in out.items():
        ctx = c.context_length
        tokens = (np.asarray(bundle[2]["prompt_tokens"]) if ctx == 77 else
                  rng.integers(1, 49408, (20 * tpc, ctx)).astype(np.int32))
        out[name] = (m, c, p, d, tokens)
    return out


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    # the last two rows padding: rank 0's shard holds 4 valid rows, rank
    # 1's 2 (a mean per rank would be wrong)
    return (rng.integers(0, 256, (B, 48, 48, 3), dtype=np.uint8),
            rng.integers(0, 20, B).astype(np.int32), np.arange(B) < 6)


def _inputs(bundle, batch, workdir, towers=None):
    _, params, head, tpc = bundle
    images, labels, valid = batch
    rng = np.random.default_rng(1)
    inp = dict(config=TINY, state_dict=flax_params_to_state_dict(params),
               resolution=32, num_classes=20, lr=LR, tune_text=True,
               num_templates=tpc, unlocked_groups=UNLOCKED,
               unlocked_text_layers=1,
               text_weights=torch.from_numpy(np.asarray(
                   head["text_weights"])),
               prompt_tokens=torch.from_numpy(np.asarray(
                   head["prompt_tokens"])),
               images=images, labels=labels, valid=valid,
               eval_images=rng.integers(0, 256, (10, 48, 48, 3),
                                        dtype=np.uint8),
               eval_labels=rng.integers(0, 20, 10).astype(np.int64),
               eval_batch=4, prefix_towers=PREFIX_TOWERS,
               prefix_text_weights={
                   t: torch.nn.functional.normalize(torch.from_numpy(
                       rng.standard_normal((d, 20)).astype(np.float32)),
                       dim=0) for t, d in PREFIX_TOWERS.items()})
    if towers is not None:
        inp.update(
            towers={t: (d, flax_params_to_state_dict(p))
                    for t, (_, _, p, d, _) in towers.items()},
            tower_tokens={t: torch.from_numpy(tok)
                          for t, (*_, tok) in towers.items()},
            tower_unlocked=TOWER_UNLOCKED)
    torch.save(inp, workdir / "inputs.pt")
    return inp


@pytest.fixture(scope="module")
def ranks2(bundle, batch, towers, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("par2")
    inp = _inputs(bundle, batch, workdir, towers)
    return (inp, worker.launch("steps", 2, workdir, LAUNCH_S),
            worker.launch("eval", 2, workdir, LAUNCH_S),
            {case: worker.launch(case, 2, workdir, LAUNCH_S)
             for case in ("mesh", "prefix")})


@pytest.fixture(scope="module")
def ranks4(bundle, batch, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("par4")
    _inputs(bundle, batch, workdir)
    return (worker.launch("steps", 4, workdir, LAUNCH_S),
            worker.launch("mesh", 4, workdir, LAUNCH_S))


def _jax_cfg(tpc, **kw):
    kw = dict(dict(tune_text=True), **kw)
    return jax_peft.PEFTConfig(resolution=32, num_classes=20, lr=LR,
                               epochs=1, crop_mode="center",
                               num_templates=tpc, fused_prefix=0, **kw)


def _adam_step(grads, trainable):
    """The update of JAX's make_train_step (optax's Adam), jitted as its
    step jits it (eager, each leaf's ops compile apart: seconds a step)."""
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    updates, _ = opt.update(grads, opt.init(trainable), trainable)
    return optax.apply_updates(trainable, updates)


def _jax_step(bundle, batch, mesh, fsdp=False, tower=None, adapters=None):
    """JAX's step on ``mesh``: (loss, correct, {port name: grad},
    {port name: updated parameter}); ``tower`` = (JAX model, config,
    params, _, prompt tokens) of one of ``towers``, at its unlock depth;
    ``adapters`` ({port name: {"a", "b"}}) trains them (LoRA, the base
    frozen; keys ``<name>.a``/``.b``)."""
    model, params, head, tpc = bundle
    jcfg, tokens, unlocked = (JaxCLIPConfig(**TINY), head["prompt_tokens"],
                              UNLOCKED)
    if tower is not None:
        model, jcfg, params, _, tokens = tower[:5]
        unlocked = tower[5]
    images, labels, valid = batch
    with jax.set_mesh(mesh):
        placed = jax_shard_params(mesh, params, fsdp=fsdp)
        if adapters is None:
            kind = getattr(jcfg, "vision_tower", "") or (
                "vit" if jcfg.is_vit else "rn")
            mask = jax_peft.build_lock_mask(
                placed, (jcfg.vision_layers if jcfg.is_vit
                         or kind == "convnext" else 0),
                jcfg.transformer_layers, unlocked_groups=unlocked,
                tune_text=True, unlocked_text_layers=1, is_vit=jcfg.is_vit,
                tower=kind)
            trainable, frozen = jax_peft.partition_params(placed, mask)
            cfg = _jax_cfg(tpc)
        else:
            trainable = {jax_kernel_path(n): {
                k: jnp.asarray(t.detach().numpy()) for k, t in ab.items()}
                for n, ab in adapters.items()}
            frozen = placed
            cfg = _jax_cfg(tpc, lora_rank=2, tune_text=False)
        loss_fn = jax_peft._build_loss_fn(
            model, cfg, jnp.asarray(head["text_weights"]),
            jnp.asarray(tokens), mesh=mesh)
        args = jax_shard_batch(mesh, images, labels, valid)
        (loss, (correct, _)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(trainable, frozen, *args,
                                    jax.random.key(0))
        new = jax.jit(_adam_step)(grads, trainable)
    if adapters is not None:
        names = {jax_kernel_path(n): n for n in adapters}
        to_port = lambda tree: {f"{names[p]}.{k}": np.asarray(v)
                                for p, ab in jax.device_get(tree).items()
                                for k, v in ab.items()}
    else:
        to_port = lambda tree: {k: v.numpy() for k, v in
                                flax_params_to_state_dict(jax.device_get(
                                    tree)).items()}
    return float(loss), int(correct), to_port(grads), to_port(new)


@pytest.fixture(scope="module")
def jax_tower_steps(bundle, batch, towers, ranks2):
    """JAX's FSDP steps of ConvNeXt and RN, its TP step of the SigLIP
    tower, and its LoRA step over an FSDP base (the worker's adapters)."""
    inp = ranks2[0]
    out = {t: _jax_step(bundle, batch, jax_make_mesh(), fsdp=True,
                        tower=towers[t] + (TOWER_UNLOCKED[t],))
           for t in ("convnext", "rn")}
    out["siglip"] = _jax_step(bundle, batch,
                              jax_make_mesh(model_parallel=2),
                              tower=towers["siglip"]
                              + (TOWER_UNLOCKED["siglip"],))
    out["lora"] = _jax_step(bundle, batch, jax_make_mesh(), fsdp=True,
                            adapters=worker.lora_adapters(
                                worker._model(inp)))
    return out


@pytest.fixture(scope="module")
def jax_steps(bundle, batch):
    return {"dp": _jax_step(bundle, batch, jax_make_mesh()),
            "tp": _jax_step(bundle, batch, jax_make_mesh(model_parallel=2)),
            "fsdp": _jax_step(bundle, batch, jax_make_mesh(), fsdp=True)}


def _close(got_grads, got_params, grads, params, grad_atol):
    """Gradients within ``grad_atol``; parameters after one Adam step
    within 2.05 lr, and within 1e-6 where the reference gradient exceeds
    1e-4."""
    assert set(got_grads) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(got_grads[name], g, atol=grad_atol,
                                   rtol=1e-4, err_msg=name)
        diff = np.abs(got_params[name] - params[name])
        assert diff.max() <= 2.05 * LR, (name, diff.max())
        sure = np.abs(g) > 1e-4
        assert (diff[sure] <= 1e-6).all(), (name, diff[sure].max())


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _against_jax(port, ref, grad_atol=2e-5):
    loss, correct, grads, params = ref
    assert port["loss"] == pytest.approx(loss, rel=1e-4)
    assert port["correct"] == correct
    _close(_np(port["grads"]), _np(port["params"]), grads, params, grad_atol)


def _against_port(got, ref, grad_atol=2e-5):
    """A sharded step against the port's single-rank (or DP) step: the
    JAX suite's loss within rel 1e-4, the gradients and the updated
    parameters as ``_close``."""
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    assert got["correct"] == ref["correct"]
    _close(_np(got["grads"]), _np(got["params"]), _np(ref["grads"]),
           _np(ref["params"]), grad_atol)


# ---------------------------------------------------------------------------
# no ranks needed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,count,even", [
    (103, 4, False), (103, 4, True), (100, 4, False), (100, 4, True),
    (11, 2, False), (11, 2, True), (7, 3, True), (64, 1, False)])
def test_process_shard_indices_match_jax(n, count, even):
    for seed in (0, 1, 9):
        for i in range(count):
            mine = distributed.process_shard_indices(
                n, seed=seed, process_index=i, process_count=count, even=even)
            ref = jax_shard_indices(n, seed=seed, process_index=i,
                                    process_count=count, even=even)
            assert mine.dtype == ref.dtype
            np.testing.assert_array_equal(mine, ref)


def test_single_process_defaults():
    distributed.initialize_distributed(num_processes=1)   # a no-op
    assert distributed.rank() == 0 and distributed.world_size() == 1
    np.testing.assert_array_equal(distributed.process_shard_indices(5),
                                  np.arange(5))
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_mesh(device="cpu")


@pytest.mark.parametrize("tp,fsdp,data", [
    (False, False, 8), (True, False, 4), (False, True, 8), (True, True, 4),
    (False, True, 2), (True, True, 3)])
def test_param_pspec_matches_jax(bundle, tp, fsdp, data):
    _, params, _, _ = bundle
    for path, leaf in flatten_params(params).items():
        kw = dict(fsdp=fsdp, shape=leaf.shape, data_size=data)
        assert port_mesh.param_pspec(path, tp, **kw) == tuple(
            jax_pspec(path, tp, **kw)), path


class _FakeMesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


@pytest.mark.parametrize("model_parallel,fsdp", [
    (1, False), (2, False), (1, True), (2, True)])
def test_param_shardings_match_jax(bundle, model_parallel, fsdp):
    """The port's spec of each parameter (its own layout) is JAX's spec of
    the same leaf, dims carried through the layout map."""
    _, params, _, _ = bundle
    sd = flax_params_to_state_dict(params)
    mine = port_mesh.param_shardings(_FakeMesh(8 // model_parallel,
                                               model_parallel), sd,
                                     fsdp=fsdp)
    ref = traverse_util.flatten_dict(jax_param_shardings(
        jax_make_mesh(model_parallel=model_parallel), params, fsdp=fsdp),
        sep="/")
    for name, t in sd.items():
        path, perm = jax_param_path(name, t.ndim)
        spec = tuple(ref[path].spec) + (None,) * t.ndim
        assert mine[name] == tuple(spec[perm[d]] for d in range(t.ndim)), \
            name
    blk = "visual.transformer.resblocks.0."
    if model_parallel == 2:
        assert mine[blk + "attn.in_proj_weight"][0] == "model"
        assert mine[blk + "mlp.c_proj.weight"][1] == "model"


@pytest.mark.parametrize("arch,blocks", [("TinyConvNeXt", 4), ("TinyRN", 4),
                                         ("Tiny", 2)])
def test_every_tower_block_gathers_its_own(arch, blocks):
    """Every block of a tower (the transformer blocks of both towers, the
    ConvNeXt blocks, the RN bottlenecks) is a ``GatherBlock`` FSDP gathers
    one at a time; ``set_remat`` remats the transformer blocks alone (JAX's
    ConvNeXt and RN towers take no remat)."""
    from aihab_clip_tpu_torch.models import CLIPModel
    from aihab_clip_tpu_torch.models.layers import (GatherBlock, RematBlock,
                                                    set_remat)

    with torch.device("meta"):
        model = CLIPModel(CLIP_ARCHS[arch])
    set_remat(model)
    found = [m for m in model.modules() if isinstance(m, GatherBlock)]
    text = [m for m in model.text.modules() if isinstance(m, GatherBlock)]
    assert len(found) - len(text) == blocks and len(text) == 2
    for m in found:
        assert getattr(m, "remat", False) == isinstance(m, RematBlock)
        assert isinstance(m, RematBlock) == (m in text or arch == "Tiny")


# ---------------------------------------------------------------------------
# 2 ranks: DP, TP (model 2), FSDP, the scanned encode under TP; evaluation
# ---------------------------------------------------------------------------


def test_dp_step_matches_jax_and_single_rank(ranks2, jax_steps):
    _, steps, _, _ = ranks2
    single = steps[0]["single"]
    for r in range(2):
        _against_jax(steps[r]["dp"], jax_steps["dp"])
        _against_port(steps[r]["dp"], single)
    # the loss is the global batch's masked mean (6 valid rows over ranks
    # holding 4 and 2), not the mean of two shard means
    assert steps[0]["dp"]["loss"] == steps[1]["dp"]["loss"]


def test_tp_step_matches_jax(ranks2, jax_steps):
    """TP 2 (both towers' blocks as Megatron shards) against JAX's GSPMD
    step and the single rank; its control (every weight gathered whole,
    the replicated forward) against JAX's step too."""
    _, steps, _, _ = ranks2
    for r in range(2):
        _against_jax(steps[r]["tp"], jax_steps["tp"])
        _against_port(steps[r]["tp"], steps[0]["single"])
        _against_jax(steps[r]["tp_whole"], jax_steps["tp"])
    # the block weights are Megatron's halves on each rank
    shapes = steps[0]["tp"]["local_shapes"]
    blk = "visual.transformer.resblocks.1."
    assert shapes[blk + "attn.in_proj_weight"] == (192, 128)
    assert shapes[blk + "attn.out_proj.weight"] == (128, 64)
    assert shapes[blk + "mlp.c_fc.weight"] == (256, 128)
    assert shapes[blk + "mlp.c_proj.weight"] == (128, 256)
    assert shapes[blk + "ln_1.weight"] == (128,)
    # the text tower's blocks too (one head of 64 on each rank)
    txt = "text.transformer.resblocks.1."
    assert shapes[txt + "attn.in_proj_weight"] == (192, 128)
    assert shapes[txt + "attn.out_proj.weight"] == (128, 64)
    assert shapes[txt + "mlp.c_fc.weight"] == (256, 128)


def test_fsdp_step_matches_dp_and_jax(ranks2, jax_steps):
    _, steps, _, _ = ranks2
    for r in range(2):
        _against_port(steps[r]["fsdp"], steps[r]["dp"])
        _against_jax(steps[r]["fsdp"], jax_steps["fsdp"])
    # parameters (and so the Adam moments over them) are cut in two by
    # param_pspec's rule: c_fc's kernel [128, 512] over its 512 outputs
    shapes = steps[0]["fsdp"]["local_shapes"]
    blk = "visual.transformer.resblocks.1."
    assert shapes[blk + "mlp.c_fc.weight"] == (256, 128)
    assert shapes[blk + "attn.in_proj_weight"] == (192, 128)
    assert shapes[blk + "ln_1.weight"] == (64,)
    assert shapes["visual.conv1.weight"] == (64, 3, 8, 8)


def test_fsdp_blocks_gather_their_weights_one_at_a_time(ranks2):
    """Under FSDP each transformer block gathers its weights as it runs,
    inside a checkpoint: autograd keeps none of them for the backward,
    which gathers each again for its recompute.  The scanned encode
    (without its remat) gathers each block in its loop body, inside the
    block's checkpoint, so autograd keeps none either, and it gathers as
    often as the module's blocks do."""
    _, steps, _, _ = ranks2
    for r in range(2):
        kept = steps[r]["fsdp_kept"]
        assert kept["per_block"]["kept"] == 0, kept
        assert kept["scan"]["kept"] == 0, kept
        assert kept["per_block"]["gathered"] == kept["scan"]["gathered"] > 0


@pytest.mark.parametrize("kind", ["per_block", "scan", "lora", "convnext",
                                  "rn"])
def test_fsdp_steps_keep_no_whole_weight(ranks2, kind):
    """Every per-block FSDP step (the module's blocks, the scanned encode,
    LoRA's W_eff merged by each block, ConvNeXt's and RN's blocks):
    autograd keeps no whole weight of a block for the backward, and the
    whole weights of at most one block are alive at any gather."""
    _, steps, _, _ = ranks2
    for r in range(2):
        kept = steps[r]["fsdp_kept"][kind]
        assert kept["gathered"] > 0 and kept["kept"] == 0, kept
        assert kept["live_blocks"] == 1, kept


@pytest.mark.parametrize("kind", ["fsdp", "lora_fsdp", "scan_fsdp",
                                  "scan_remat_fsdp", "convnext_fsdp",
                                  "rn_fsdp"])
def test_fsdp_per_block_matches_the_whole_gather(ranks2, kind):
    """Each per-block FSDP step against the same step with every weight
    gathered whole (the control, ``peft._make_train_step(control=True)``):
    the loss, the gradients and the updated parameters bit for bit (the
    same products in the same order; the backward's recompute repeats the
    forward's).  The scanned encodes run the module's products
    (``test_scan_blocks_under_tp_matches_canonical``), so the module's
    control is theirs."""
    _, steps, _, _ = ranks2
    control = "fsdp" if kind.startswith("scan") else kind
    for r in range(2):
        got, ref = steps[r][kind], steps[r][control + "_whole"]
        assert got["loss"] == ref["loss"] and got["correct"] == ref["correct"]
        for k in ("grads", "params"):
            assert set(got[k]) == set(ref[k])
            for name, t in ref[k].items():
                assert torch.equal(got[k][name], t), (k, name)


@pytest.mark.parametrize("tower", ["convnext", "rn"])
def test_fsdp_tower_steps_match_jax(ranks2, jax_tower_steps, tower):
    """ConvNeXt's and RN's FSDP steps (each block gathering its own
    weights; stems, downsamples and heads eagerly) against JAX's FSDP step
    on the virtual mesh and the port's single rank."""
    _, steps, _, _ = ranks2
    for r in range(2):
        _against_jax(steps[r][f"{tower}_fsdp"], jax_tower_steps[tower])
        _against_port(steps[r][f"{tower}_fsdp"], steps[0][f"{tower}_single"])
    shapes = steps[0][f"{tower}_fsdp"]["local_shapes"]
    if tower == "convnext":
        assert shapes["visual.stage3_block0.fc1.weight"] == (256, 128)
    else:
        assert shapes["visual.layer4_0.conv3.weight"][0] == 128


def test_lora_and_scan_fsdp_steps_match_jax(ranks2, jax_steps,
                                            jax_tower_steps):
    """LoRA over an FSDP base (each block merging its adapters into its
    gathered weights) against JAX's LoRA step on an FSDP mesh; the scanned
    encodes under FSDP (with and without remat) against JAX's FSDP step."""
    _, steps, _, _ = ranks2
    # the adapters' gradients reach ~50 (alpha / r = 8 scales them), and
    # fp32 rounds their sums by a share of the largest: past rtol 1e-4,
    # JAX's own DP and FSDP steps differ by 2.9e-6 of it and the port's
    # steps from JAX's FSDP one by 9.3e-6, where a merge with alpha off by
    # 1e-3 reads 6.0e-3 of it and W_eff rounded to bf16 6.9e-3.  So the
    # JAX suite's atol of 2e-5 for gradients of order 1 is taken relative
    # to the largest
    scale = max(float(np.abs(g).max())
                for g in jax_tower_steps["lora"][2].values())
    for r in range(2):
        _against_jax(steps[r]["lora_fsdp"], jax_tower_steps["lora"],
                     grad_atol=2e-5 * max(1.0, scale))
        for kind in ("scan_fsdp", "scan_remat_fsdp"):
            _against_jax(steps[r][kind], jax_steps["fsdp"])


def test_siglip_tp_step_matches_jax(ranks2, jax_tower_steps):
    """SigLIP under TP 2: both towers' blocks and the MAP head's attention
    and MLP run as Megatron shards (the probe replicated), against JAX's
    GSPMD step on a (data 4, model 2) mesh and the port's single rank."""
    _, steps, _, _ = ranks2
    for r in range(2):
        _against_jax(steps[r]["siglip_tp"], jax_tower_steps["siglip"])
        _against_port(steps[r]["siglip_tp"], steps[0]["siglip_single"])
    shapes = steps[0]["siglip_tp"]["local_shapes"]
    for pre in ("visual.transformer.resblocks.1.", "text.transformer."
                "resblocks.1.", "visual.attnpool."):
        assert shapes[pre + "attn.q_proj.weight"] == (32, 64), pre
        assert shapes[pre + "attn.v_proj.bias"] == (32,), pre
        assert shapes[pre + "attn.out_proj.weight"] == (64, 32), pre
        assert shapes[pre + "mlp.c_fc.weight"] == (64, 64), pre
        assert shapes[pre + "mlp.c_proj.weight"] == (64, 64), pre
    assert shapes["visual.attnpool.probe"] == (1, 1, 64)
    assert shapes["visual.attnpool.ln.weight"] == (64,)


def test_scan_blocks_under_tp_matches_canonical(ranks2):
    _, steps, _, _ = ranks2
    for r in range(2):
        for k in ("grads", "params"):
            for name, t in steps[r]["tp"][k].items():
                assert torch.equal(steps[r]["scan_tp"][k][name], t), name


def test_lora_steps_under_dp_and_fsdp(ranks2):
    """LoRA on the data axis (adapters replicated, their gradients summed)
    and over an FSDP-sharded base (gathered whole, then merged), against
    the single rank's LoRA step."""
    _, steps, _, _ = ranks2
    for r in range(2):
        for kind in ("lora_dp", "lora_fsdp"):
            _against_port(steps[r][kind], steps[0]["lora_single"])


def test_block_kernel_encode_sharded(ranks2):
    """``vit_encode_block_fused_sharded``: each rank encodes its rows; the
    gathered features are the single-rank encode's."""
    _, _, evals, _ = ranks2
    for r in range(2):
        for got, ref in zip(evals[r]["fused_sharded"], evals[r]["fused"]):
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_dp_tp_fsdp_evaluations_match_jax(ranks2, bundle):
    """Every rank's confusion matrix is the single rank's, and JAX's
    evaluation of the split on a data mesh."""
    inp, _, evals, _ = ranks2
    model, params, head, _ = bundle
    from aihab_clip_tpu.data.bulk_load import ImageArrayDataset as JaxDS
    from aihab_clip_tpu.data.pipeline import SplitView as JaxView

    n = len(inp["eval_labels"])
    ds = JaxDS(images=inp["eval_images"], labels=inp["eval_labels"],
               l2_labels=np.zeros(n, np.int64),
               poly_labels=np.full(n, -1, np.int64),
               plot_word_labels=[""] * n, poly_word_labels=[""] * n,
               file_names=[f"img_{i}.jpg" for i in range(n)],
               plot_idx=list(range(n)), image_sources=["synthetic"] * n)
    mesh = jax_make_mesh(jax.devices()[:2])
    with jax.set_mesh(mesh):
        ref = jax_evaluate(
            model, jax_shard_params(mesh, params), JaxView(ds, np.arange(n),
                                                           4),
            jnp.asarray(head["text_weights"]), 32, 20,
            return_confusion_matrix=True, mesh=mesh)
    single = evals[0]["single"]
    np.testing.assert_array_equal(single["cm"], np.asarray(ref["cm"]))
    for r in range(2):
        for kind in ("dp", "tp", "fsdp"):
            got = evals[r][kind]
            np.testing.assert_array_equal(got["cm"], single["cm"])
            assert got["loss"] == pytest.approx(ref["loss"], rel=1e-4)
            for k in ("top1", "top3", "f1", "mcc"):
                assert got[k] == pytest.approx(float(ref[k]), abs=1e-6), k


# ---------------------------------------------------------------------------
# 4 ranks: dp 2 x tp 2, FSDP with TP
# ---------------------------------------------------------------------------


def test_dp2_tp2_step_matches_jax(ranks4, jax_steps):
    steps = ranks4[0]
    single = steps[0]["single"]
    for r in range(4):
        for kind in ("dp", "dp_tp", "scan_dp_tp", "fsdp_tp"):
            _against_jax(steps[r][kind], jax_steps["tp" if "tp" in kind
                                                   else "dp"])
            _against_port(steps[r][kind], single)
    shapes = steps[0]["fsdp_tp"]["local_shapes"]
    blk = "visual.transformer.resblocks.1."
    # JAX's P('data', 'model') on c_fc's kernel: TP's output cut, then the
    # data axis on the input dim
    assert shapes[blk + "mlp.c_fc.weight"] == (256, 64)
    assert shapes[blk + "mlp.c_proj.weight"] == (64, 256)


# ---------------------------------------------------------------------------
# the mesh itself, and the other towers' prefixes under DP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_layout_and_collectives(ranks2, ranks4, world):
    """JAX's device grid (rank r at (r // model, r % model)), the groups
    along each axis, the batch shard and make_global_batch (the shards
    joined by rank), replicated (rank 0's value), the head-aligned
    gather of a packed qkv vector and its reduce-scatter, and
    gather_param's backwards (reduce-scatter: the data ranks' sum; kept:
    this rank's piece)."""
    out = ranks2[3]["mesh"] if world == 2 else ranks4[1]
    model = 2 if world == 4 else 1
    data = world // model
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    for r, got in enumerate(out):
        d, m = r // model, r % model
        assert got["shape"] == {"data": data, "model": model}
        assert got["coords"] == {"data": d, "model": m}
        assert got["ranks"]["data"] == [k * model + m for k in range(data)]
        assert got["ranks"]["model"] == [d * model + k for k in range(model)]
        rows = got["rows"]
        assert (rows.start, rows.stop) == (d * 8 // data, (d + 1) * 8 // data)
        torch.testing.assert_close(got["local"], x[rows], rtol=0, atol=0)
        torch.testing.assert_close(got["global"], x, rtol=0, atol=0)
        assert torch.equal(got["replicated"], torch.zeros(3))
        # the packed [3W] vector of data rank d is cut per q, k and v
        qkv = torch.arange(12, dtype=torch.float32) + 100 * d
        n = 4 // data
        want = torch.cat([qkv[g * 4 + d * n:g * 4 + (d + 1) * n]
                          for g in range(3)])
        assert torch.equal(got["piece"], want)
        pieces = [torch.cat([torch.arange(12.)[g * 4 + k * n:
                                              g * 4 + (k + 1) * n]
                             + 100 * k for g in range(3)])
                  for k in range(data)]
        whole = torch.cat([torch.cat([p[g * n:(g + 1) * n] for p in pieces])
                           for g in range(3)])
        assert torch.equal(got["whole"], whole)
        total = sum(k * model + m + 1 for k in range(data))
        assert torch.equal(got["summed"], torch.full((3 * n,), float(total)))
        assert torch.equal(got["grad_reduced"],
                           torch.full((3 * n,), 2.0 * data))
        assert torch.equal(got["grad_kept"], torch.full((3 * n,), 2.0))


@pytest.mark.parametrize("tower", list(PREFIX_TOWERS))
def test_prefix_hybrids_under_dp_match_the_single_rank(ranks2, tower):
    """SigLIP's (K5/K4) and ConvNeXt's (K7) frozen prefix run per rank on
    its rows (their plain versions on the CPU): the DP step is the single
    rank's, within the JAX suite's DP tolerances above."""
    out = ranks2[3]["prefix"]
    for r in range(2):
        _against_port(out[r][tower]["dp"], out[0][tower]["single"])
