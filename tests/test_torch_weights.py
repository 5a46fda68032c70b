"""Real weights into the port, against the JAX package's ``load`` on the
same files (tiny sizes, numpy-seeded weights, nothing from the network):

* OpenAI/open_clip torch checkpoints: a state-dict ``.pt`` in fp32 and
  fp16, a JIT archive, a DDP ``module.`` prefix with ``attn_mask`` buffers,
  an open_clip training file (``{"state_dict": ...}``): the port's state
  dict equals ``flax_params_to_state_dict`` of JAX's params bit for bit,
  features at 5e-5/1e-4; the converted caches each package writes load in
  the other;
* ``config_from_state_dict_shapes`` equal to JAX's for every CLIP_ARCHS row;
* open_clip ConvNeXt state dicts (with and without ``module.``), by file
  and from an HF snapshot;
* HF SigLIP snapshots (``transformers.SiglipModel.save_pretrained``) in
  fp32 and BF16, single and sharded, with a ``config.json`` stripped of
  defaults: the state dict bit for bit, token ids, features and zero-shot
  logits at JAX's 5e-4/1e-3; ``chip_smoke.py``'s snapshot writer against
  transformers;
* the safetensors reader, the zoo's errors, the download, and a ResNet
  checkpoint through the zoo, the runner and the CLI.
"""

import dataclasses
import hashlib
import json
import urllib.request
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.config import ConfigNode as JaxConfig
from aihab_clip_tpu.models import CLIPModel as JaxCLIPModel
from aihab_clip_tpu.models import build_text_head as jax_text_head
from aihab_clip_tpu.models import clip as jax_clip
from aihab_clip_tpu.models.convert import \
    torch_state_dict_to_params as jax_convert
from aihab_clip_tpu.runner import init_clip_and_text_head as jax_init

import aihab_clip_tpu_torch.models.zoo as zoo
import chip_smoke
from aihab_clip_tpu_torch.__main__ import main as cli_main
from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.models import CLIP_ARCHS, build_text_head
from aihab_clip_tpu_torch.models.clip import config_from_state_dict_shapes
from aihab_clip_tpu_torch.models.convert import (flax_params_to_state_dict,
                                                 flatten_params,
                                                 state_dict_to_flax_params,
                                                 torch_state_dict_to_port)
from aihab_clip_tpu_torch.models.convert_hf import (SIGLIP_TEXT_DEFAULTS,
                                                    SIGLIP_VISION_DEFAULTS)
from aihab_clip_tpu_torch.models.safetensors import (read_safetensors,
                                                     read_snapshot_weights)
from aihab_clip_tpu_torch.runner import init_clip_and_text_head
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.tokenizer import tokenize
from aihab_clip_tpu_torch.tokenizer.hf_json import load_hf_tokenizer

# a Tiny ViT with MLPs that are not 4x wide, which the shapes must carry
TINY_VIT = dataclasses.replace(CLIP_ARCHS["Tiny"], vision_mlp_dim=96,
                               text_mlp_dim=80)
PROMPTS = gen_prompts(use_hierarchy=True, use_descriptive=True)[0][:6]


def _noisy(sd, seed):
    """Every tensor moved by a numpy-seeded draw (the random init leaves
    biases at zero and LayerNorms at one)."""
    rng = np.random.default_rng(seed)
    return {k: v + torch.from_numpy(rng.normal(0, 0.02, tuple(v.shape))
                                    .astype(np.float32))
            for k, v in sd.items()}


def _port_sd(name, cfg=None, seed=3):
    model = zoo.load(name, device="cpu", random_cfg=cfg, seed=seed).model
    return _noisy(model.state_dict(), seed)


@pytest.fixture(scope="module")
def vit_sd():
    """An OpenAI-layout ViT state dict (fp32)."""
    return chip_smoke.openai_state_dict(_port_sd("random:Tiny", TINY_VIT))


def _assert_sd_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _images(seed, n=3, res=32):
    return np.random.default_rng(seed).normal(
        size=(n, res, res, 3)).astype(np.float32)


def _assert_clip_features(port, ref, res=32):
    """encode_image (pre, projected) and encode_text against JAX at
    5e-5/1e-4."""
    x = _images(11, res=res)
    tokens = tokenize(PROMPTS[:3], context_length=77, truncate=True)
    with torch.no_grad():
        pre, proj = port.model.encode_image(torch.from_numpy(x), project=True)
        tpre, tproj = port.model.encode_text(torch.as_tensor(tokens))
    jpre, jproj = ref.model.apply({"params": ref.params}, jnp.asarray(x),
                                  method=JaxCLIPModel.encode_image,
                                  project=True)
    jtpre, jtproj = ref.model.apply({"params": ref.params},
                                    jnp.asarray(np.asarray(tokens)),
                                    method=JaxCLIPModel.encode_text)
    for got, want in ((pre, jpre), (proj, jproj), (tpre, jtpre),
                      (tproj, jtproj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=1e-4)


def _jit_archive(sd, path):
    """A TorchScript archive whose state dict is ``sd`` plus OpenAI's int
    entries, as OpenAI's ``.pt`` files are."""
    root = torch.nn.Module()
    for key, v in sd.items():
        *mods, leaf = key.split(".")
        node = root
        for m in mods:
            if m not in node._modules:
                node.add_module(m, torch.nn.Module())
            node = node._modules[m]
        node.register_parameter(leaf, torch.nn.Parameter(v, False))
    for k, v in (("input_resolution", 32), ("context_length", 77),
                 ("vocab_size", 49408)):
        root.register_buffer(k, torch.tensor(v))
    torch.jit.save(torch.jit.script(root), str(path))


def _write(kind, sd, path):
    half = {k: v.half() for k, v in sd.items()}
    if kind == "state_dict":
        torch.save(sd, path)
    elif kind == "fp16":
        torch.save(half, path)
    elif kind == "jit":
        _jit_archive(half, path)
    else:   # open_clip training file: DDP prefix, attn_mask buffers, epoch
        mask = torch.full((77, 77), float("-inf")).triu(1)
        wrapped = {f"module.{k}": v for k, v in sd.items()}
        wrapped["module.attn_mask"] = mask
        wrapped["module.transformer.resblocks.0.attn_mask"] = mask
        torch.save({"state_dict": wrapped, "epoch": 3}, path)


@pytest.mark.parametrize("kind", ["state_dict", "fp16", "jit", "open_clip"])
def test_torch_checkpoint_matches_jax(vit_sd, tmp_path, kind):
    path = tmp_path / "ViT-tiny.pt"
    _write(kind, vit_sd, path)
    port = zoo.load(str(path), device="cpu", cache_dir=str(tmp_path / "p"))
    ref = jax_zoo.load(str(path), cache_dir=str(tmp_path / "j"))
    assert port.source == ref.source == "torch"
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert port.config == TINY_VIT
    _assert_sd_equal(port.model.state_dict(),
                     flax_params_to_state_dict(ref.params))
    _assert_clip_features(port, ref)


def test_caches_cross_both_ways(vit_sd, tmp_path):
    """The port's converted cache loads in JAX's ``load`` (``npz-cache``,
    the same params, the same features), JAX's in the port's, and the
    port's second load is its own cache."""
    path = tmp_path / "ViT-tiny-fp16.pt"
    _write("fp16", vit_sd, path)
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    port = zoo.load(str(path), device="cpu", cache_dir=pdir)
    ref = jax_zoo.load(str(path), cache_dir=jdir)
    again = zoo.load(str(path), device="cpu", cache_dir=pdir)
    assert again.source == "npz-cache"
    _assert_sd_equal(again.model.state_dict(), port.model.state_dict())
    jax_from_port = jax_zoo.load(str(path), cache_dir=pdir)
    assert jax_from_port.source == "npz-cache"
    got, want = flatten_params(jax_from_port.params), flatten_params(
        ref.params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    _assert_clip_features(port, jax_from_port)
    port_from_jax = zoo.load(str(path), device="cpu", cache_dir=jdir)
    assert port_from_jax.source == "npz-cache"
    _assert_sd_equal(port_from_jax.model.state_dict(),
                     port.model.state_dict())


def _shapes(cfg):
    """{OpenAI key: shape} of a CLIP_ARCHS row: a ViT's whole state dict, a
    ModifiedResNet's keys that carry its config."""
    tw, tm = cfg.transformer_width, cfg.text_mlp_dim or 4 * \
        cfg.transformer_width
    s = {"logit_scale": (), "positional_embedding": (cfg.context_length, tw),
         "text_projection": (tw, cfg.embed_dim),
         "token_embedding.weight": (cfg.vocab_size, tw),
         "ln_final.weight": (tw,), "ln_final.bias": (tw,)}
    towers = [("transformer", cfg.transformer_layers, tw, tm)]
    w = cfg.vision_width
    if cfg.is_vit:
        grid = cfg.image_resolution // cfg.vision_patch_size
        s.update({"visual.class_embedding": (w,),
                  "visual.positional_embedding": (grid * grid + 1, w),
                  "visual.proj": (w, cfg.embed_dim),
                  "visual.conv1.weight": (w, 3, cfg.vision_patch_size,
                                          cfg.vision_patch_size)})
        towers.append(("visual.transformer", cfg.vision_layers, w,
                       cfg.vision_mlp_dim or 4 * w))
    else:
        for stage, n in enumerate(cfg.vision_layers, 1):
            for b in range(n):
                s[f"visual.layer{stage}.{b}.conv1.weight"] = (w, w, 1, 1)
        grid = cfg.image_resolution // 32
        s["visual.attnpool.positional_embedding"] = (grid * grid + 1, w * 32)
    for prefix, n, width, mlp in towers:
        for i in range(n):
            p = f"{prefix}.resblocks.{i}.mlp.c_fc."
            s[p + "weight"], s[p + "bias"] = (mlp, width), (mlp,)
    return s


@pytest.mark.parametrize("arch", [a for a, c in jax_clip.CLIP_ARCHS.items()
                                  if c.tower != "convnext"])
def test_config_from_shapes_matches_jax(arch):
    """Every ViT and ResNet row of JAX's table, from shapes alone: the
    port's inferred config equals JAX's (heads, act and MLP widths of the
    LAION rows included), and a ViT row's equals the row itself."""
    jcfg = jax_clip.CLIP_ARCHS[arch]
    shapes = _shapes(jcfg)
    got = config_from_state_dict_shapes(shapes)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_clip.config_from_state_dict_shapes(shapes))
    if jcfg.is_vit:
        assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)


@pytest.fixture(scope="module")
def convnext_sd():
    """An open_clip ConvNeXt-CLIP state dict (head without its bias)."""
    sd = _port_sd("random:TinyConvNeXt")
    sd["visual.head_proj.bias"] = torch.zeros_like(sd["visual.head_proj.bias"])
    return chip_smoke.openclip_convnext_state_dict(sd)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_convnext_state_dict_matches_jax(convnext_sd, prefix):
    assert "visual.head.proj.bias" not in convnext_sd
    sd = {prefix + k: v for k, v in convnext_sd.items()}
    cfg, port = torch_state_dict_to_port(sd, resolution=32)
    jcfg, params = jax_convert({k: v.clone() for k, v in sd.items()},
                               resolution=32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_sd_equal(port, flax_params_to_state_dict(params))
    got = state_dict_to_flax_params(port)
    want = flatten_params(params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("where", ["file", "snapshot"])
def test_convnext_zoo_matches_jax(convnext_sd, tmp_path, monkeypatch, where):
    """A ConvNeXt file path (no tag: 256 px with JAX's warning) and an HF
    snapshot's open_clip_pytorch_model.bin (the tag's resolution): both
    packages' bundles, the second load from the port's cache in either."""
    if where == "file":
        name = str(tmp_path / "my-convnext-export.bin")
        torch.save(convnext_sd, name)
        source = "torch"
    else:
        repo = "laion/CLIP-convnext_base_w-tiny-test"
        snap = (tmp_path / "hub" / f"models--{repo.replace('/', '--')}"
                / "snapshots" / "abc")
        snap.mkdir(parents=True)
        torch.save(convnext_sd, snap / "open_clip_pytorch_model.bin")
        monkeypatch.setenv("HF_HOME", str(tmp_path))
        name, source = f"hf-hub:{repo}", "hf-local"
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port = zoo.load(name, device="cpu", cache_dir=pdir)
    assert any("resolution" in str(w.message) for w in caught) == (
        where == "file")
    ref = jax_zoo.load(name, cache_dir=jdir)
    assert port.source == ref.source == source
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    # a file without a tag defaults to 256; convnext_base_w's tag is 256
    assert port.config.image_resolution == 256
    _assert_sd_equal(port.model.state_dict(),
                     flax_params_to_state_dict(ref.params))
    _assert_clip_features(port, ref)
    assert zoo.load(name, device="cpu", cache_dir=pdir).source == "npz-cache"
    from_port = jax_zoo.load(name, cache_dir=pdir)
    assert from_port.source == "npz-cache"
    _assert_clip_features(port, from_port)


# ---- HF SigLIP snapshots ---------------------------------------------------

REPO = "google/siglip2-tiny-test"


@pytest.fixture
def transformers():
    return pytest.importorskip("transformers")


def _tiny_hf_siglip(transformers):
    """A tiny SiglipModel (tests/test_siglip.py:12-25, at patch 16 and
    context 64, transformers' defaults, so a stripped config.json lacks
    them)."""
    cfg = transformers.SiglipConfig(
        text_config=dict(hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=64, vocab_size=512),
        vision_config=dict(hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=16))
    torch.manual_seed(0)
    model = transformers.SiglipModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():     # biases and LayerNorms off 0 / 1
            p.add_(torch.randn(p.shape) * 0.02)
    return model


def _snap_dir(root, repo=REPO):
    snap = (root / "hub" / f"models--{repo.replace('/', '--')}"
            / "snapshots" / "deadbeef")
    snap.mkdir(parents=True)
    return snap


def _save_tokenizer(transformers, snap):
    """JAX's test tokenizer (tests/test_siglip.py:170-180)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = sorted({w.strip(",.") for p in PROMPTS for w in p.lower().split()})
    vocab = {"<pad>": 0, "<unk>": 1, "</s>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(words)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
        eos_token="</s>").save_pretrained(str(snap))


def _strip_config(transformers, snap):
    """config.json without the keys that equal transformers' defaults."""
    cfg = json.loads((snap / "config.json").read_text())
    for sub, cls in (("text_config", transformers.SiglipTextConfig),
                     ("vision_config", transformers.SiglipVisionConfig)):
        defaults = cls().to_dict()
        cfg[sub] = {k: v for k, v in cfg[sub].items() if defaults.get(k) != v}
    (snap / "config.json").write_text(json.dumps(cfg))
    return cfg


def _hf_snapshot(transformers, root, dtype=torch.float32, sharded=False,
                 tokenizer=True):
    snap = _snap_dir(root)
    model = _tiny_hf_siglip(transformers).to(dtype)
    model.save_pretrained(str(snap), safe_serialization=True,
                          max_shard_size="300KB" if sharded else "5GB")
    assert (snap / "model.safetensors.index.json").is_file() == sharded
    _strip_config(transformers, snap)
    if tokenizer:
        _save_tokenizer(transformers, snap)
    return snap


def _siglip_logits(model_apply_image, head, x):
    feats = np.asarray(model_apply_image(x))
    feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    return feats @ np.asarray(head["text_weights"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sharded", [False, True])
def test_hf_siglip_snapshot_matches_jax(transformers, tmp_path, monkeypatch,
                                        dtype, sharded):
    snap = _hf_snapshot(transformers, tmp_path, getattr(torch, dtype),
                        sharded)
    cfg = json.loads((snap / "config.json").read_text())
    # the patch size and the context are transformers' defaults
    assert "patch_size" not in cfg["vision_config"]
    assert "max_position_embeddings" not in cfg["text_config"]
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    port = zoo.load(f"hf-hub:{REPO}", device="cpu")
    ref = jax_zoo.load(f"hf-hub:{REPO}")
    assert port.source == ref.source == "hf-local"
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    _assert_sd_equal(port.model.state_dict(),
                     flax_params_to_state_dict(ref.params))
    ctx = port.config.context_length
    for c in (ctx, 4):
        np.testing.assert_array_equal(port.tokenize_fn(PROMPTS, c),
                                      ref.tokenize_fn(PROMPTS, c))
    n = len(PROMPTS)
    head = build_text_head(port.model, PROMPTS, n, 1, context_length=ctx,
                           tokenize_fn=port.tokenize_fn)
    jhead = jax_text_head(ref.model, ref.params, PROMPTS, n, 1,
                          context_length=ctx, tokenize_fn=ref.tokenize_fn)
    x = _images(5)
    with torch.no_grad():
        got = _siglip_logits(lambda a: port.model.encode_image(
            torch.from_numpy(a)).numpy(), head, x)
    want = _siglip_logits(lambda a: ref.model.apply(
        {"params": ref.params}, jnp.asarray(a),
        method=type(ref.model).encode_image), jhead, x)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    with torch.no_grad():
        feats = port.model.encode_image(torch.from_numpy(x)).numpy()
    jfeats = ref.model.apply({"params": ref.params}, jnp.asarray(x),
                             method=type(ref.model).encode_image)
    np.testing.assert_allclose(feats, np.asarray(jfeats), atol=5e-4,
                               rtol=1e-3)


def test_smoke_snapshot_writer_matches_transformers(transformers, tmp_path,
                                                   monkeypatch):
    """``chip_smoke.write_hf_siglip_snapshot`` (the smoke's SO400M layout
    at a tiny size, BF16 in 2 shards): transformers loads it strictly and
    holds the same tensors, AutoTokenizer (a Gemma fast tokenizer) gives the
    port reader's ids, and the port's load equals the source rounded to
    BF16."""
    sd = _port_sd("random:SigLIP-Tiny")
    cfg = zoo.load("random:SigLIP-Tiny", device="cpu").config
    snap = chip_smoke.write_hf_siglip_snapshot(
        tmp_path, REPO, cfg, sd, torch.bfloat16, 2, PROMPTS[:3])
    hf_cfg = json.loads((snap / "config.json").read_text())
    assert "max_position_embeddings" in hf_cfg["text_config"]  # 16 != 64
    assert all(SIGLIP_TEXT_DEFAULTS.get(k) != v
               for k, v in hf_cfg["text_config"].items())
    assert all(SIGLIP_VISION_DEFAULTS.get(k) != v
               for k, v in hf_cfg["vision_config"].items())
    hf = transformers.SiglipModel.from_pretrained(str(snap),
                                                  torch_dtype=torch.bfloat16)
    written = read_snapshot_weights(snap)
    assert written.keys() == hf.state_dict().keys()
    for k, v in hf.state_dict().items():
        assert torch.equal(written[k], v), k
    ref_tok = transformers.AutoTokenizer.from_pretrained(str(snap))
    assert type(ref_tok).__name__ == "GemmaTokenizerFast"
    texts = PROMPTS + ["naïve 🌿 bog"]
    for ctx in (64, 16):
        want = ref_tok(texts, padding="max_length", truncation=True,
                       max_length=ctx, return_tensors="np")["input_ids"]
        np.testing.assert_array_equal(load_hf_tokenizer(snap)(texts, ctx),
                                      want)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    port = zoo.load(f"hf-hub:{REPO}", device="cpu")
    assert port.config == cfg
    _assert_sd_equal(port.model.state_dict(),
                     {k: v.bfloat16().float() for k, v in sd.items()})


# ---- the safetensors reader -----------------------------------------------

def test_safetensors_reader(tmp_path):
    save_file = pytest.importorskip("safetensors.torch").save_file

    rng = np.random.default_rng(0)
    tensors = {f"t_{d}": torch.from_numpy(rng.normal(size=(3, 5)).astype(
        np.float32)).to(getattr(torch, d))
        for d in ("float32", "float16", "bfloat16")}
    tensors["scalar"] = torch.tensor([1.5])
    tensors["ids"] = torch.arange(6, dtype=torch.int64)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    got = read_safetensors(tmp_path / "model.safetensors")
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert torch.equal(read_snapshot_weights(tmp_path)["t_bfloat16"],
                       tensors["t_bfloat16"])


def _raw_safetensors(path, header, data=b"\0" * 64):
    raw = json.dumps(header).encode()
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + data)


@pytest.mark.parametrize("header,match", [
    ({"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}},
     "F8_E4M3"),
    ({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]},
      "b": {"dtype": "F32", "shape": [4], "data_offsets": [8, 24]}},
     "overlap"),
    ({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}},
     "offsets"),
    ({"a": {"dtype": "F32", "shape": [32], "data_offsets": [0, 128]}},
     "offsets"),
])
def test_safetensors_reader_refuses(tmp_path, header, match):
    path = tmp_path / "bad.safetensors"
    _raw_safetensors(path, header)
    with pytest.raises(ValueError, match=match) as ei:
        read_safetensors(path)
    assert "bad.safetensors" in str(ei.value)


def test_sharded_index_names_a_missing_tensor(tmp_path):
    chip_smoke.write_safetensors(tmp_path / "s1.safetensors",
                                 {"a": torch.ones(2)})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"a": "s1.safetensors", "b": "s1.safetensors"}}))
    with pytest.raises(ValueError, match="'b'"):
        read_snapshot_weights(tmp_path)


# ---- the zoo's errors ------------------------------------------------------

def test_missing_snapshot_messages_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    name = "hf-hub:timm/ViT-SO400M-16-SigLIP2-384"
    for load, err in ((lambda: zoo.load(name, device="cpu"),
                       zoo.SigLIPAssetsMissingError),
                      (lambda: jax_zoo.load(name),
                       jax_zoo.SigLIPAssetsMissingError)):
        with pytest.raises(err) as ei:
            load()
        assert "hf download" in str(ei.value)
        assert "allow_random_fallback" in str(ei.value)
        assert "google/siglip2-so400m-patch16-384" in str(ei.value)
    with pytest.warns(UserWarning, match="random init"):
        b = zoo.load(name, device="cpu", allow_random_fallback=True,
                     random_cfg=None)
    assert b.source == "random" and b.config.vision_width == 1152


def test_snapshot_tokenizer_errors_match_jax(transformers, tmp_path,
                                             monkeypatch):
    """Weights without a tokenizer: SigLIPAssetsMissingError naming the
    tokenizer in both packages; ``require_tokenizer=False`` loads with no
    ``tokenize_fn``; an unsupported tokenizer or a SentencePiece-only one
    raises naming its type or A12b."""
    snap = _hf_snapshot(transformers, tmp_path, tokenizer=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    name = f"hf-hub:{REPO}"
    for load, err in ((lambda **kw: zoo.load(name, device="cpu", **kw),
                       zoo.SigLIPAssetsMissingError),
                      (lambda **kw: jax_zoo.load(name, **kw),
                       jax_zoo.SigLIPAssetsMissingError)):
        with pytest.raises(err, match="tokenizer"):
            load()
        b = load(require_tokenizer=False)
        assert b.source == "hf-local" and b.tokenize_fn is None
    (snap / "spiece.model").write_bytes(b"\0")
    with pytest.raises(zoo.SigLIPAssetsMissingError, match="A12b"):
        zoo.load(name, device="cpu")
    _save_tokenizer(transformers, snap)
    tj = json.loads((snap / "tokenizer.json").read_text())
    tj["model"] = {"type": "Unigram", "vocab": [["<unk>", 0.0]]}
    (snap / "tokenizer.json").write_text(json.dumps(tj))
    with pytest.raises(zoo.SigLIPAssetsMissingError, match="Unigram"):
        zoo.load(name, device="cpu")


def test_convnext_missing_weights_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    name = "hf-hub:laion/CLIP-convnext_base_w-laion2B-s13B-b82K"
    for load in (lambda **kw: zoo.load(name, device="cpu",
                                       cache_dir=str(tmp_path), **kw),
                 lambda **kw: jax_zoo.load(name, cache_dir=str(tmp_path),
                                           **kw)):
        with pytest.raises(FileNotFoundError, match="hf download"):
            load()
    with pytest.warns(UserWarning, match="random init"):
        b = zoo.load(name, device="cpu", cache_dir=str(tmp_path),
                     allow_random_fallback=True)
    assert b.source == "random" and b.config.tower == "convnext"
    with pytest.raises(ValueError, match="Unrecognized ConvNeXt"):
        zoo.load("hf-hub:laion/CLIP-convnext_huge", device="cpu")


# ---- the download ----------------------------------------------------------

def test_download_checks_sha256(vit_sd, tmp_path, monkeypatch):
    """A zoo name fetched through urllib (patched: nothing leaves the
    machine): a matching sha256 loads (``download``), then the cache; a
    mismatch raises; ``download=False`` raises without fetching."""
    ckpt = tmp_path / "src.pt"
    _write("fp16", vit_sd, ckpt)
    data = ckpt.read_bytes()
    sha = hashlib.sha256(data).hexdigest()
    fetched = []

    def fake_urlretrieve(url, target):
        fetched.append(url)
        with open(target, "wb") as f:
            f.write(data)

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    base = "https://openaipublic.azureedge.net/clip/models"
    monkeypatch.setattr(zoo, "_ZOO_URLS",
                        {"ViT-B/16": f"{base}/{sha}/ViT-B-16.pt",
                         "ViT-B/32": f"{base}/{'0' * 64}/ViT-B-32.pt"})
    cache = str(tmp_path / "cache")
    with pytest.raises(FileNotFoundError, match="download=False"):
        zoo.load("ViT-B/16", device="cpu", cache_dir=cache, download=False)
    assert not fetched
    b = zoo.load("ViT-B-16", device="cpu", cache_dir=cache)
    assert b.source == "download" and len(fetched) == 1
    assert (tmp_path / "cache" / "checkpoints" / "ViT-B-16.pt").is_file()
    assert b.config == TINY_VIT
    assert zoo.load("ViT-B/16", device="cpu",
                    cache_dir=cache).source == "npz-cache"
    assert len(fetched) == 1
    with pytest.raises(RuntimeError, match="mismatched sha256"):
        zoo.load("ViT-B/32", device="cpu", cache_dir=cache)
    assert zoo.available_models() == ["ViT-B/16", "ViT-B/32"]


# ---- the runner ------------------------------------------------------------

def _rn_checkpoint(path):
    """A TinyRN CLIP checkpoint in OpenAI's layout: fp16 tensors, every
    BatchNorm with its int64 ``num_batches_tracked``."""
    sd = chip_smoke.openai_state_dict(_port_sd("random:TinyRN", seed=1))
    torch.save({k: v.half() if v.is_floating_point() else v
                for k, v in sd.items()}, path)


def _runner_cfg(backbone, tmp_path, cls=ConfigNode):
    return cls({"clip_backend": "openai", "backbone": backbone,
                "fallback_arch": "Tiny", "clip_cache_dir": str(tmp_path),
                "use_hierarchical_prompts": False,
                "use_descriptive_prompts": False,
                "data": {"preprocessing": {"resolution": 32}}})


def test_resnet_checkpoint_raises_naming_a11(tmp_path, monkeypatch, capsys):
    """A ModifiedResNet checkpoint in OpenAI's layout loads where JAX's
    does: ``zoo.load`` (the parameters of JAX's converter bit for bit, its
    features, then the converted cache), ``init_clip_and_text_head`` (the
    same text head as JAX's runner) and the CLI's inspection run, with no
    fallback to ``fallback_arch``."""
    from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset

    path = str(tmp_path / "RN-tiny.pt")
    _rn_checkpoint(path)
    port = zoo.load(path, device="cpu", cache_dir=str(tmp_path))
    ref = jax_zoo.load(path, cache_dir=str(tmp_path / "j"))
    assert port.source == ref.source == "torch"
    assert port.config == CLIP_ARCHS["TinyRN"]
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    _assert_sd_equal(port.model.state_dict(),
                     flax_params_to_state_dict(ref.params))
    _assert_clip_features(port, ref)
    again = zoo.load(path, device="cpu", cache_dir=str(tmp_path))
    assert again.source == "npz-cache" and again.config == port.config
    _assert_sd_equal(again.model.state_dict(), port.model.state_dict())

    head = init_clip_and_text_head(_runner_cfg(path, tmp_path), device="cpu")
    want = jax_init(_runner_cfg(path, tmp_path / "j", JaxConfig))
    assert head["source"] == "npz-cache" and want["source"] == "npz-cache"
    assert head["config"] == CLIP_ARCHS["TinyRN"]
    np.testing.assert_allclose(head["text_weights"].numpy(),
                               np.asarray(want["text_weights"]), atol=5e-5,
                               rtol=1e-4)

    synth = make_synthetic_cs_dataset(tmp_path / "data", n_train_per_class=5,
                                      n_test_per_class=1, image_size=40)
    monkeypatch.chdir(tmp_path)
    result = cli_main([
        "--device", "cpu", "--logger", "off", "--inspect_only", "--opts",
        "data.dataset_paths", repr(synth["dataset_paths"]),
        "data.index_file_names", repr(synth["index_file_names"]),
        "data.data_split.valid_split", "0.25",
        "data.preprocessing.resize", "40",
        "data.preprocessing.resolution", "32", "clip_backend", "openai",
        "backbone", path, "clip_cache_dir", str(tmp_path),
        "fallback_arch", "Tiny", "wandb_project", "None",
        "root_path", str(tmp_path)])
    assert result["bundle"]["config"] == CLIP_ARCHS["TinyRN"]
    assert "falling back" not in capsys.readouterr().out


def test_runner_falls_back_where_jax_does(vit_sd, tmp_path, capsys):
    """A name that loads nowhere, and a checkpoint the converter refuses,
    fall back to random ``fallback_arch`` weights in both runners; the
    zoo itself raises for the refused checkpoint."""
    bad = tmp_path / "bad.pt"
    torch.save({**vit_sd, "visual.extra.weight": torch.ones(2)}, bad)
    with pytest.raises(KeyError, match="visual.extra.weight"):
        zoo.load(str(bad), device="cpu", cache_dir=str(tmp_path))
    for backbone in ("no-such-model", str(bad)):
        port = init_clip_and_text_head(_runner_cfg(backbone, tmp_path),
                                       device="cpu")
        ref = jax_init(_runner_cfg(backbone, tmp_path, JaxConfig))
        assert port["source"] == ref["source"] == "random"
        assert port["config"] == CLIP_ARCHS["Tiny"]
    assert capsys.readouterr().out.count("falling back to random-init") == 4
