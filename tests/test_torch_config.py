"""The port's config stack against the JAX package's: its own YAML reader
equals ``yaml.safe_load`` (the configs, YAML 1.1 scalars, block and flow
nodes), and ``load_configs`` / ``merge_from_pairs`` build the same trees
with the same ``--opts`` coercions and refusals.  Exact equality throughout
(no tolerance: these are parsed values)."""

import math
from pathlib import Path

import pytest
import yaml

from aihab_clip_tpu import config as jax_config
from aihab_clip_tpu_torch import config as cfgmod
from aihab_clip_tpu_torch.config import (ConfigNode, apply_dotted_overrides,
                                         coerce_value_type, decode_value,
                                         get_by_dotted_path, load_config_file,
                                         load_configs, merge_from_pairs,
                                         safe_load, set_by_dotted_path)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))

SCALARS = [
    "1e-4", "0.00005", "1.0e-4", "1.0e4", ".5", "+1", "-2", "0x1F", "010",
    "0b101", "1_000", "yes", "No", "on", "OFF", "~", "null", "Null", "",
    "true", "False", ".inf", "-.Inf", ".nan", "1:30", "1:30.5", "abc",
    "./data/x", "2019-01-01", "2001-12-14t21:59:43.10-05:00", "0o17", "1.",
    "+.5", "-0", "08", "0.1_0", "'it''s'", '"a\\tb"', '"\\u00e9"', "key #c",
    "'#not a comment'", "a#b", "[1, 2, [a, b]]", "{a: 1, b: [x, 'y']}", "[]",
    "{}", "ViT-B/16", "random:ViT-B/16", "hf-hub:timm/ViT-SO400M-16-SigLIP2-384",
    "'gs://bucket/p'", "CS_Xplots_2019_23_NEW02OCT24.csv", "'auto'",
    "[5, 6, 7]", "['Grassland', 'Wetland']", "-1.5e+3", "1e+3"]

DOCS = [
    "a:\n- 1\n- 2\nb: x\n",
    "a:\n  - x: 1\n    y: 2\n  - z\nc: [1]\n",
    "- a\n- b: 1\n  c: 2\n",
    "x: 1 # c\n# c\ny:\n  z: 'q # r'\n",
    "top:\n  inner:\n    deep: 1\n  other: null\n",
    "---\nk: v\n...\n",
    "",
    "# only a comment\n",
    "'quoted key': 1\n\"k2\": [a, {b: c}]\n",
]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_equals_pyyaml_on_configs(path):
    text = path.read_text()
    assert _same(safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalar_resolution_equals_pyyaml(scalar):
    doc = f"k: {scalar}\n"
    assert _same(safe_load(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("doc", DOCS)
def test_documents_equal_pyyaml(doc):
    assert _same(safe_load(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("doc", ["a: &x 1\nb: *x\n", "a: |\n  text\n",
                                 "a: !!str 1\n", "a: [1, 2\n"])
def test_unsupported_yaml_raises(doc):
    with pytest.raises(ValueError):
        safe_load(doc)


PAIRS = [("configs/base.yaml", "configs/cs.yaml"),
         ("configs/base.yaml", "configs/synthetic_smoke.yaml"),
         ("configs/base.yaml", None)]


@pytest.mark.parametrize("base,ds", PAIRS)
def test_load_configs_equals_jax(base, ds):
    mine = load_configs(base, ds, anchors=(ROOT,))
    ref = jax_config.load_configs(base, ds, anchors=(ROOT,))
    assert _same(mine.to_dict(), ref.to_dict())
    assert isinstance(mine.finetune, ConfigNode)
    assert str(mine) == str(ref)


OPTS = [
    ["seed", "5", "lr_v", "0.01"],
    ["lr_v", "1"],
    ["data.decode_prescale", "False", "data.preprocessing.resize", "256"],
    ["clip_backend", "openclip", "open_clip_model", "random:ViT-B/16"],
    ["data.dataset_paths", "['/tmp/a_train']", "wandb_project", "None"],
    ["finetune.lora_rank", "8", "save_features", "True", "aug_views", "3"],
    ["device_dataset", "False", "search_lr", "true", "shots", "16"],
    ["subset_l3", "['Grassland', 'Wetland']", "backbone", "random:Tiny"],
    ["data.preprocessing.augmentations.rotation", "False", "train_epoch", "5"],
    ["data.preprocessing.resolution", "64", "fallback_arch", "ViT-B/32"],
]


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: " ".join(o)[:40])
def test_merge_from_pairs_equals_jax(opts):
    mine = load_configs("configs/base.yaml", "configs/cs.yaml", opts,
                        anchors=(ROOT,))
    ref = jax_config.load_configs("configs/base.yaml", "configs/cs.yaml",
                                  opts, anchors=(ROOT,))
    assert _same(mine.to_dict(), ref.to_dict())


REFUSALS = [
    (["nonexistent_key", "5"], KeyError),
    (["seed", "'a_string'"], ValueError),
    (["seed"], ValueError),
    (["data.batch_size", "[1]"], ValueError),
    (["finetune.enabled", "maybe"], ValueError),
    (["resize", "64"], KeyError),
]


@pytest.mark.parametrize("opts,exc", REFUSALS, ids=lambda o: str(o)[:30])
def test_opts_refusals_equal_jax(opts, exc):
    base = load_configs("configs/base.yaml", "configs/cs.yaml",
                        anchors=(ROOT,))
    ref = jax_config.load_configs("configs/base.yaml", "configs/cs.yaml",
                                  anchors=(ROOT,))
    with pytest.raises(exc):
        merge_from_pairs(base, opts)
    with pytest.raises(exc):
        jax_config.merge_from_pairs(ref, opts)


def test_helpers_equal_jax(tmp_path):
    for v in ("1", "0.5", "[1, 2]", "True", "plainstring", "(1, 2)", "None"):
        assert _same(decode_value(v), jax_config.decode_value(v))
    assert coerce_value_type((1, 2), [0], "k") == [1, 2]
    assert coerce_value_type([1, 2], (0,), "k") == (1, 2)
    assert coerce_value_type("yes", True, "k") is True
    assert coerce_value_type(False, "auto", "k") is False
    p = tmp_path / "base.yaml"
    p.write_text("seed: 1\nfinetune:\n  enabled: true\n  unlocked_groups: 11\n")
    cfg = load_config_file(p)
    set_by_dotted_path(cfg, "finetune.unlocked_groups", "3")
    set_by_dotted_path(cfg, "newblock.alpha.beta", "0.5")
    ref = jax_config.load_config_file(p)
    jax_config.set_by_dotted_path(ref, "finetune.unlocked_groups", "3")
    jax_config.set_by_dotted_path(ref, "newblock.alpha.beta", "0.5")
    assert _same(cfg.to_dict(), ref.to_dict())
    assert get_by_dotted_path(cfg, "newblock.alpha.beta") == 0.5
    assert get_by_dotted_path(cfg, "no.such.key", "d") == "d"
    out = apply_dotted_overrides(cfg, [("finetune.enabled", "False")])
    assert out.finetune.enabled is False and cfg.finetune.enabled is True
    clone = cfg.clone()
    clone.seed = 9
    assert cfg.seed == 1
    with pytest.raises(ValueError):
        load_config_file(tmp_path / "missing.txt")


def test_config_module_imports_no_yaml():
    assert "yaml" not in cfgmod.__dict__
