"""Checkpoints in the JAX package's layout (``utils/orbax.py``,
``utils/ocdbt.py``, ``utils/checkpointing.py``): the OCDBT reader against
``tensorstore.ocdbt.dump`` and a kvstore listing (orbax's databases, many
versions with version-tree nodes, a b-tree of height 3), the writer read by
tensorstore's ``ocdbt`` kvstore, a CRC-32C mismatch refused; orbax's layout
both ways (JAX's ``save_checkpoint`` read exactly, the port's read by JAX's
``load_checkpoint`` onto its abstract targets exactly; the committed
checkpoint JAX wrote); and a PEFT run resumed across the packages in both
directions against the resuming package's own uninterrupted run."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch

from aihab_clip_tpu.config import ConfigNode as JaxConfig
from aihab_clip_tpu.data import make_synthetic_cs_dataset
from aihab_clip_tpu.data.bulk_load import ImageArrayDataset as JaxDataset
from aihab_clip_tpu.data.pipeline import SplitView as JaxView
from aihab_clip_tpu.models import build_text_head as jax_text_head
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.runner import run as jax_run
from aihab_clip_tpu.train import peft as jax_peft
from aihab_clip_tpu.utils import load_checkpoint as jax_load_checkpoint
from aihab_clip_tpu.utils import save_checkpoint as jax_save_checkpoint

from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
from aihab_clip_tpu_torch.models import SigLIPConfig, SigLIPModel
from aihab_clip_tpu_torch.models.convert import (flatten_params,
                                                 flax_params_to_state_dict)
from aihab_clip_tpu_torch.runner import run
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.train import peft
from aihab_clip_tpu_torch.utils import load_checkpoint, save_checkpoint
from aihab_clip_tpu_torch.utils import ocdbt, orbax

GOLDEN = Path(__file__).resolve().parent / "golden" / "jax_written"


def _norm(obj):
    return json.loads(json.dumps(obj, default=lambda b: b.hex()))


def _leaves(tree, prefix=""):
    """{orbax name: array} of a payload tree (dicts, tuples, optax states)."""
    out = {}
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    for k, v in items:
        if v is None or (isinstance(v, (dict, tuple, list)) and not v) or (
                hasattr(v, "_asdict") and not v._asdict()):
            continue
        out.update(_leaves(v, f"{prefix}{k}."))
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8))


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


def _databases(tmp_path):
    """Databases tensorstore wrote: an orbax checkpoint's (and its process
    database), one of 22 versions (version-tree nodes, arity 4), one whose
    b-tree is 3 nodes deep."""
    params = {"a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
              "big": np.random.default_rng(0).standard_normal(
                  (40, 30)).astype(np.float32)}
    cfg = JaxConfig({"root_path": str(tmp_path), "clip_backend": "openai",
                     "backbone": "x", "finetune": {"save_model_dir": "ck"}})
    state = jax_save_checkpoint(cfg, params, None, 1) / "state"
    versions = tmp_path / "versions"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{versions}/",
                          "config": {"version_tree_arity_log2": 2}}).result()
    for i in range(21):
        kv.write(f"k{i}", b"v%d" % i).result()
    deep = tmp_path / "deep"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{deep}/",
                          "config": {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 100}}).result()
    txn = ts.Transaction()
    for i in range(300):
        kv.with_transaction(txn).write(
            f"arr.{i % 7}/key{i:04d}",
            b"x" * (i % 50) if i % 10 else b"y" * 2000).result()
    txn.commit_async().result()
    return [state, state / "ocdbt.process_0", versions, deep]


def test_ocdbt_reader_matches_tensorstore(tmp_path):
    for root in _databases(tmp_path):
        base = ts.KvStore.open(f"file://{root}/").result()
        db = ocdbt.Database(root)
        assert _norm(db.manifest) == _norm(ts.ocdbt.dump(base).result())
        kv = ts.KvStore.open({"driver": "ocdbt",
                              "base": f"file://{root}/"}).result()
        items = db.items()
        keys = [k.decode() for k in kv.list().result()]
        assert sorted(items) == sorted(keys), root
        for k in keys:
            assert items[k] == kv.read(k).result().value, (root, k)
        gens = [v["generation_number"] for v in db.versions()]
        assert gens == list(range(1, len(gens) + 1))
        root_loc = db.manifest["versions"][-1]["root"]["location"]
        node = db.node(root_loc)
        if node["height"]:
            ref = ts.ocdbt.dump(base, root_loc).result()
            mine = {"height": node["height"], "entries": [
                {k: e[k] for k in ("key", "location", "statistics",
                                   "subtree_common_prefix")}
                for e in node["entries"]]}
            assert _norm(mine) == _norm(ref)
    assert ocdbt.Database(tmp_path / "deep").manifest["versions"][-1][
        "root_height"] == 3
    assert len(ocdbt.Database(tmp_path / "versions").versions()) == 22
    assert ocdbt.Database(tmp_path / "versions").manifest[
        "version_tree_nodes"]


@pytest.mark.parametrize("leaf_entries", [4096, 7, 2])
def test_ocdbt_writer_read_by_tensorstore(tmp_path, leaf_entries):
    rng = np.random.default_rng(leaf_entries)
    items = {f"p.w{i}/.zarray": b"{}" * i for i in range(40)}
    items.update({f"p.w{i}/0": rng.bytes(i * 70) for i in range(40)})
    ocdbt.write_database(tmp_path, items, leaf_entries=leaf_entries)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    assert sorted(keys) == sorted(items)
    for k in keys:
        assert kv.read(k).result().value == items[k]
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()
                         ).result()
    assert dump["versions"][0]["root"]["statistics"]["num_keys"] == 80
    assert (dump["versions"][0]["root_height"] > 0) == (leaf_entries < 80)
    assert _norm(ocdbt.Database(tmp_path).manifest) == _norm(dump)
    assert ocdbt.Database(tmp_path).items() == items


def test_ocdbt_crc_and_magic_refused(tmp_path):
    ocdbt.write_database(tmp_path, {"a": b"1" * 2000, "b": b"2"})
    manifest = tmp_path / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[20] ^= 1
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Database(tmp_path)
    data[20] ^= 1
    data[0] ^= 1
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="magic"):
        ocdbt.Database(tmp_path)
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


# ---------------------------------------------------------------------------
# orbax's layout
# ---------------------------------------------------------------------------


def test_committed_jax_checkpoint_read_exactly():
    """``tests/make_jax_written_fixtures.py``'s checkpoint (JAX's
    ``save_checkpoint``: a ViT tower and its Adam state), every array bit
    for bit, and through ``load_checkpoint`` as the port's names."""
    want = np.load(GOLDEN / "orbax_ckpt.npz")
    tree = orbax.read_state(GOLDEN / "orbax_ckpt" / "state")
    got = _leaves(tree)
    assert sorted(got) == sorted(want.files)
    for name in want.files:
        assert _same(got[name], want[name]), name
    assert tree["opt_state"]["inner_state"][1] is None
    restored = load_checkpoint(GOLDEN / "orbax_ckpt")
    assert restored["meta"]["epoch"] == 3
    params = {k[len("params."):].replace(".", "/"): want[k]
              for k in want.files if k.startswith("params.")}
    ref = flax_params_to_state_dict(params)
    assert sorted(restored["params"]) == sorted(ref)
    for name, t in ref.items():
        assert torch.equal(restored["params"][name], t), name
    opt = restored["opt_state"]
    assert opt["param_groups"][0]["betas"] == (0.9, 0.999)
    steps = {float(s["step"]) for s in opt["state"].values()}
    assert steps == {float(want["opt_state.count"])} == {3.0}
    names = opt["param_groups"][0]["param_names"]
    mu = {k[len("opt_state.inner_state.0.mu."):].replace(".", "/"): want[k]
          for k in want.files if k.startswith("opt_state.inner_state.0.mu.")}
    ref_mu = flax_params_to_state_dict(mu)
    assert sorted(names) == sorted(ref_mu)
    for i, n in enumerate(names):
        assert torch.equal(opt["state"][i]["exp_avg"], ref_mu[n]), n


_TWO_PROCESS_WRITER = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from aihab_clip_tpu.parallel.distributed import (global_mesh,
                                                 initialize_distributed)
initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from jax.experimental import multihost_utils
from aihab_clip_tpu.config import ConfigNode
from aihab_clip_tpu.utils import save_checkpoint
mesh = global_mesh()
w = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) / 7
b = np.linspace(-1, 1, 5).astype(np.float32)
cut = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
whole = NamedSharding(mesh, PartitionSpec())
params = {"w": jax.make_array_from_callback(w.shape, cut, lambda i: w[i]),
          "b": jax.make_array_from_callback(b.shape, whole, lambda i: b[i])}
cfg = ConfigNode({"root_path": root, "clip_backend": "openai",
                  "backbone": "two", "finetune": {"save_model_dir": "ck"}})
path = save_checkpoint(cfg, params, None, epoch=1)
multihost_utils.sync_global_devices("saved")
if pid == 0:
    open(os.path.join(root, "path.txt"), "w").write(str(path))
"""


def test_two_process_jax_checkpoint(tmp_path):
    """A checkpoint JAX saved from two processes (an array cut over the 4
    devices of both, one replicated): one database a process under the
    top-level manifest, the cut array in 4 chunks; read exactly."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_PROCESS_WRITER,
                               str(i), str(port), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    for proc in procs:
        out, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, out[-3000:]
    path = Path((tmp_path / "path.txt").read_text())
    state = path / "state"
    assert {p.name for p in state.iterdir()} >= {
        "ocdbt.process_0", "ocdbt.process_1", "manifest.ocdbt"}
    tree = orbax.read_state(state)
    w = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) / 7
    assert _same(tree["params"]["w"], w)
    assert _same(tree["params"]["b"],
                 np.linspace(-1, 1, 5).astype(np.float32))
    chunks = [k for k in ocdbt.Database(state).items()
              if k.startswith("params.w/") and not k.endswith(".zarray")]
    assert len(chunks) == 4, chunks
    assert torch.equal(load_checkpoint(path)["params"]["w"],
                       torch.from_numpy(w))


def _siglip():
    b = jax_load("random:SigLIP-Tiny", seed=2)
    rng = np.random.default_rng(9)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        b.params)
    model = SigLIPModel(SigLIPConfig(**dataclasses.asdict(b.config)))
    model.load_state_dict(flax_params_to_state_dict(params))
    return b, params, model.eval()


def test_jax_reads_port_checkpoint_exactly(tmp_path):
    """The port's ``save_checkpoint`` (params and Adam after two steps over
    the unlocked leaves), read by JAX's ``load_checkpoint`` onto its own
    abstract targets (its params, ``opt.init`` of its trainable tree):
    every leaf bit for bit; and by the port back."""
    b, params, model = _siglip()
    cfg_m = model.config
    peft.build_lock_mask(model, cfg_m.vision_layers,
                         cfg_m.transformer_layers, unlocked_groups=2)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = torch.optim.Adam([p for _, p in named], lr=1e-3)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        for _, p in named:
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    from aihab_clip_tpu_torch.utils.checkpointing import with_param_names

    sd = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = ConfigNode({"root_path": str(tmp_path), "clip_backend": "openclip",
                      "open_clip_model": "siglip",
                      "finetune": {"save_model_dir": "ck"}})
    path = save_checkpoint(cfg, sd, with_param_names(
        opt.state_dict(), [n for n, _ in named]), epoch=2)
    assert (path / "state" / "manifest.ocdbt").is_file()
    assert (path / "state" / "_METADATA").is_file()
    jmask = jax_peft.build_lock_mask(params, b.config.vision_layers,
                                     b.config.transformer_layers,
                                     unlocked_groups=2)
    trainable, _ = jax_peft.partition_params(params, jmask)
    jopt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    target = jopt.init(trainable)
    got = jax_load_checkpoint(path, params, target)
    ref_params = flatten_params(params)
    mine = {n: t.numpy() for n, t in sd.items()}
    for key, leaf in flatten_params(got["params"]).items():
        assert key in ref_params
        port_name = next(iter(flax_params_to_state_dict(
            {key: np.asarray(leaf)})))
        assert np.array_equal(flax_params_to_state_dict(
            {key: np.asarray(leaf)})[port_name].numpy(), mine[port_name]), key
    state = got["opt_state"]
    assert jax.tree_util.tree_structure(state) == \
        jax.tree_util.tree_structure(target)
    assert int(state.count) == int(state.inner_state[0].count) == 2
    assert float(state.hyperparams["b1"]) == np.float32(0.9)
    by_name = dict(zip([n for n, _ in named],
                       [opt.state[p] for _, p in named]))
    for key, leaf in flatten_params(state.inner_state[0].mu).items():
        name, arr = next(iter(flax_params_to_state_dict(
            {key: np.asarray(leaf)}).items()))
        assert torch.equal(arr, by_name[name]["exp_avg"]), key
    # JAX's warm start: the params alone, the optimizer state on disk
    # restored without a target (host arrays) and dropped
    alone = jax_load_checkpoint(path, params)
    for key, leaf in flatten_params(alone["params"]).items():
        name, arr = next(iter(flax_params_to_state_dict(
            {key: np.asarray(leaf)}).items()))
        assert torch.equal(arr, sd[name]), key
    back = load_checkpoint(path)
    for n, t in sd.items():
        assert torch.equal(back["params"][n], t), n
    for i, n in enumerate(back["opt_state"]["param_groups"][0][
            "param_names"]):
        assert torch.equal(back["opt_state"]["state"][i]["exp_avg_sq"],
                           by_name[n]["exp_avg_sq"]), n


# ---------------------------------------------------------------------------
# resume across the packages
# ---------------------------------------------------------------------------


def _dataset(cls, n=24, size=32, seed=12):
    rng = np.random.default_rng(seed)
    return cls(images=rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
               labels=rng.integers(0, 20, n), l2_labels=np.zeros(n, np.int64),
               poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
               poly_word_labels=[""] * n,
               file_names=[f"{i}.jpg" for i in range(n)],
               plot_idx=list(range(n)), image_sources=["synthetic"] * n)


def _close(trained, ref, start):
    """tests/test_torch_peft.py's trail limits: each trained leaf within
    5e-3 (relative) for 98% of its values and 0.1 everywhere; frozen leaves
    unchanged."""
    for name, t in trained.items():
        if torch.equal(t, start[name]):
            assert np.array_equal(ref[name], start[name].numpy()), name
            continue
        diff = np.abs(t.numpy() - ref[name])
        assert np.mean(diff <= 5e-3 * (1 + np.abs(ref[name]))) >= 0.98, name
        assert diff.max() <= 0.1, (name, diff.max())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(direction, tmp_path):
    """Two epochs of SigLIP-Tiny PEFT (tune_text, center crop), checkpointed
    after the first by one package and finished by the other, against the
    resuming package's uninterrupted two epochs: the trail limits of
    ``tests/test_torch_peft.py``, the last epoch's train loss within
    1e-4."""
    b, params, model = _siglip()
    prompts, tpc = gen_prompts(use_hierarchy=False, use_descriptive=False)
    head = jax_text_head(b.model, params, prompts, 20, tpc)
    base = dict(resolution=32, num_classes=20, lr=2e-3, epochs=2,
                crop_mode="center", tune_text=True, num_templates=tpc)
    kw = dict(unlocked_groups=2, unlocked_text_layers=1, seed=0,
              verbose=False)
    jds, ds = _dataset(JaxDataset), _dataset(ImageArrayDataset)
    idx = np.arange(16)
    tokens = torch.from_numpy(np.asarray(head["prompt_tokens"]))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = {"root_path": str(tmp_path), "clip_backend": "openclip",
           "open_clip_model": "siglip", "finetune": {"save_model_dir": "ck"}}
    saved = {}

    class Log:
        rows: list

        def __init__(self):
            self.rows = []

        def log(self, row):
            self.rows.append(row)

    def jax_run(resume=None, checkpoint=False):
        log = Log()

        def ckpt(par, opt_state, epoch):
            if epoch == 1:
                saved["path"] = jax_save_checkpoint(JaxConfig(cfg), par,
                                                    opt_state, epoch)
        out = jax_peft.finetune(
            b.model, params, JaxView(jds, idx, 8, shuffle=True, seed=3),
            None, None, jax_peft.PEFTConfig(
                fused_prefix=0, checkpoint_interval=1 if checkpoint else 0,
                **base),
            prompt_tokens=head["prompt_tokens"], logger=log,
            checkpoint_fn=ckpt if checkpoint else None, resume_from=resume,
            **kw)
        flat = flax_params_to_state_dict(out["params"])
        return {n: t.numpy() for n, t in flat.items()}, log.rows

    def port_run(resume=None, checkpoint=False):
        log = Log()

        def ckpt(par, opt_state, epoch):
            if epoch == 1:
                saved["path"] = save_checkpoint(ConfigNode(cfg), par,
                                                opt_state, epoch)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        out = peft.finetune(
            model, SplitView(ds, idx, 8, shuffle=True, seed=3), None, None,
            peft.PEFTConfig(fused_prefix=1,
                            checkpoint_interval=1 if checkpoint else 0,
                            **base),
            prompt_tokens=tokens, logger=log, device="cpu",
            checkpoint_fn=ckpt if checkpoint else None, resume_from=resume,
            **kw)
        trained = {n: p.detach().clone() for n, p in out["params"].items()}
        return trained, log.rows

    if direction == "jax_to_port":
        jax_run(checkpoint=True)
        resumed, rows = port_run(resume=saved["path"])
        full, full_rows = port_run()
        ref = {n: t.numpy() for n, t in full.items()}
    else:
        port_run(checkpoint=True)
        resumed_np, rows = jax_run(resume=str(saved["path"]))
        full_np, full_rows = jax_run()
        resumed = {n: torch.from_numpy(np.array(v)) for n, v in
                   resumed_np.items()}
        ref = full_np
    assert (saved["path"] / "state" / "_METADATA").is_file()
    assert [r["epoch"] for r in rows][-1] == [r["epoch"] for r in
                                              full_rows][-1]
    np.testing.assert_allclose(rows[-1]["train_loss"],
                               full_rows[-1]["train_loss"], atol=1e-4)
    _close(resumed, ref, start)


def _runner_cfg(synth, root, ckpt):
    return {
        "root_path": str(root), "dataset": "synth", "seed": 1, "shots": 0,
        "subset_l3": [], "clip_backend": "openclip",
        "open_clip_model": "random:Tiny", "backbone": "random:Tiny",
        "wandb_project": None, "use_hierarchical_prompts": False,
        "use_descriptive_prompts": False, "use_model_preprocess": False,
        "remat": False, "train_epoch": 1, "lr_v": 0.001, "lambda_v": 0.1,
        "lambda_funct_1_N": False, "lambda_funct_1_N2": False,
        "search_lr": False, "feat_batch_size": 0, "save_checkpoints": False,
        "save_features": False, "aug_views": 1, "device_dataset": False,
        # one device: JAX restores a warm start onto its bundle's single
        # device, which its 8-device test mesh would refuse, whoever wrote
        # the checkpoint
        "parallel": {"enabled": False},
        "finetune": {
            "enabled": True, "tune_text": False, "unlocked_groups": 1,
            "unlocked_layers": 1, "val_interval": 0, "eval_l2": False,
            "eval_only": True, "checkpoint": str(ckpt), "resume": False,
            "checkpoint_interval": 0, "require_cached_features": True,
            "save_model": False, "save_model_dir": str(root / "ck"),
            "save_optimizer": True, "cache_embeddings": False},
        "data": {
            "dataset_paths": synth["dataset_paths"],
            "index_file_names": synth["index_file_names"],
            "batch_size": 8, "shuffle": True, "num_workers": 0,
            "decode_prescale": False,
            "data_split": {"valid_split": 0.25, "split_seed": 42},
            "use_l2_label": False,
            "preprocessing": {"resize": 40, "resolution": 32,
                              "augmentations": {"random_crop": False}}},
    }


def test_runners_evaluate_each_others_checkpoints(tmp_path, monkeypatch):
    """``eval_only`` from ``finetune.checkpoint`` in both runners: the
    port's runner on JAX's checkpoint of noisy random:Tiny weights, JAX's
    runner on the port's: the weights each evaluates are the other's, bit
    for bit (as the port's names and layouts)."""
    monkeypatch.chdir(tmp_path)
    synth = make_synthetic_cs_dataset(tmp_path / "data", n_train_per_class=4,
                                      n_test_per_class=2, image_size=40)
    b = jax_load("random:Tiny", seed=5)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        b.params)
    want = flax_params_to_state_dict(params)
    jax_ck = jax_save_checkpoint(JaxConfig(
        {"root_path": str(tmp_path / "j"), "clip_backend": "openclip",
         "open_clip_model": "random:Tiny",
         "finetune": {"save_model_dir": "ck"}}), params, None, 1)
    mine = run(ConfigNode(_runner_cfg(synth, tmp_path / "pr", jax_ck)),
               device="cpu", logger_mode="off")["peft"]
    assert sorted(mine["params"]) == sorted(want)
    for n, t in want.items():
        assert torch.equal(mine["params"][n].cpu(), t), n
    port_ck = save_checkpoint(ConfigNode(
        {"root_path": str(tmp_path / "p"), "clip_backend": "openclip",
         "open_clip_model": "random:Tiny",
         "finetune": {"save_model_dir": "ck"}}), want, None, 1)
    ref = jax_run(JaxConfig(_runner_cfg(synth, tmp_path / "jr", port_ck)),
                  logger_mode="off")["peft"]
    for key, leaf in flatten_params(ref["params"]).items():
        name, t = next(iter(flax_params_to_state_dict(
            {key: np.asarray(leaf)}).items()))
        assert torch.equal(t, want[name]), key
    # (each runner's text head comes from its own random init, built
    # before the restore: the losses are not comparable)
    assert np.isfinite(mine["test"]["loss"]) and np.isfinite(
        ref["test"]["loss"])
