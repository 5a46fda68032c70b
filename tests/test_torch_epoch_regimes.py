"""The port's epoch regimes (``device_dataset``) against the host loop and
the JAX package: ``_epoch_batch_indices`` equals JAX's and the host batch
order; the staged split (True) and the chunked one (``'chunked'``, several
chunks a epoch) train step for step as the host loop does, bit for bit
(with augmentation, with LoRA, with the scanned encode), copying nothing to
the device per step; the runner's ``'auto'`` resolves as JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

from aihab_clip_tpu.data.bulk_load import ImageArrayDataset as JaxDataset
from aihab_clip_tpu.data.pipeline import SplitView as JaxView
from aihab_clip_tpu.train.peft import _epoch_batch_indices as jax_indices

from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
from aihab_clip_tpu_torch.models import build_text_head, load
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.train import peft


def _dataset(cls, n=21, size=32, seed=3):
    rng = np.random.default_rng(seed)
    return cls(images=rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
               labels=rng.integers(0, 20, n), l2_labels=np.zeros(n, np.int64),
               poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
               poly_word_labels=[""] * n,
               file_names=[f"{i}.jpg" for i in range(n)],
               plot_idx=list(range(n)), image_sources=["synthetic"] * n)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch", [4, 5, 19])
def test_epoch_batch_indices_match_jax(shuffle, batch):
    ds, jds = _dataset(ImageArrayDataset), _dataset(JaxDataset)
    sel = np.arange(2, 21)
    view = SplitView(ds, sel, batch, shuffle=shuffle, seed=7)
    jview = JaxView(jds, sel, batch, shuffle=shuffle, seed=7)
    for epoch in (0, 1, 4):
        idx, valid = peft._epoch_batch_indices(view, epoch)
        ref_idx, ref_valid = jax_indices(jview, epoch)
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(valid, ref_valid)
        assert idx.dtype == ref_idx.dtype
        for s, b in enumerate(view.batches(epoch)):
            np.testing.assert_array_equal(view.indices[idx[s][valid[s]]],
                                          b.indices[b.valid])


@pytest.fixture(scope="module")
def tiny():
    bundle = load("random:Tiny", device="cpu", seed=4)
    prompts, tpc = gen_prompts(use_hierarchy=False, use_descriptive=False)
    head = build_text_head(bundle.model, prompts, 20, tpc)
    start = {n: p.detach().clone() for n, p in bundle.model.named_parameters()}
    return bundle.model, head, tpc, start


def _run(tiny, regime, uploads=None, **over):
    model, head, tpc, start = tiny
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    ds = _dataset(ImageArrayDataset)
    cfg = peft.PEFTConfig(resolution=32, num_classes=20, lr=3e-3, epochs=2,
                          crop_mode="random", flip=True, rotation=True,
                          device_dataset=regime,
                          device_chunk_bytes=32 * 32 * 3 * 4 * 2)
    cfg = dataclasses.replace(cfg, **over)
    log = []

    class Log:
        def log(self, row):
            log.append(row)

    kw = ({"prompt_tokens": head["prompt_tokens"]} if cfg.tune_text
          else {"text_weights": head["text_weights"].clone()})
    out = peft.finetune(model, SplitView(ds, np.arange(19), 4, shuffle=True,
                                         seed=2),
                        None, SplitView(ds, np.arange(19, 21), 4), cfg,
                        unlocked_groups=2, seed=5, verbose=False,
                        device="cpu", logger=Log(), **kw)
    if uploads is not None:
        uploads.append(out["report"]["split_uploads"])
    losses = [r["train_loss"] for r in log if "train_loss" in r]
    return out, losses


@pytest.mark.parametrize("over", [{}, {"lora_rank": 2, "lora_mlp": True},
                                  {"scan_blocks": True, "tune_text": True,
                                   "num_templates": 1}],
                         ids=["partial", "lora", "scan_tune_text"])
def test_staged_and_chunked_equal_the_host_loop(tiny, over):
    """The same per-epoch losses, test loss and final parameters (or
    adapters) bit for bit in the three regimes; the uploads: 3 a step for
    the host loop, 2 for the staged split + 2 a epoch (its batch table),
    3 a chunk (3 chunks a epoch of 5 steps: chunks of 2 steps)."""
    counts = []
    host, host_l = _run(tiny, False, counts, **over)
    staged, staged_l = _run(tiny, True, counts, **over)
    chunked, chunked_l = _run(tiny, "chunked", counts, **over)
    assert counts == [3 * 5 * 2, 2 + 2 * 2, 3 * 3 * 2]
    assert host_l == staged_l == chunked_l and len(host_l) == 2
    assert host["test"]["loss"] == staged["test"]["loss"] == \
        chunked["test"]["loss"]
    for other in (staged, chunked):
        for name, t in host["params"].items():
            assert torch.equal(t, other["params"][name]), name
        if host["adapters"] is not None:
            for name, ab in host["adapters"].items():
                for leaf in ("a", "b"):
                    assert torch.equal(ab[leaf], other["adapters"][name][leaf])


def test_chunk_steps_follow_jax():
    """Chunks of ``device_chunk_bytes`` // (bytes a sample x batch) steps,
    at least 1, as JAX's; each chunk staged once per epoch."""
    ds = _dataset(ImageArrayDataset)
    view = SplitView(ds, np.arange(19), 4)
    per = 32 * 32 * 3 * 4
    for budget, steps in ((per * 3, 3), (per - 1, 1),
                          (1 << 30, (1 << 30) // per)):
        feed = peft._ChunkedFeed(view, torch.device("cpu"), budget)
        assert feed.chunk_steps == max(1, steps)
    feed = peft._ChunkedFeed(view, torch.device("cpu"), per * 2)
    batches = list(feed.epoch(0))
    assert len(batches) == 5 and feed.chunks_staged == 3
    ref = list(view.batches(0))
    for (imgs, labs, valid, n), b in zip(batches, ref):
        np.testing.assert_array_equal(imgs.numpy(), b.images)
        np.testing.assert_array_equal(labs.numpy(), b.labels)
        np.testing.assert_array_equal(valid.numpy(), b.valid)
        assert n == b.n_valid


def test_runner_auto_resolves_as_jax(monkeypatch):
    """'auto': the host loop off the card; on the card (JAX: the TPU) the
    staged split up to 4 GiB, chunks above; explicit settings pass."""
    from aihab_clip_tpu import runner as jax_runner
    from aihab_clip_tpu_torch import runner

    class View:
        def __init__(self, n):
            self.num_samples = n
            self.dataset = type("D", (), {"images": np.zeros((1, 439, 439,
                                                              3), np.uint8)})

    class Loaders:
        def __init__(self, n):
            self.train = View(n)

    small, big = Loaders(1000), Loaders(8000)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.setattr(jax_runner, "dispatch_backend", lambda: "tpu")
    for setting in ("auto", True, False, "chunked", "true", "false"):
        cfg = {"device_dataset": setting}
        for loaders in (small, big):
            assert runner._resolve_device_dataset(cfg, loaders, cuda) == \
                jax_runner._resolve_device_dataset(cfg, loaders)
    monkeypatch.setattr(jax_runner, "dispatch_backend", lambda: "cpu")
    assert runner._resolve_device_dataset({"device_dataset": "auto"}, big,
                                          cpu) is False
    assert jax_runner._resolve_device_dataset({"device_dataset": "auto"},
                                              big) is False
