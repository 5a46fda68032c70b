"""Offline bulk classification, a closed loop: host uint8 batches (seeded
photos with structure, ``benchmark/images.py``) through
``ClassifierEngine.classify_dispatch``, the probabilities fetched to the
host, one batch dispatched ahead of the one being fetched (as the
``DynamicBatcher``'s two in-flight slots allow).

Traffic keys: ``batch`` (images a batch), ``ahead`` (batches in flight
beside the one fetched), ``pool_batches`` (distinct seeded batches the
loop cycles through), ``warmup_batches``, ``check_rows`` (answers compared
with the reference, drawn from the seed), ``trace_items`` and
``label_items`` (batches in the two traced segments of a ``--trace 1``
run, ``harness.Run``).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from benchmark import checks, harness, system
from benchmark.images import smooth_images
from benchmark.reference import towers


class Loop:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.attempted = self.failed = 0
        self.results = []            # (batch number, pool index, probs)

    def setup(self):
        run, cfg = self.run, self.run.cfg
        weights = towers.make_weights(cfg, run.seed, run.device)
        self.engine = system.classifier_engine(
            cfg, weights, batch_size=self.t["batch"], buckets=1,
            quantize=("int8" if run.options.get("control") == "int8"
                      else "none"), device=run.device)
        del weights
        d = self.engine.decode_dim
        gen = torch.Generator(device=run.device).manual_seed(
            harness.seed_mix(run.seed, 2))
        self.pool = smooth_images(
            gen, (self.t["pool_batches"], self.t["batch"], d, d, 3),
            run.device).cpu().numpy()
        if run.options.get("fault") == "answer":   # the harness's own test
            inner = self.engine.classify
            self.engine.classify = lambda x: inner(x).roll(1, dims=-1)
        for i in range(self.t["warmup_batches"]):
            self.engine.classify_dispatch(
                self.pool[i % len(self.pool)]).cpu()

    def _fetch(self, pending):
        k, pool_idx, dev = pending.popleft()
        with self.run.span("fetch"):
            probs = dev.cpu().numpy()
        self.results.append((k, pool_idx, probs))

    def window(self):
        run, eng = self.run, self.engine
        b, ahead, n_pool = self.t["batch"], self.t["ahead"], len(self.pool)
        pending = deque()

        def drain():
            while pending:
                self._fetch(pending)

        run.trace_begin()
        t_start = time.perf_counter()
        deadline = t_start + run.seconds
        k = 0
        while time.perf_counter() < deadline:
            with run.span("dispatch"):
                dev = eng.classify_dispatch(self.pool[k % n_pool])
            pending.append((k, k % n_pool, dev))
            k += 1
            self.attempted += b
            if len(pending) > ahead:
                self._fetch(pending)
            run.trace_item(k, k * b, drain)
        drain()
        run.trace_end(k, k * b, drain)
        elapsed = time.perf_counter() - t_start
        self.window_s = elapsed
        return {"classify_images_per_s": len(self.results) * b / elapsed}

    def release(self):
        # the text head the engine read every answer through, set up once
        self.prog_head = self.engine._text_weights.detach().float().cpu()
        del self.engine

    def verify(self):
        run, b = self.run, self.t["batch"]
        total = len(self.results) * b
        self.failed = self.attempted - total
        rng = np.random.default_rng(harness.seed_mix(run.seed, 3))
        picks = rng.choice(total, size=min(self.t["check_rows"], total),
                           replace=False)
        got, images = [], []
        for flat in picks:
            k, pool_idx, probs = self.results[flat // b]
            got.append(probs[flat % b])
            images.append(self.pool[pool_idx, flat % b])
        images, got = torch.from_numpy(np.stack(images)), np.stack(got)
        feats, head = checks.reference_answers(run.cfg, run.seed, images,
                                               run.device)
        prog_head = self.prog_head
        if run.options.get("control") == "fp8":     # the reference in fp8
            f8, prog_head = checks.reference_answers(
                run.cfg, run.seed, images, run.device, lowered=True)
            got = checks.answers(f8, prog_head)
        return checks.compare_classify(got, feats, head, prog_head)

    def report(self):
        return {"batches": len(self.results), "window_s": self.window_s}
