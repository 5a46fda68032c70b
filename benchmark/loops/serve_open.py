"""Single photos arriving on their own, an open loop: seeded uint8 photos
with structure (``benchmark/images.py``) submitted one at a time to
``DynamicBatcher.submit`` on a Poisson schedule at a fixed rate, whatever
the system's state.  A request is timed from the
moment it was due to the moment its probabilities are on the host; one that
fails, or has not come back a minute after the window, misses every limit.

Every seed sends the same set of gaps between requests (the quantiles of
the exponential distribution of the rate), in its own order, so the seed
changes the order of the work and not its amount.

Traffic keys: ``batch`` (the engine's largest bucket), ``buckets``,
``max_wait_ms``, ``rate_per_s``, ``pool_images`` (distinct seeded images),
``check_rows``, ``trace_seconds`` (a ``--trace 1`` run traces the
schedule's last seconds, the host too for its last ``label_seconds``),
``drain_s``.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import time
from functools import partial

import numpy as np
import torch

from benchmark import checks, harness, system
from benchmark.images import smooth_images
from benchmark.reference import towers


def schedule(seed: int, rate: float, seconds: float, pool: int):
    """Due times (seconds from the window's start) and pool images of the
    requests: the n = rate x seconds quantiles of the exponential gap
    between arrivals, shuffled by the seed."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(harness.seed_mix(seed, 4))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(rng.permutation(gaps)), rng.integers(0, pool, n)


class Loop:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.attempted = self.failed = 0

    def setup(self):
        from aihab_clip_tpu_torch.serving import DynamicBatcher

        run, cfg, t = self.run, self.run.cfg, self.t
        weights = towers.make_weights(cfg, run.seed, run.device)
        self.engine = system.classifier_engine(
            cfg, weights, batch_size=t["batch"], buckets=t["buckets"],
            quantize=("int8" if run.options.get("control") == "int8"
                      else "none"), device=run.device)
        del weights
        d = self.engine.decode_dim
        gen = torch.Generator(device=run.device).manual_seed(
            harness.seed_mix(run.seed, 2))
        self.pool = smooth_images(gen, (t["pool_images"], d, d, 3),
                                  run.device).cpu().numpy()
        if run.options.get("fault") == "answer":   # the harness's own test
            inner = self.engine.classify
            self.engine.classify = lambda x: inner(x).roll(1, dims=-1)
        self.engine.warmup()
        rate = float(run.options.get("rate", t["rate_per_s"]))
        self.due, self.which = schedule(run.seed, rate, run.seconds,
                                        len(self.pool))
        self.rate = rate
        self.batcher = DynamicBatcher(self.engine,
                                      max_wait_ms=t["max_wait_ms"])
        self.batcher.start()

    def window(self):
        run = self.run
        n = len(self.due)
        done = np.full(n, np.nan)
        sent = np.full(n, np.nan)
        futures = []

        def finished(k, _fut):
            done[k] = time.perf_counter()

        # the traced segments: the schedule's last trace_seconds, the host
        # traced too for its last label_seconds
        n_b = int(self.rate * self.t["label_seconds"])
        n_a = int(self.rate * self.t["trace_seconds"]) - n_b
        run.trace_counts(n_a, n_b)
        first = max(0, n - n_a - n_b)
        t0 = time.perf_counter()
        for k in range(n):
            target = t0 + self.due[k]
            if k == first:
                run.trace_begin()
            while True:
                wait = target - time.perf_counter()
                if wait <= 0:
                    break
                time.sleep(wait if wait > 1e-3 else 0)
            fut = self.batcher.submit(self.pool[self.which[k]])
            sent[k] = time.perf_counter()
            fut.add_done_callback(partial(finished, k))
            futures.append(fut)
            if k >= first:
                run.trace_item(k + 1 - first, k + 1 - first)
        close = t0 + self.due[-1]
        run.trace_end(n - first, n - first)
        cf.wait(futures, timeout=max(0.0, close + self.t["drain_s"]
                                     - time.perf_counter()))
        self.batcher.stop()
        self.futures = futures
        due = t0 + self.due
        ok = np.array([f.done() and f.exception() is None for f in futures])
        lat = np.where(ok & np.isfinite(done), done - due, np.inf)
        self.attempted, self.failed = n, int((~np.isfinite(lat)).sum())
        lag_upto = first if run.trace else n
        stats = self.batcher.stats
        run.counters.update(batch_fill=stats.batch_fill,
                            batch_rows=stats.batch_rows,
                            send_lag_s=list(sent[:lag_upto] - due[:lag_upto]))
        self.lat, self.n_batches = lat, stats.batches
        quarters = [t0 + self.due[-1] * q for q in (0.25, 0.5, 0.75, 1.0)]
        self.backlog = [int(((due <= c) & ~(done <= c)).sum())
                        for c in quarters]
        return {"request_latency_p95_ms": 1e3 * harness.quantile(lat, 0.95)}

    def release(self):
        # the text head the engine read every answer through, set up once
        self.prog_head = self.engine._text_weights.detach().float().cpu()
        del self.batcher, self.engine

    def verify(self):
        run = self.run
        good = [k for k, f in enumerate(self.futures)
                if f.done() and f.exception() is None]
        rng = np.random.default_rng(harness.seed_mix(run.seed, 3))
        picks = rng.choice(len(good), size=min(self.t["check_rows"],
                                               len(good)), replace=False)
        got = np.stack([self.futures[good[i]].result() for i in picks])
        images = torch.from_numpy(
            np.stack([self.pool[self.which[good[i]]] for i in picks]))
        feats, head = checks.reference_answers(run.cfg, run.seed, images,
                                               run.device)
        prog_head = self.prog_head
        if run.options.get("control") == "fp8":     # the reference in fp8
            f8, prog_head = checks.reference_answers(
                run.cfg, run.seed, images, run.device, lowered=True)
            got = checks.answers(f8, prog_head)
        return checks.compare_classify(got, feats, head, prog_head)

    def report(self):
        fin = self.lat[np.isfinite(self.lat)]
        return {"rate_per_s": self.rate, "requests": int(len(self.lat)),
                "p50_ms": 1e3 * harness.quantile(fin, 0.5) if len(fin)
                else math.nan,
                "p99_ms": 1e3 * harness.quantile(self.lat, 0.99),
                "backlog_at_quarters": self.backlog,
                "batches": self.n_batches}
