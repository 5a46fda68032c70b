"""Persistent serving: classifier engine + dynamic batcher (counterpart of
``aihab_clip_tpu/serving.py:91-563``).

* :class:`ClassifierEngine` — loads a model once, builds the CS
  prompt-ensemble text head, and classifies ``uint8 [B, D, D, 3]`` batches
  to softmax probabilities through eval preprocessing, the fastest encode
  for the device (the Hopper block kernels on the card) and the logits.
  CLIP ViT towers and SigLIP (``random:ViT-SO400M-16-SigLIP2-384``, the
  system's default backbone, with its 0.5/0.5 pixel stats and its text
  head) take the same path.
* :class:`DynamicBatcher` — request threads submit single decoded images; a
  collector thread coalesces them into padded batches of the smallest
  bucket that holds them, and a fetch thread waits on each batch's result,
  so batch *i+1* collects and launches while batch *i* runs on the card.

Image decoding and the HTTP front end come with a later slice.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .backend import resolve_device


class ClassifierEngine:
    """Load-once image classifier.

    Owns the model bundle, the CS text head, the kernels' weight pack and a
    ``classify(uint8[B, D, D, 3]) -> probs[B, C]`` function.  Funnel
    :meth:`classify_dispatch` through one thread (the
    :class:`DynamicBatcher` does) to keep launch order deterministic.
    Computes in bf16 on the card and fp32 on the CPU.
    """

    def __init__(
        self,
        model: str = "ViT-B/16",
        batch_size: int = 64,
        resolution: int = 0,
        flat: bool = False,
        lora: Optional[str] = None,
        lora_alpha: float = 16.0,
        quantize: str = "none",
        verbose: bool = True,
        buckets: int = 3,
        device="cuda",
    ):
        from .models import build_text_head, load
        from .taxonomy import CS_CLASSNAMES, REASSIGN_LABEL_NAME_L3
        from .templates import gen_prompts

        self.device = resolve_device(device)
        if lora:
            raise NotImplementedError("LoRA merging (train/lora.py) is not "
                                      "ported yet")
        if quantize != "none":
            raise NotImplementedError(
                f"quantize={quantize!r}: the int8 kernels (K8-K15, "
                "ops/quant_matmul.py) are not ported yet")
        del lora_alpha
        self.model_name = model
        self.batch_size = int(batch_size)
        # batch-shape buckets (batch_size, /2, /4, ...): a partly filled
        # collection window runs the smallest bucket that holds it
        self.bucket_sizes = sorted({max(1, self.batch_size >> i)
                                    for i in range(max(1, int(buckets)))})
        self.verbose = verbose
        self.quantize = quantize
        self.class_names = list(CS_CLASSNAMES)
        self.label_names = dict(REASSIGN_LABEL_NAME_L3)

        self._compute_dtype = (torch.bfloat16 if self.device.type == "cuda"
                               else torch.float32)
        self.bundle = load(model, dtype=self._compute_dtype,
                           device=self.device)
        cfg = self.bundle.config
        self.resolution = resolution or cfg.image_resolution
        if self.resolution != cfg.image_resolution:
            raise ValueError(
                f"resolution {self.resolution} does not match the model's "
                f"positional embedding (trained at {cfg.image_resolution}px)")
        # decode at >= 224 so the AA-bicubic eval resize has real work
        self.decode_dim = max(self.resolution, 224)

        prompts, tpc = gen_prompts(use_hierarchy=not flat,
                                   use_descriptive=not flat)
        head = build_text_head(self.bundle.model, prompts,
                               len(self.class_names), tpc,
                               context_length=cfg.context_length,
                               tokenize_fn=self.bundle.tokenize_fn)
        self._text_weights = head["text_weights"]
        self._packed = None
        if self.device.type == "cuda":
            from .models.fast_vit import pack_fastest

            self._packed = pack_fastest(self.bundle.model, cfg,
                                        self._compute_dtype)
        self._warm = False

    # -- runtime -----------------------------------------------------------

    @torch.inference_mode()
    def classify(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, D, D, 3] on the engine's device -> probs [B, C] fp32."""
        from .models.fast_vit import encode_image_fastest
        from .ops.preprocess import eval_transform, normalize_stats_for

        cfg = self.bundle.config
        mean, std = normalize_stats_for(cfg)
        x = eval_transform(images_u8, self.resolution,
                           dtype=self._compute_dtype, mean=mean, std=std)
        _, feats = encode_image_fastest(self.bundle.model, x, cfg,
                                        project=True, packed=self._packed)
        feats = feats.float()
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.softmax(100.0 * feats @ self._text_weights, dim=-1)

    def warmup(self) -> float:
        """Run every bucket shape once; returns seconds taken."""
        t0 = time.perf_counter()
        for b in reversed(self.bucket_sizes):
            dummy = np.zeros((b, self.decode_dim, self.decode_dim, 3), np.uint8)
            self.classify_dispatch(dummy).cpu()
        self._warm = True
        dt = time.perf_counter() - t0
        if self.verbose:
            print(f"[serving] warmup: {dt:.1f}s (buckets {self.bucket_sizes} "
                  f"@ {self.resolution}px, {self.model_name}, {self.device})")
        return dt

    @property
    def warm(self) -> bool:
        return self._warm

    def classify_dispatch(self, images_u8: np.ndarray) -> torch.Tensor:
        """Launch one padded batch; returns the probabilities as a device
        tensor without waiting for them (``.cpu()`` waits), so a batcher
        can collect batch i+1 while batch i runs.

        ``images_u8`` must be ``[b in bucket_sizes, decode_dim,
        decode_dim, 3]`` uint8."""
        if (images_u8.shape[0] not in self.bucket_sizes
                or images_u8.shape[1:] != (self.decode_dim,
                                           self.decode_dim, 3)):
            raise ValueError(
                f"expected (b in {self.bucket_sizes}, {self.decode_dim}, "
                f"{self.decode_dim}, 3), got {images_u8.shape}")
        images = torch.from_numpy(np.ascontiguousarray(images_u8,
                                                       dtype=np.uint8))
        return self.classify(images.to(self.device))

    def bucket_for(self, n: int) -> int:
        """Smallest batch shape holding ``n`` rows (the largest when n
        exceeds it — callers chunk at batch_size)."""
        for b in self.bucket_sizes:
            if n <= b:
                return b
        return self.bucket_sizes[-1]

    def classify_batch(self, images_u8: np.ndarray,
                       n_valid: Optional[int] = None) -> np.ndarray:
        """Pad to the smallest bucket shape, classify, return valid rows."""
        n = len(images_u8) if n_valid is None else n_valid
        bucket = self.bucket_for(len(images_u8))
        if len(images_u8) < bucket:
            pad = np.zeros((bucket - len(images_u8), self.decode_dim,
                            self.decode_dim, 3), np.uint8)
            images_u8 = np.concatenate([images_u8, pad])
        return self.classify_dispatch(images_u8).cpu().numpy()[:n]

    def topk(self, probs: np.ndarray, k: int = 3) -> List[List[dict]]:
        """[B, C] probs -> per-image top-k {label, name, prob} records."""
        order = np.argsort(-probs, axis=-1)[:, :k]
        return [[{"label": int(j), "name": self.label_names[int(j)],
                  "prob": float(probs[i, j])} for j in order[i]]
                for i in range(len(probs))]


# ---------------------------------------------------------------------------
# dynamic batcher


@dataclass
class ServerStats:
    """Monotonic counters + a bounded latency window (thread-safe)."""

    requests: int = 0
    images: int = 0
    batches: int = 0
    batch_fill: int = 0          # sum of valid rows over batches
    batch_rows: int = 0          # sum of dispatched rows (bucket sizes)
    decode_failures: int = 0
    started_at: float = field(default_factory=time.time)
    _lat: deque = field(default_factory=lambda: deque(maxlen=2048))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record_batch(self, n_valid: int, bucket_rows: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.batch_fill += n_valid
            self.batch_rows += bucket_rows

    def record_request(self, n_images: int) -> None:
        with self._lock:
            self.requests += 1
            self.images += n_images

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(seconds)

    def snapshot(self, batch_size: int) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            denom = self.batch_rows or self.batches * batch_size
            snap = {
                "requests": self.requests,
                "images": self.images,
                "batches": self.batches,
                "mean_batch_fill": round(self.batch_fill / denom, 4)
                if denom else 0.0,
                "decode_failures": self.decode_failures,
                "uptime_s": round(time.time() - self.started_at, 1),
            }
            if lat:
                snap["latency_ms"] = {
                    "p50": round(1e3 * lat[len(lat) // 2], 2),
                    "p99": round(1e3 * lat[int(len(lat) * 0.99)], 2),
                    "max": round(1e3 * lat[-1], 2),
                    "n": len(lat),
                }
        return snap


class DynamicBatcher:
    """Coalesce single-image submissions into padded device batches.

    A *collector* thread drains the submit queue into batches — launching
    as soon as ``batch_size`` images wait or ``max_wait_ms`` has passed
    since the first — and a *fetcher* thread waits on each launched batch's
    result and resolves the futures.
    """

    def __init__(self, engine: ClassifierEngine, max_wait_ms: float = 5.0,
                 stats: Optional[ServerStats] = None, max_queue: int = 4096):
        self.engine = engine
        self.max_wait = max_wait_ms / 1e3
        self.stats = stats or ServerStats()
        self._submit: queue.Queue = queue.Queue(maxsize=max_queue)
        # bounds in-flight device batches: the collector stalls rather
        # than queueing unbounded device work
        self._inflight: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        for name, fn in (("collect", self._collect_loop),
                         ("fetch", self._fetch_loop)):
            t = threading.Thread(target=fn, name=f"batcher-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)

    def submit(self, image_u8: np.ndarray) -> Future:
        """Queue one decoded [D, D, 3] uint8 image; resolves to [C] probs."""
        fut: Future = Future()
        self._submit.put((image_u8, fut))
        return fut

    def _collect_loop(self) -> None:
        bs = self.engine.batch_size
        while not self._stop.is_set():
            try:
                first = self._submit.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.monotonic() + self.max_wait
            while len(items) < bs:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._submit.get(timeout=remaining))
                except queue.Empty:
                    break
            bucket = self.engine.bucket_for(len(items))
            batch = np.zeros((bucket, self.engine.decode_dim,
                              self.engine.decode_dim, 3), np.uint8)
            for i, (img, _) in enumerate(items):
                batch[i] = img
            try:
                dev = self.engine.classify_dispatch(batch)
            except Exception as e:  # resolve rather than hang callers
                for _, fut in items:
                    fut.set_exception(e)
                continue
            self.stats.record_batch(len(items), bucket)
            self._inflight.put((items, dev))

    def _fetch_loop(self) -> None:
        while not (self._stop.is_set() and self._inflight.empty()):
            try:
                items, dev = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                probs = dev.cpu().numpy()
            except Exception as e:  # a device fault surfaces here
                for _, fut in items:
                    fut.set_exception(e)
                continue
            for i, (_, fut) in enumerate(items):
                fut.set_result(probs[i])
