"""Persistent serving: classifier engine + dynamic batcher + HTTP server
(counterpart of ``aihab_clip_tpu/serving.py``).

* :class:`ClassifierEngine` — loads a model once, builds the CS
  prompt-ensemble text head, and classifies ``uint8 [B, D, D, 3]`` batches
  to softmax probabilities through eval preprocessing, the fastest encode
  for the device (the Hopper block kernels on the card) and the logits.
  CLIP ViT towers and SigLIP (``random:ViT-SO400M-16-SigLIP2-384``, the
  system's default backbone, with its 0.5/0.5 pixel stats and its text
  head) take the same path, and so do ConvNeXt-CLIP towers
  (``random:convnext_base_w``: K7 per block, ``models/fast_convnext``) and
  the ModifiedResNet towers (``random:RN50``: the BatchNorm-folded convs on
  cuDNN, ``models/fast_resnet``; no int8 tower, as in JAX).
  ``quantize="int8"`` serves SigLIP towers through the int8 kernels
  (``models/quant_siglip``: K8 patchify, then K13, K9 and K10 per block),
  CLIP ViT towers through ``models/quant_vit`` (K8 patchify, then the
  merged int8 block K14 per block) and ConvNeXt towers through K15 per
  block (the convs in the compute dtype).
  The engine also decodes: JPEG bytes through the fast decode
  (``ops/jpeg.py``: the C++ Huffman decode on the request's thread, J1 and
  J2 on the card on a stream of their own) with the JAX native path's
  prescale (``prescale_min = 2 * decode_dim``), bit for bit with JAX's
  ``native_decode_resize_mem`` (which, unlike ``cv2.imread`` and this
  package, ignores a JPEG's EXIF orientation); PNG and BMP bytes through
  ``data/decode.py`` (within one level of JAX's ``cv2`` path).
* :class:`DynamicBatcher` — request threads submit single decoded images; a
  collector thread coalesces them into padded batches of the smallest
  bucket that holds them, and a fetch thread waits on each batch's result,
  so batch *i+1* collects and launches while batch *i* runs on the card.
* :class:`PredictServer` — stdlib ``ThreadingHTTPServer``: ``POST
  /predict`` (raw image bytes; JSON ``{"images_b64": [...]}``; or the
  length-prefixed ``application/x-aihab-batch`` wire of
  ``encode_binary_batch``), ``GET /healthz`` and ``GET /stats``; the same
  routes, answers and error codes as JAX's.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import queue
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .backend import resolve_device
from .models.siglip import SigLIPConfig


def _parse_binary_batch(body: bytes) -> List[bytes]:
    """``application/x-aihab-batch`` framing -> blob list.

    Layout: u32le N, then N u32le lengths, then the N blobs
    concatenated.  ``encode_binary_batch`` is the client-side inverse.
    """
    if len(body) < 4:
        raise ValueError("truncated header")
    (n,) = struct.unpack_from("<I", body, 0)
    if n == 0 or n > 1 << 20:
        raise ValueError(f"implausible image count {n}")
    header_end = 4 + 4 * n
    if len(body) < header_end:
        raise ValueError("truncated length table")
    lengths = struct.unpack_from(f"<{n}I", body, 4)
    total = sum(lengths)
    if len(body) != header_end + total:
        raise ValueError(
            f"body size {len(body)} != header {header_end} + blobs {total}")
    blobs, off = [], header_end
    for ln in lengths:
        blobs.append(body[off:off + ln])
        off += ln
    return blobs


def encode_binary_batch(blobs: Sequence[bytes]) -> bytes:
    """Client-side framing for ``POST /predict`` with
    ``Content-Type: application/x-aihab-batch``."""
    head = struct.pack("<I", len(blobs)) + struct.pack(
        f"<{len(blobs)}I", *[len(b) for b in blobs])
    return head + b"".join(blobs)


class ClassifierEngine:
    """Load-once image classifier.

    ``model`` is any name ``models.load`` resolves (a zoo name, a
    checkpoint path, ``hf-hub:<repo>`` for a local HF snapshot,
    ``random:<ARCH>``); a SigLIP snapshot's own tokenizer builds the text
    head.  Owns the model bundle, the CS text head, the kernels' weight pack and a
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
        if quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
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
        if quantize == "int8" and getattr(cfg, "tower", "vit") == "rn":
            # no int8 ResNet tower, as in JAX (serving.py:236-238)
            raise ValueError("quantize='int8' requires a ViT/SigLIP/ConvNeXt "
                             "backbone")
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
        # LoRA adapters merged into the weights after the text head (built
        # from the unmerged base, as JAX's engine builds it from
        # bundle.params, serving.py:152-156) and before the kernels' pack
        # or the int8 quantization, which then serve W_eff
        if lora:
            self._merge_lora(lora, lora_alpha)
        self._packed = self._qparams = self._encode_int8 = None
        # the int8 weights from the fp32 parameters, once, into the kernels'
        # layout; the SigLIP and ViT int8 encodes take no dtype, as the JAX
        # engine calls them (serving.py:201-203, 232-234): they compute in
        # bf16 even where the engine's compute dtype is fp32 (on the CPU).
        # The ConvNeXt one computes its convs in the engine's compute dtype,
        # as JAX's does (serving.py:204-223).  The closures hold no
        # reference to the engine, which would keep a dropped engine's
        # weights alive until a garbage collection.
        net = self.bundle.model
        if quantize == "int8" and isinstance(cfg, SigLIPConfig):
            from .models.quant_siglip import (quantize_siglip_params,
                                              siglip_encode_int8)

            qp = self._qparams = quantize_siglip_params(net, cfg)
            self._encode_int8 = lambda x: siglip_encode_int8(
                qp, net, x, cfg, project=True)[1]
        elif quantize == "int8" and cfg.tower == "convnext":
            from .models.fast_convnext import (convnext_encode_fused,
                                               pack_convnext,
                                               quantize_convnext_mlp)

            pk = self._packed = pack_convnext(net, cfg, self._compute_dtype,
                                              mlp=False)
            qp = self._qparams = quantize_convnext_mlp(net, cfg)
            self._encode_int8 = lambda x: convnext_encode_fused(
                pk, x, cfg, project=True, qmlp=qp)[1]
        elif quantize == "int8":
            from .models.quant_vit import quantize_vit_params, vit_encode_int8

            qp = self._qparams = quantize_vit_params(net, cfg)
            self._encode_int8 = lambda x: vit_encode_int8(
                qp, x, cfg, project=True)[1]
        elif self.device.type == "cuda":
            from .models.fast_vit import pack_fastest

            self._packed = pack_fastest(self.bundle.model, cfg,
                                        self._compute_dtype)
        # the fast decode's CUDA stream, apart from the classify batches'
        # (one for the engine: the caching allocator keeps memory per stream)
        self._decode_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)
        self._warm = False

    def _merge_lora(self, lora_path: str, alpha: float) -> None:
        """W_eff = W + (alpha / r) A @ B into the model's weights, from a
        ``lora_adapters.npz`` of either package (``serving.py:140-151``)."""
        from .models.convert import flax_adapters_to_port
        from .train.lora import lora_merge

        model = self.bundle.model
        adapters = flax_adapters_to_port(lora_path)
        with torch.no_grad():
            merged = lora_merge({n: model.get_parameter(n) for n in adapters},
                                adapters, alpha)
            for name, w in merged.items():
                model.get_parameter(name).copy_(w)
        if self.verbose:
            print(f"[serving] merged {len(adapters)} LoRA adapters "
                  f"(alpha={alpha}) from {lora_path}")

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
        if self._encode_int8 is not None:
            feats = self._encode_int8(x)
        else:
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

    # -- decoding ----------------------------------------------------------

    def _decode(self, blobs: Sequence[bytes], route: str):
        """Blobs -> RGB uint8 [decode_dim, decode_dim, 3] or None each:
        ``ops/jpeg.decode_blobs`` on ``route`` (with the JAX native rule's
        prescale, 2 x decode_dim, on the "serve" route, where a blob may
        take the native path), on the engine's device and decode
        stream."""
        from .ops.jpeg import decode_blobs

        prescale_min = 2 * self.decode_dim if route == "serve" else 0
        return decode_blobs(blobs, self.decode_dim, route, prescale_min,
                            self.device, stream=self._decode_stream)

    def _bytes_route(self) -> str:
        """JAX's ``decode_bytes`` order, native then cv2.imdecode;
        ``AIHAB_SERVE_DECODE=cv2`` keeps to cv2.imdecode, as JAX's does."""
        if os.environ.get("AIHAB_SERVE_DECODE") == "cv2":
            return "imdecode"
        return "serve"

    def decode_bytes(self, data: bytes) -> Optional[np.ndarray]:
        """Encoded image bytes -> RGB uint8 [decode_dim, decode_dim, 3], or
        None where JAX's ``decode_bytes`` answers None."""
        return self._decode([data], self._bytes_route())[0]

    def decode_blobs(self, blobs: List[bytes]) -> List[Optional[np.ndarray]]:
        """A request's image list, its JPEGs in one decode call: one
        [D, D, 3] uint8 array (or None) per blob."""
        return self._decode(blobs, self._bytes_route())

    def decode_files(self, paths: Sequence[str]) -> List[Optional[np.ndarray]]:
        """Files at full scale (JAX's ``cv2.imread`` route), JPEGs in one
        decode call; None for a file that is missing or no image."""
        blobs = []
        for p in paths:
            try:
                blobs.append(Path(p).read_bytes())
            except OSError:
                blobs.append(b"")
        return self._decode(blobs, "imread")

    def decode_file(self, path: str) -> Optional[np.ndarray]:
        return self.decode_files([path])[0]

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


# ---------------------------------------------------------------------------
# HTTP server


class _Handler(BaseHTTPRequestHandler):
    """Routes: POST /predict, GET /healthz, GET /stats."""

    server: "PredictServer"
    protocol_version = "HTTP/1.1"

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet unless verbose
        if self.server.verbose:
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        srv = self.server
        if self.path == "/healthz":
            self._json(200, {
                "status": "ok" if srv.engine.warm else "warming",
                "model": srv.engine.model_name,
                "quantize": srv.engine.quantize,
                "batch_size": srv.engine.batch_size,
                "resolution": srv.engine.resolution,
            })
        elif self.path == "/stats":
            self._json(200, srv.stats.snapshot(srv.engine.batch_size))
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/predict":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        srv = self.server
        t0 = time.perf_counter()
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype == "application/json":
                try:
                    payload = json.loads(body)
                    blobs = [base64.b64decode(b, validate=True)
                             for b in payload["images_b64"]]
                except (json.JSONDecodeError, KeyError, TypeError,
                        binascii.Error) as e:
                    self._json(400, {"error": f"bad JSON request: {e}"})
                    return
            elif ctype == "application/x-aihab-batch":
                try:
                    blobs = _parse_binary_batch(body)
                except ValueError as e:
                    self._json(400, {"error": f"bad binary batch: {e}"})
                    return
            else:
                blobs = [body]
            if not blobs:
                self._json(400, {"error": "no images in request"})
                return
            if len(blobs) > srv.max_request_images:
                self._json(413, {"error":
                                 f"too many images ({len(blobs)} > "
                                 f"{srv.max_request_images})"})
                return

            images = srv.engine.decode_blobs(blobs)
            decoded, bad = [], []
            for i, img in enumerate(images):
                if img is None:
                    bad.append(i)
                else:
                    decoded.append((i, img))
            if bad:
                with srv.stats._lock:
                    srv.stats.decode_failures += len(bad)
            futures = [(i, srv.batcher.submit(img)) for i, img in decoded]
            results: List[Optional[dict]] = [None] * len(blobs)
            for i, fut in futures:
                probs = fut.result(timeout=srv.request_timeout)
                results[i] = {"topk": srv.engine.topk(probs[None],
                                                      srv.topk)[0]}
            for i in bad:
                results[i] = {"error": "undecodable image"}
            srv.stats.record_request(len(decoded))
            srv.stats.record_latency(time.perf_counter() - t0)
            self._json(200, {"predictions": results})
        except Exception as e:  # a request's failure answers 500, the
            # server keeps serving
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


class PredictServer(ThreadingHTTPServer):
    """Long-lived prediction service over a :class:`ClassifierEngine`.

    Use :meth:`serve` for a blocking CLI run or ``serve_background()``
    in tests; the bound port is ``server_port`` (``port=0`` for an
    ephemeral one).  Request threads decode (the C++ Huffman decode
    releases the GIL); the batcher's threads run the classify batches.
    """

    daemon_threads = True

    def __init__(self, engine: ClassifierEngine, host: str = "127.0.0.1",
                 port: int = 8000, max_wait_ms: float = 5.0, topk: int = 3,
                 request_timeout: float = 60.0, max_request_images: int = 256,
                 verbose: bool = True, warmup: bool = True):
        self.engine = engine
        self.stats = ServerStats()
        self.batcher = DynamicBatcher(engine, max_wait_ms=max_wait_ms,
                                      stats=self.stats)
        self.topk = topk
        self.request_timeout = request_timeout
        self.max_request_images = max_request_images
        self.verbose = verbose
        self._warmup = warmup
        super().__init__((host, port), _Handler)

    def serve(self) -> None:
        """Blocking: warmup, start the batcher, serve until interrupted."""
        if self._warmup and not self.engine.warm:
            self.engine.warmup()
        self.batcher.start()
        if self.verbose:
            print(f"[serving] listening on "
                  f"http://{self.server_address[0]}:{self.server_port} "
                  f"(model {self.engine.model_name}, "
                  f"batch {self.engine.batch_size}, "
                  f"quantize {self.engine.quantize}, {self.engine.device})")
        try:
            self.serve_forever()
        finally:
            self.batcher.stop()

    def serve_background(self) -> threading.Thread:
        """Start serving on a daemon thread (tests); returns the thread."""
        if self._warmup and not self.engine.warm:
            self.engine.warmup()
        self.batcher.start()
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="predict-server")
        t.start()
        return t

    def stop(self) -> None:
        self.shutdown()
        self.batcher.stop()
        self.server_close()
