#!/usr/bin/env python
"""Persistent prediction server CLI (counterpart of
``aihab_clip_tpu/tools/serve.py``): loads the model once, warms every batch
bucket, then serves forever:

    python -m aihab_clip_tpu_torch.tools.serve --model ViT-B/16 --port 8000 \\
        [--quantize int8] [--batch_size 64] [--max_wait_ms 5] [--flat] \\
        [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` serves from the CPU.  The first request on the card builds the
kernels into ``build/`` (keyed by their sources, so a restart reuses them).

API:
    POST /predict     raw image bytes, {"images_b64": [...]} JSON, or the
                      application/x-aihab-batch binary wire
    GET  /healthz     readiness + model info
    GET  /stats       request/image/batch counters, fill ratio, latency

Example request:
    curl -s -X POST --data-binary @photo.jpg \\
        -H 'Content-Type: image/jpeg' http://localhost:8000/predict
"""

from __future__ import annotations

import argparse


def build_server(argv=None):
    from ..serving import ClassifierEngine, PredictServer

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="ViT-B/16",
                   help="zoo name | checkpoint path | hf-hub:<repo> (a "
                        "local HF snapshot) | random:<ARCH>")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = ephemeral (printed at startup)")
    p.add_argument("--batch_size", type=int, default=64,
                   help="largest device batch (buckets at batch_size, /2, "
                        "/4 — see --buckets)")
    p.add_argument("--buckets", type=int, default=3,
                   help="number of batch-shape buckets (batch_size >> i)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="max time to hold a non-full batch for stragglers")
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--flat", action="store_true",
                   help="flat prompts (default: hierarchical descriptive)")
    p.add_argument("--lora", default=None, metavar="ADAPTERS_NPZ",
                   help="a lora_adapters.npz (of either package) merged "
                        "into the weights before serving")
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--quantize", default="none", choices=["none", "int8"])
    p.add_argument("--request_timeout", type=float, default=60.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    engine = ClassifierEngine(
        model=args.model, batch_size=args.batch_size, flat=args.flat,
        lora=args.lora, lora_alpha=args.lora_alpha, quantize=args.quantize,
        buckets=args.buckets, device=args.device)
    return PredictServer(
        engine, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms, topk=args.topk,
        request_timeout=args.request_timeout)


def main(argv=None):
    server = build_server(argv)
    try:
        server.serve()
    except KeyboardInterrupt:
        print("\n[serving] shutting down")
        server.stop()


if __name__ == "__main__":
    main()
