#!/usr/bin/env python
"""Embedding-cache visualizer: PCA pre-reduction + t-SNE to 2D on the card,
and a self-contained HTML scatter (counterpart of
``aihab_clip_tpu/tools/feat_vis.py``).

Loads ``embeddings.npy`` + ``metadata.csv`` from an embedding-cache
directory, optionally PCA-reduces (``ops.tsne.pca``), projects to 2D
(``ops.tsne.tsne``), saves ``vis_{method}_coords.npy`` and
``vis_{method}.html``: an inline SVG with one mark per point coloured by
label, each mark's ``<title>`` its label (the hover), a legend and the
title; nothing is fetched.  The port has no UMAP (umap-learn is not on the
card's machine): ``--method umap`` warns and runs t-SNE, and the files are
named by what ran.  Runs on the card (``--device cuda``, the default; it
raises without one) or with ``--device cpu``.

Usage:
    python -m aihab_clip_tpu_torch.tools.feat_vis --cache_dir \\
        feat_cache_vis/... --method tsne [--pca_dim 50] [--out_dir .]
"""

from __future__ import annotations

import argparse
import html
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

# tab20's colours, then evenly spaced hues for more labels
PALETTE = ["#1f77b4", "#aec7e8", "#ff7f0e", "#ffbb78", "#2ca02c", "#98df8a",
           "#d62728", "#ff9896", "#9467bd", "#c5b0d5", "#8c564b", "#c49c94",
           "#e377c2", "#f7b6d2", "#7f7f7f", "#c7c7c7", "#bcbd22", "#dbdb8d",
           "#17becf", "#9edae5"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cache_dir", type=str, required=True,
                   help="embedding-cache dir (embeddings.npy + metadata.csv)")
    p.add_argument("--method", type=str, default="umap",
                   choices=["umap", "tsne"])
    p.add_argument("--pca_dim", type=int, default=0,
                   help="PCA pre-reduction dim (0 = off)")
    p.add_argument("--n_neighbors", type=int, default=15, help="UMAP knn")
    p.add_argument("--min_dist", type=float, default=0.1, help="UMAP min_dist")
    p.add_argument("--perplexity", type=float, default=30.0, help="t-SNE")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_dir", type=str, default=None,
                   help="output dir (default: cache_dir)")
    p.add_argument("--label_column", type=str,
                   default="ground_truth_word_label")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def project(embeddings: np.ndarray, method: str, pca_dim: int = 0,
            perplexity: float = 30.0, device=None) -> Tuple[np.ndarray, str,
                                                            Dict]:
    """(coords [N, 2], method_used, {"pca_s", "tsne": TSNEResult})."""
    from ..backend import resolve_device
    from ..ops.tsne import sync, pca, tsne

    dev = resolve_device(device)
    x = torch.from_numpy(np.asarray(embeddings, np.float32)).to(dev)
    info: Dict = {"pca_s": 0.0}
    if pca_dim and pca_dim < x.shape[1]:
        t0 = time.perf_counter()
        x = pca(x, pca_dim).projected
        sync(dev)
        info["pca_s"] = time.perf_counter() - t0
    if method == "umap":
        print("[warn] umap-learn not installed; falling back to t-SNE")
        method = "tsne"
    perplexity = min(perplexity, max(2.0, (len(x) - 1) / 3.0))
    info["tsne"] = result = tsne(x, perplexity=perplexity)
    return result.embedding.cpu().numpy(), method, info


def reduce_to_2d(embeddings: np.ndarray, method: str, pca_dim: int = 0,
                 n_neighbors: int = 15, min_dist: float = 0.1,
                 perplexity: float = 30.0, seed: int = 42, device=None):
    """Returns (coords [N, 2], method_used): method_used is "tsne" for
    "umap" too (no UMAP here), and output files must be named by what ran.
    ``n_neighbors``, ``min_dist`` and ``seed`` are UMAP's and the randomized
    PCA's in JAX; the port's PCA and t-SNE init are exact and draw
    nothing."""
    coords, method, _ = project(embeddings, method, pca_dim, perplexity,
                                device)
    return coords, method


def _colour(i: int, n: int) -> str:
    if n <= len(PALETTE):
        return PALETTE[i]
    return f"hsl({360.0 * i / n:.1f},65%,45%)"


def plot_scatter(coords: np.ndarray, labels, out_html: Path,
                 title: str) -> None:
    """One self-contained HTML file: an inline SVG scatter coloured by
    label, a ``<title>`` per mark (its label) and a legend."""
    coords = np.asarray(coords, np.float64)
    labels = [str(v) for v in np.asarray(labels).tolist()]
    uniq = sorted(set(labels))
    colour = {lab: _colour(i, len(uniq)) for i, lab in enumerate(uniq)}
    w, h, pad, legend_w = 900, 700, 30, 260
    lo, hi = coords.min(0), coords.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    px = pad + (coords[:, 0] - lo[0]) / span[0] * (w - 2 * pad)
    py = h - pad - (coords[:, 1] - lo[1]) / span[1] * (h - 2 * pad)
    marks = "\n".join(
        f'<circle cx="{x:.2f}" cy="{y:.2f}" r="2.5" fill="{colour[lab]}">'
        f"<title>{html.escape(lab)}</title></circle>"
        for x, y, lab in zip(px, py, labels))
    legend = "\n".join(
        f'<g class="legend"><rect x="{w + 10}" y="{pad + 16 * i}" width="10" '
        f'height="10" fill="{colour[lab]}"/><text x="{w + 26}" '
        f'y="{pad + 16 * i + 9}" font-size="11">{html.escape(lab)}</text></g>'
        for i, lab in enumerate(uniq))
    doc = (f"<!DOCTYPE html>\n<html><head><meta charset=\"utf-8\">"
           f"<title>{html.escape(title)}</title></head><body>\n"
           f"<h3>{html.escape(title)}</h3>\n"
           f'<svg xmlns="http://www.w3.org/2000/svg" width="{w + legend_w}" '
           f'height="{max(h, pad + 16 * len(uniq) + pad)}">\n'
           f'<rect x="0" y="0" width="{w}" height="{h}" fill="white" '
           f'stroke="#ccc"/>\n{marks}\n{legend}\n</svg>\n</body></html>\n')
    Path(out_html).write_text(doc, encoding="utf-8")
    print(f"[feat_vis] interactive plot -> {out_html}")


def main(argv=None) -> Dict:
    from ..backend import resolve_device
    from ..cache import load_embedding_cache

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cache = load_embedding_cache(args.cache_dir)
    emb = cache["embeddings"]
    meta = cache["metadata"]
    labels = (meta[args.label_column] if args.label_column in meta
              else cache["labels"])

    coords, method, info = project(emb, args.method, args.pca_dim,
                                   args.perplexity, device)

    out_dir = Path(args.out_dir or args.cache_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    coords_path = out_dir / f"vis_{method}_coords.npy"
    np.save(coords_path, coords)
    print(f"[feat_vis] coords -> {coords_path}")
    html_path = out_dir / f"vis_{method}.html"
    plot_scatter(coords, labels, html_path,
                 f"{method.upper()} of {Path(args.cache_dir).name} "
                 f"({emb.shape[0]} pts)")
    return dict(info, method=method, coords=coords_path, html=html_path)


if __name__ == "__main__":
    main()
