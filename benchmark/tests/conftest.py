"""The benchmark's CPU tests: the repository root on the path, and the
tiny configurations the harness runs on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_config(family: str) -> dict:
    """A configuration of ``family`` at a size the CPU runs in seconds."""
    if family == "siglip":
        act, eps, heads, hidden, ctx = "gelu_pytorch_tanh", 1e-6, 2, 128, 16
    else:
        act, eps, heads, hidden, ctx = "quick_gelu", 1e-5, 1, 256, 77
    tower = {"hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": heads, "intermediate_size": hidden,
             "layer_norm_eps": eps, "hidden_act": act}
    return {"name": f"tiny-{family}", "family": family,
            "embed_dim": 64 if family == "siglip" else 32,
            "vision": dict(tower, image_size=32, patch_size=8),
            "text": dict(tower, max_position_embeddings=ctx,
                         vocab_size=49408)}


@pytest.fixture
def tiny_cell():
    """A cell of a workload in BENCHMARK.json, cut to a tiny configuration
    and traffic, with the given limits."""
    from benchmark import harness

    def make(workload: str, family: str, traffic: dict, limits: dict):
        cell = harness.cell_of(harness.load_spec(), workload)
        cell["cfg"] = tiny_config(family)
        cell["traffic"] = dict(cell["traffic"], **traffic)
        cell["limits"] = {k: {"limit": v} for k, v in limits.items()}
        return cell

    return make
