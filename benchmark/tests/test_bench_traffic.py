"""The seeded traffic: the same seed gives the same inputs, and the open
loop's schedule sends every seed the same gaps in another order."""

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import towers

BIG = 2 ** 31 + 2 ** 30 + 12345     # seeds past 32 signed bits


def schedule(seed, rate, seconds):
    from benchmark.harness import BENCH, load_file_module

    mod = load_file_module(BENCH / "loops" / "serve_open.py", "serve_t")
    return mod.schedule(seed, rate, seconds, 256)


def test_poisson_schedule_same_gaps_other_order():
    due_a, img_a = schedule(BIG, 400.0, 10.0)
    due_b, img_b = schedule(BIG + 1, 400.0, 10.0)
    assert len(due_a) == len(due_b) == 4000
    gaps_a, gaps_b = np.diff(due_a, prepend=0), np.diff(due_b, prepend=0)
    np.testing.assert_allclose(np.sort(gaps_a), np.sort(gaps_b))
    assert not np.allclose(due_a, due_b)
    assert not np.array_equal(img_a, img_b)
    # the gaps are the exponential quantiles of the rate: mean 1/rate, the
    # median ln 2 / rate; the last is due at the window's end
    assert abs(gaps_a.mean() * 400 - 1) < 0.01
    assert abs(np.median(gaps_a) * 400 - np.log(2)) < 0.01
    assert abs(due_a[-1] - 10.0) < 0.1
    assert np.all(np.diff(due_a) > 0)
    again, img_again = schedule(BIG, 400.0, 10.0)
    np.testing.assert_array_equal(due_a, again)
    np.testing.assert_array_equal(img_a, img_again)


def test_schedule_scales_with_the_rate():
    due, _ = schedule(BIG, 50.0, 4.0)
    assert len(due) == 200 and abs(due[-1] - 4.0) < 0.1


def test_weights_repeat_for_a_seed_and_differ_across():
    cfg = {"family": "siglip", "embed_dim": 64,
           "vision": {"image_size": 32, "patch_size": 8, "hidden_size": 64,
                      "num_hidden_layers": 1, "num_attention_heads": 2,
                      "intermediate_size": 128},
           "text": {"hidden_size": 64, "num_hidden_layers": 1,
                    "num_attention_heads": 2, "intermediate_size": 128,
                    "max_position_embeddings": 16, "vocab_size": 1000}}
    a = towers.make_weights(cfg, BIG, "cpu")
    b = towers.make_weights(cfg, BIG, "cpu")
    c = towers.make_weights(cfg, BIG + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.conv1.weight"], c["visual.conv1.weight"])
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    ln = a["visual.ln_post.weight"].float()
    assert abs(ln.mean() - 1) < 0.05 and 0.05 < ln.std() < 0.2


def test_images_repeat_for_a_seed_and_have_structure():
    from benchmark.images import smooth_images

    def draw(seed):
        g = torch.Generator().manual_seed(harness.seed_mix(seed, 2))
        return smooth_images(g, (3, 4, 192, 192, 3), "cpu")

    a, b, c = draw(BIG), draw(BIG), draw(BIG + 1)
    assert a.shape == (3, 4, 192, 192, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    x = a.view(12, 192, 192, 3).float()
    # images differ in colour, and neighbouring pixels agree far more
    # than pixels far apart: fields, not noise
    means = x.mean((1, 2))
    assert means.std(0).min() > 10
    near = (x[:, 1:] - x[:, :-1]).abs().mean()
    far = (x[:, 96:] - x[:, :-96]).abs().mean()
    assert near < 0.5 * far


def test_seed_mix_takes_large_seeds():
    s = {harness.seed_mix(BIG, k) for k in range(100)}
    assert len(s) == 100 and all(0 <= x < 2 ** 63 for x in s)
    assert harness.seed_mix(BIG, 1) != harness.seed_mix(BIG + 1, 1)


def test_quantile_counts_failures_as_missing():
    lat = [0.1] * 94 + [float("inf")] * 6
    assert harness.quantile(lat, 0.95) == float("inf")
    assert harness.quantile([0.1] * 96 + [float("inf")] * 4, 0.95) == 0.1
