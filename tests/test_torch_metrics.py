"""The port's device metrics against ``aihab_clip_tpu/ops/metrics.py`` on
seeded logits with padded rows: the confusion matrix, top-1/top-3, weighted
F1, MCC, the accumulated metric state and the L2 roll-up."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.ops import metrics as jax_m
from aihab_clip_tpu.taxonomy import NUM_L2 as JAX_NUM_L2
from aihab_clip_tpu.taxonomy import l3_to_l2_array as jax_l3_to_l2

from aihab_clip_tpu_torch.ops import metrics as m
from aihab_clip_tpu_torch.taxonomy import NUM_L2, l3_to_l2_array

C = 20


def _batches(seed, n_batches=3, b=16):
    """(logits, targets, valid) per batch; the last batch has padding."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        logits = rng.standard_normal((b, C)).astype(np.float32) * 3
        targets = rng.integers(0, C, b).astype(np.int32)
        valid = np.ones(b, bool)
        if i == n_batches - 1:
            valid[-5:] = False
            targets[-5:] = 0
        out.append((logits, targets, valid))
    return out


def test_confusion_matrix_and_topk_match_jax():
    logits, targets, _ = _batches(0, 1, 64)[0]
    preds = logits.argmax(-1)
    np.testing.assert_array_equal(
        m.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets),
                           C).numpy(),
        np.asarray(jax_m.confusion_matrix(jnp.asarray(preds),
                                          jnp.asarray(targets), C)))
    for k in (1, 3, 25):
        assert int(m.topk_correct(torch.from_numpy(logits),
                                  torch.from_numpy(targets), k)) == \
            int(jax_m.topk_correct(jnp.asarray(logits), jnp.asarray(targets),
                                   k))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_accumulated_metrics_match_jax(seed):
    state = m.init_metric_state(C)
    jstate = jax_m.init_metric_state(C)
    for logits, targets, valid in _batches(seed):
        loss = float(np.abs(logits).mean())
        state = m.update_metric_state(
            state, torch.from_numpy(logits), torch.from_numpy(targets),
            loss=torch.tensor(loss), valid_mask=torch.from_numpy(valid))
        jstate = jax_m.update_metric_state(
            jstate, jnp.asarray(logits), jnp.asarray(targets),
            loss=jnp.float32(loss), valid_mask=jnp.asarray(valid))
    got, ref = m.compute_metrics(state), jax_m.compute_metrics(jstate)
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(ref["cm"]))
    assert int(got["cm"].sum()) == 16 * 3 - 5
    for key in ("loss", "top1", "top3", "f1", "mcc"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   atol=1e-6, err_msg=key)


def test_scores_from_the_confusion_matrix_match_jax():
    rng = np.random.default_rng(4)
    for cm in (rng.integers(0, 9, (C, C)), np.diag(rng.integers(1, 5, C)),
               np.zeros((C, C), np.int64)):
        t, j = torch.from_numpy(cm), jnp.asarray(cm, jnp.int32)
        for fn, jfn in ((m.weighted_f1_from_cm, jax_m.weighted_f1_from_cm),
                        (m.mcc_from_cm, jax_m.mcc_from_cm),
                        (m.accuracy_from_cm, jax_m.accuracy_from_cm)):
            np.testing.assert_allclose(float(fn(t)), float(jfn(j)), atol=1e-6)


@pytest.mark.parametrize("mode,reduce", [("argmax", "mean"), ("logits", "mean"),
                                         ("logits", "sum"),
                                         ("logits", "logsumexp")])
def test_l2_rollup_matches_jax(mode, reduce):
    assert NUM_L2 == JAX_NUM_L2
    np.testing.assert_array_equal(l3_to_l2_array(), jax_l3_to_l2())
    acc = m.L2MetricsAccumulator(l3_to_l2_array(), NUM_L2, reduce=reduce,
                                 mode=mode, return_confusion_matrix=True)
    ref = jax_m.L2MetricsAccumulator(jax_l3_to_l2(), JAX_NUM_L2,
                                     reduce=reduce, mode=mode,
                                     return_confusion_matrix=True)
    for logits, targets, valid in _batches(5):
        acc.update(torch.from_numpy(logits), torch.from_numpy(targets),
                   valid_mask=torch.from_numpy(valid))
        ref.update(jnp.asarray(logits), jnp.asarray(targets),
                   valid_mask=jnp.asarray(valid))
    got, want = acc.compute(), ref.compute()
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["cm"], want["cm"])
    for key in got:
        if key != "cm":
            np.testing.assert_allclose(got[key], want[key], atol=1e-6,
                                       err_msg=key)


def test_aggregate_logits_matches_jax():
    logits = _batches(6, 1)[0][0]
    for reduce in ("sum", "mean", "logsumexp"):
        np.testing.assert_allclose(
            m.aggregate_logits_to_l2(torch.from_numpy(logits),
                                     torch.from_numpy(l3_to_l2_array()),
                                     NUM_L2, reduce).numpy(),
            np.asarray(jax_m.aggregate_logits_to_l2(
                jnp.asarray(logits), jnp.asarray(jax_l3_to_l2()), JAX_NUM_L2,
                reduce)), atol=1e-5)
    with pytest.raises(ValueError, match="reduce"):
        m.aggregate_logits_to_l2(torch.zeros(1, C),
                                 torch.from_numpy(l3_to_l2_array()), NUM_L2,
                                 "max")
