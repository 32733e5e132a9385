"""K13, the ranking metrics, on the CPU: the port's ``ranking_metrics`` (its
plain version on CPU tensors) against the JAX package's ``_ranking_metrics``
row by row, and ``RankingEvaluator`` against the JAX evaluator for each
metric, on lists drawn from a seed: padded rows, rows with no actual items,
duplicate predictions, predictions shorter and longer than the actual list,
and widths over 32 (the kernel's lanes take 32 slots at a time). Float32
sums in another order: atol 1e-6. The kernel itself runs only on the card
(``tests/test_torch_cuda.py -k ranking_metrics``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.evaluators import RankingEvaluator as JEval
from albedo_tpu.evaluators import UserItems as JItems
from albedo_tpu.evaluators.ranking import _ranking_metrics as j_ranking_metrics
from albedo_tpu_torch.evaluators import RankingEvaluator, UserItems, ndcg_at_k
from albedo_tpu_torch.evaluators import ranking

ATOL = 1e-6


def lists(seed: int, q: int, kp: int, ka: int, n_items: int) -> tuple[np.ndarray, np.ndarray]:
    """-1-padded (q, kp) predictions and (q, ka) actual items: random
    lengths (0 included), items from a small catalog so that hits are
    common, a few duplicate predictions."""
    rng = np.random.default_rng(seed)
    pred = np.full((q, kp), -1, np.int32)
    actual = np.full((q, ka), -1, np.int32)
    for r in range(q):
        n_p, n_a = rng.integers(0, kp + 1), rng.integers(0, ka + 1)
        pred[r, :n_p] = rng.integers(0, n_items, n_p) if r % 5 == 0 else rng.permutation(n_items)[:n_p]
        actual[r, :n_a] = rng.permutation(n_items)[:n_a]
    pred[0], actual[0] = np.arange(kp) % n_items, np.arange(ka) % n_items  # full rows
    return pred, actual


SHAPES = [(40, 5, 5, 5, 12), (64, 30, 30, 30, 60), (33, 30, 12, 30, 40), (50, 40, 40, 40, 90),
          (20, 70, 65, 70, 120), (8, 1, 3, 1, 4)]


@pytest.mark.parametrize("q,kp,ka,k,n_items", SHAPES)
def test_ranking_metrics_match_jax(q, kp, ka, k, n_items):
    pred, actual = lists(q + kp, q, kp, ka, n_items)
    got = ranking.ranking_metrics(torch.as_tensor(pred), torch.as_tensor(actual), k)
    want = j_ranking_metrics(jnp.asarray(pred), jnp.asarray(actual), k)
    for name in ("ndcg", "precision", "map"):
        assert got[name].dtype == torch.float32 and got[name].shape == (q,)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("q,kp,ka,k,n_items", SHAPES[:3])
def test_ranking_metrics_on_cpu_is_the_plain_version(q, kp, ka, k, n_items):
    pred, actual = (torch.as_tensor(x) for x in lists(q, q, kp, ka, n_items))
    got, want = ranking.ranking_metrics(pred, actual, k), ranking.ranking_metrics_reference(pred, actual, k)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("metric", ["ndcg@k", "precision@k", "map"])
def test_evaluator_matches_jax(metric):
    pred, actual = lists(7, 120, 30, 30, 50)
    users = np.arange(120, dtype=np.int32) * 3
    # actual rows for every third user only, in another order: the inner join on users
    a_users = users[::-1][::2].copy()
    a_items = actual[::-1][::2].copy()
    got = RankingEvaluator(metric_name=metric, k=30, device="cpu").evaluate(
        UserItems(users, pred), UserItems(a_users, a_items))
    want = JEval(metric_name=metric, k=30).evaluate(JItems(users, pred), JItems(a_users, a_items))
    assert abs(got - want) <= ATOL, (got, want)
    assert abs(ndcg_at_k(pred, actual, 30, device="cpu")
               - float(j_ranking_metrics(jnp.asarray(pred), jnp.asarray(actual), 30)["ndcg"].mean())) <= ATOL


def test_evaluator_runs_on_the_card_by_default(monkeypatch):
    """No CPU fallback: the evaluator asks for the card unless told the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pred, actual = lists(3, 4, 5, 5, 10)
    items = UserItems(np.arange(4, dtype=np.int32), pred)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RankingEvaluator(k=5).evaluate(items, UserItems(np.arange(4, dtype=np.int32), actual))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ndcg_at_k(pred, actual, 5)
