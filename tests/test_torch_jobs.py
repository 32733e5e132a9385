"""The port's jobs against the JAX package's, at ``--small`` on the CPU.

``train_als``: the seeded inits differ (torch cannot reproduce
``jax.random``), so the two jobs' NDCG@30 are compared within 0.02 (measured
difference 0.0047 on this configuration). With one injected numpy init
shared by both jobs they agree within 1e-3.

``train_lr``: with the ALS init and the Word2Vec weights shared, AUC
agrees within 1e-4 and NDCG@30 within 1e-3 (the LR solves differ only by
float32 round-off). Seeded runs differ in both inits; the full-size seeded
job is held to the JAX seed spread on the card (``chip_smoke.py``).
``train_word2vec``: the parameter dump and the vocabulary are identical."""

import re

import numpy as np
import pytest

import albedo_tpu.models.als as jax_als_mod
import albedo_tpu.models.word2vec as jax_w2v_mod
import albedo_tpu_torch.models.word2vec as torch_w2v_mod
from albedo_tpu.cli import main as jax_main
from albedo_tpu_torch.builders import jobs as torch_jobs
from albedo_tpu_torch.cli import main as torch_main

NOW = "1600000000"


def _ndcg(text: str) -> float:
    return float(re.search(r"\[train_als\] NDCG@30 = (\S+)", text).group(1))


def _run(main, argv, capsys) -> float:
    assert main(argv) == 0
    return _ndcg(capsys.readouterr().out)


def _metric(text: str, job: str, name: str) -> float:
    return float(re.search(rf"\[{job}\] {name} = (\S+)", text).group(1))


def _with_init(cls, shared):
    """``cls`` with every fit starting from one shared numpy init."""

    class Injected(cls):
        def fit(self, matrix, callback=None):
            if matrix.n_users not in shared:
                rng = np.random.default_rng(1)
                s = np.float32(1 / np.sqrt(self.rank))
                shared[matrix.n_users] = (
                    (rng.standard_normal((matrix.n_users, self.rank)) * s).astype(np.float32),
                    (rng.standard_normal((matrix.n_items, self.rank)) * s).astype(np.float32),
                )
            self.init_factors = shared[matrix.n_users]
            return super().fit(matrix, callback)

    return Injected


def test_port_job_runs_on_cpu(capsys):
    assert torch_main(["train_als", "--small", "--device", "cpu", "--now", NOW]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[train_als\] star-matrix sparsity = 0\.\d+", out)
    assert "'nonfinite': 0" in out
    assert 0.0 < _ndcg(out) <= 1.0


def test_port_job_matches_jax_job(capsys):
    t = _run(torch_main, ["train_als", "--small", "--device", "cpu", "--now", NOW], capsys)
    j = _run(jax_main, ["train_als", "--small", "--now", NOW], capsys)
    assert abs(t - j) <= 0.02, (t, j)


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_jobs_with_shared_init_match(capsys, monkeypatch, solver):
    shared = {}
    monkeypatch.setattr(torch_jobs, "ImplicitALS", _with_init(torch_jobs.ImplicitALS, shared))
    monkeypatch.setattr(jax_als_mod, "ImplicitALS", _with_init(jax_als_mod.ImplicitALS, shared))
    argv = ["train_als", "--small", "--now", NOW, "--solver", solver]
    t = _run(torch_main, argv + ["--device", "cpu"], capsys)
    j = _run(jax_main, argv, capsys)
    assert abs(t - j) <= 1e-3, (t, j)


def test_cuda_without_a_card_fails(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main(["train_als", "--small"])


LR_ARGV = ["train_lr", "--small", "--now", NOW]


def test_port_lr_job_runs_on_cpu(capsys):
    assert torch_main(LR_ARGV + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert 0.5 < _metric(out, "train_lr", "areaUnderROC") <= 1.0
    assert 0.0 < _metric(out, "train_lr", "NDCG@30") <= 1.0
    assert re.search(r"\[train_lr\] lbfgs iterations = \d+, final loss = \d", out)
    stages = re.search(r"\[train_lr\] stages = (\{.*\})", out).group(1)
    for name in ("als_fit", "w2v_fit", "featurize", "lr_fit", "fuse_rerank_ndcg"):
        assert f'"{name}"' in stages


def test_lr_jobs_with_shared_weights_match(capsys, monkeypatch):
    shared, fits = {}, {}
    monkeypatch.setattr(torch_jobs, "ImplicitALS", _with_init(torch_jobs.ImplicitALS, shared))
    monkeypatch.setattr(jax_als_mod, "ImplicitALS", _with_init(jax_als_mod.ImplicitALS, shared))
    port_fit = torch_w2v_mod.Word2Vec.fit_corpus

    def shared_w2v(est, sentences):
        key = (est.dim, est.max_iter, est.min_count)
        if key not in fits:
            fits[key] = port_fit(torch_w2v_mod.Word2Vec(
                dim=est.dim, min_count=est.min_count, max_iter=est.max_iter,
                subsample=est.subsample, device="cpu"), sentences)
        return fits[key]

    monkeypatch.setattr(torch_w2v_mod.Word2Vec, "fit_corpus", shared_w2v)
    monkeypatch.setattr(
        jax_w2v_mod.Word2Vec, "fit_corpus",
        lambda est, sentences: jax_w2v_mod.Word2VecModel(
            vocab=list(shared_w2v(est, sentences).vocab), vectors=shared_w2v(est, sentences).vectors),
    )
    assert torch_main(LR_ARGV + ["--device", "cpu"]) == 0
    t = capsys.readouterr().out
    assert jax_main(LR_ARGV + ["--data-policy", "off"]) == 0
    j = capsys.readouterr().out
    for name, tol in (("areaUnderROC", 1e-4), ("NDCG@30", 1e-3)):
        a, b = _metric(t, "train_lr", name), _metric(j, "train_lr", name)
        assert abs(a - b) <= tol, (name, a, b)


def test_word2vec_job_matches_jax_job(capsys):
    argv = ["train_word2vec", "--small", "--now", NOW]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    t = capsys.readouterr().out
    assert jax_main(argv) == 0
    j = capsys.readouterr().out
    dump = re.compile(r"\[train_word2vec\] Word2Vec\(.*\)")
    assert dump.search(t).group(0) == dump.search(j).group(0)
    assert _metric(t, "train_word2vec", "vocab") == _metric(j, "train_word2vec", "vocab")


@pytest.mark.parametrize("job", ["train_lr", "train_word2vec"])
def test_ranker_jobs_without_a_card_fail(monkeypatch, job):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main([job, "--small"])


# The candidate-generator jobs at --small: each port job against the JAX
# job. popularity and curation are host code: equal. The CFs sum their
# sparse passes in other orders: NDCG@30 within 1e-5 (measured 3e-8).
# tfidf_content: the same similar-repo list, scores as printed (4 decimals),
# up to the order of equal printed scores.
CANDIDATE_JOBS = {"popularity": 0.0, "curation": 0.0, "item_cf": 1e-5, "user_cf": 1e-5}


@pytest.mark.parametrize("job", sorted(CANDIDATE_JOBS))
def test_candidate_jobs_match_jax(capsys, job):
    argv = [job, "--small", "--now", NOW]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    t = _metric(capsys.readouterr().out, job, "NDCG@30")
    assert jax_main(argv + ["--data-policy", "off"]) == 0
    j = _metric(capsys.readouterr().out, job, "NDCG@30")
    assert 0.0 < t <= 1.0
    assert abs(t - j) <= CANDIDATE_JOBS[job], (t, j)


def _similar(text: str) -> list[tuple[str, str]]:
    return re.findall(r"\[tfidf_content\] (\d\.\d{4}) (\S+)", text)


def test_tfidf_content_job_matches_jax(capsys):
    argv = ["tfidf_content", "--small", "--now", NOW]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    t = capsys.readouterr().out
    assert jax_main(argv + ["--data-policy", "off"]) == 0
    j = capsys.readouterr().out
    got, want = _similar(t), _similar(j)
    assert len(got) == len(want) == 10
    assert [s for s, _ in got] == [s for s, _ in want]
    assert sorted(got) == sorted(want)
    assert _metric(t, "tfidf_content", "indexed_repos") == _metric(j, "tfidf_content", "indexed_repos")


def test_ranking_mf_job_matches_jax(capsys, monkeypatch):
    """Seeded, the two jobs draw other random streams: NDCG@30 within 0.05
    (measured 0.011). With the JAX fit's own ``jax.random`` draws handed to
    the port's fit, within 2e-3 (Adam amplifies the round-off of small
    gradients, ``tests/test_torch_ranking_mf.py``)."""
    from albedo_tpu_torch.models import ranking_factorization as port_rf
    from test_torch_ranking_mf import jax_draws

    argv = ["ranking_mf", "--small", "--now", NOW]
    assert jax_main(argv + ["--data-policy", "off"]) == 0
    j = _metric(capsys.readouterr().out, "ranking_mf", "NDCG@30")
    assert torch_main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[ranking_mf\] steps = 45, final epoch loss = \d", out)
    assert abs(_metric(out, "ranking_mf", "NDCG@30") - j) <= 0.05
    fit = port_rf.RankingFactorization.fit

    def with_jax_draws(self, matrix, user_side=None, item_side=None, init=None, schedule=None):
        init, schedule = jax_draws(matrix.n_users, matrix.n_items, matrix.nnz, rank=self.rank,
                                   epochs=self.epochs, batch=self.batch_size, negatives=self.negatives,
                                   seed=self.seed)
        return fit(self, matrix, user_side, item_side, init, schedule)

    monkeypatch.setattr(port_rf.RankingFactorization, "fit", with_jax_draws)
    assert torch_main(argv + ["--device", "cpu"]) == 0
    assert abs(_metric(capsys.readouterr().out, "ranking_mf", "NDCG@30") - j) <= 2e-3


def test_content_job_with_shared_vectors_matches_jax(capsys, monkeypatch):
    """Word2Vec vectors shared by both jobs (numpy over the job's vocabulary,
    as ``jax_reference_ndcg.py candidates`` shares them): NDCG@30 within
    1e-4 (the two packages order near-equal cosine scores by other sums)."""
    from jax_reference_ndcg import _vocab, shared_w2v_vectors

    def shared(module):
        def fit_corpus(est, sentences):
            vocab = _vocab(sentences, est.min_count)
            return module.Word2VecModel(vocab=vocab, vectors=shared_w2v_vectors(len(vocab), est.dim))
        return fit_corpus

    monkeypatch.setattr(torch_w2v_mod.Word2Vec, "fit_corpus", shared(torch_w2v_mod))
    monkeypatch.setattr(jax_w2v_mod.Word2Vec, "fit_corpus", shared(jax_w2v_mod))
    argv = ["content", "--small", "--now", NOW]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    t = _metric(capsys.readouterr().out, "content", "NDCG@30")
    assert jax_main(argv + ["--data-policy", "off"]) == 0
    j = _metric(capsys.readouterr().out, "content", "NDCG@30")
    assert 0.0 < t <= 1.0 and abs(t - j) <= 1e-4, (t, j)


@pytest.mark.parametrize("job", ["popularity", "curation", "content", "item_cf", "user_cf", "ranking_mf",
                                 "tfidf_content"])
def test_candidate_jobs_without_a_card_fail(monkeypatch, job):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main([job, "--small"])
