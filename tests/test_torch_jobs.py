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
