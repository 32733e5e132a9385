"""The port stands alone: no module of ``albedo_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, every module imports
without ``nvcc`` or ``triton``, and asking for CUDA without a card fails
instead of falling back to the CPU."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest
import torch

import albedo_tpu_torch
from albedo_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "albedo_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "albedo_tpu", "flax", "optax", "triton"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_without_nvcc():
    names = [
        m.name for m in pkgutil.walk_packages(albedo_tpu_torch.__path__, "albedo_tpu_torch.")
    ]
    for needed in ("kernels.build", "cli", "ops.sparse_linear", "ops.sgns", "models.word2vec",
                   "models.logistic_regression", "builders.ranker", "features.assembler",
                   "ops.spmm", "ops.bpr", "models.ranking_factorization", "recommenders.cf",
                   "recommenders.tfidf", "recommenders.content", "utils.events", "utils.faults",
                   "serving.batcher", "serving.service", "serving.cache", "serving.metrics",
                   "serving.overload", "serving.http", "retrieval.bank", "retrieval.build",
                   "retrieval.parity", "serving.pipeline", "serving.breaker", "utils.retry",
                   "utils.watchdog", "utils.graphs", "ops.lbfgs", "cv", "evaluators.ranking"):
        assert f"albedo_tpu_torch.{needed}" in names
    for name in names:
        importlib.import_module(name)
    from albedo_tpu_torch import kernels
    from albedo_tpu_torch.kernels import build

    assert set(kernels.LAUNCHES) == {
        "als_partials", "solve_corrected", "bucket_cg", "topk_scores", "topk_scores_wide",
        "segment_dot", "sgns_step", "adam_dense", "spmm_rows", "masked_topk", "bpr_step",
        "gather_topk", "bank_query", "topk_select", "gather_sum", "factor_health",
        "als_partials_wide", "solve_corrected_wide", "bucket_cg_wide",
        "topk_scores_select", "gather_topk_select", "bank_query_select",
        "segment_dot_grid", "gather_sum_grid", "land_rows", "scatter_rows",
        "als_partials_bf16", "bucket_cg_bf16", "als_partials_bf16_wide", "bucket_cg_bf16_wide",
        "sgns_shared", "masked_select", "masked_topk_select", "sgns_step_wide", "bpr_step_wide",
        "als_partials_tiled", "als_partials_bf16_tiled", "bucket_cg_tiled", "bucket_cg_bf16_tiled",
        "lbfgs_state", "lbfgs_stop", "ranking_metrics", "lbfgs_direction", "logloss",
    }
    assert not build._libs  # nothing built or loaded at import
    for name in kernels.LAUNCHES:
        assert (build.CSRC / f"{build.source_of(build.PATHS.get(name, name))}.cu").is_file()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    from albedo_tpu_torch import kernels
    from albedo_tpu_torch.ops.topk import topk_scores

    kernels.reset_launches()
    vals, idx = topk_scores(torch.eye(3), torch.eye(3), 2)
    assert idx[:, 0].tolist() == [0, 1, 2]
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_launch_counts_keep_every_concurrent_launch(monkeypatch):
    """The serving batcher and HTTP threads launch kernels at once: the
    launch counter is a locked read-modify-write, so no launch is lost
    (16 threads x 2000 launches of a stand-in library, with a tiny switch
    interval to force interleaving)."""
    import contextlib
    import sys
    import threading
    import types

    from albedo_tpu_torch import kernels
    from albedo_tpu_torch.kernels import build

    monkeypatch.setitem(build._libs, "topk_scores", types.SimpleNamespace(topk_scores_launch=lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: types.SimpleNamespace(cuda_stream=0))
    kernels.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [build.call("topk_scores", "cuda") for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["topk_scores"] == 16 * 2000
    kernels.reset_launches()
