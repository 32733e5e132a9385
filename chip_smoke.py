"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. build   — compiles every kernel of ``albedo_tpu_torch/kernels/csrc`` with
   ``nvcc`` (all at once) and prints the build seconds.
3. kernels — holds each kernel (K1 als_partials, K2 solve_corrected, K3
   bucket_cg, K5 topk_scores) against its plain PyTorch version on the card,
   on edge-case inputs made from a numpy seed: rel 1e-4 for K1-K3 (float32,
   another summation order), exact indices and scores for K5, ties included.
4. job     — runs ``albedo_tpu_torch.cli.main(["train_als"])`` at the job's
   full size (rank 50, 26 iterations, Cholesky) and again with
   ``--solver cg``, with the launch counts set to 0 just before each run and
   read just after; every kernel of each run must have launched, and the
   factors must be finite. Then, on the inputs that run gives its kernels
   (the job's own bucket groups, its seeded fit rebuilt from the same
   arguments, its 250 test users with no exclusion list), holds each kernel
   the run launched against its plain version, as in phase 3.
5. bench   — the JAX package's bench protocol at its scale (30000 x 20000,
   mean 60 stars, 10% held out per user): fits rank 50 x 26 iterations with
   both solvers from one pinned numpy init, and holds the held-out NDCG@30
   against the JAX package's CPU result for that same init (constants
   below). Then times each kernel, its plain version and one PyTorch library
   call at the shapes of that fit, and computes each kernel's bound.

The kernels line (``{"kernels": [...]}``), the card line, and
``{"ok": true, "device": {...}}`` as the last line close the run.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Held-out NDCG@30 of the JAX package (CPU, resident fit) on the bench split
# from the pinned numpy init of phase 5, and the bands the port must land in.
# CG's band is wider: unconverged 3-step CG carries round-off from sweep to
# sweep, so two correct implementations drift apart.
JAX_NDCG = {"cholesky": 0.29399, "cg": 0.29473}
NDCG_TOL = {"cholesky": 2e-3, "cg": 5e-3}
REL_TOL = 1e-4  # K1-K3 against their plain versions

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s and
# FP32 FLOP/s outside the tensor cores. The kernels here run on CUDA cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

KERNELS = {
    "als_partials": ("albedo_tpu_torch/kernels/csrc/als_partials.cu", "albedo_tpu/ops/als.py:108"),
    "solve_corrected": ("albedo_tpu_torch/kernels/csrc/solve_corrected.cu", "albedo_tpu/ops/als.py:138"),
    "bucket_cg": ("albedo_tpu_torch/kernels/csrc/bucket_cg.cu", "albedo_tpu/ops/als.py:154"),
    "topk_scores": ("albedo_tpu_torch/kernels/csrc/topk_scores.cu", "albedo_tpu/ops/topk.py:28"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    return diff, diff / max(scale, 1e-30)


# ------------------------------------------------------------------ phase 1


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return card


# ------------------------------------------------------------------ phase 2


def phase_build() -> None:
    from albedo_tpu_torch.kernels.build import build

    t0 = time.perf_counter()
    seconds = build(verbose=True)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in seconds.items()}})


# ------------------------------------------------------------------ phase 3


def _bucket(rng, n_source: int, b: int, length: int, n_pad: int, dev):
    """A padded bucket like ``datasets.ragged`` builds: front-packed entries,
    idx 0 and val 0 off the mask, the last ``n_pad`` slots all padding."""
    lens = rng.integers(1, length + 1, size=b)
    lens[b - n_pad:] = 0
    lens[0] = length
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 1.5, size=(b, length)), 0.0).astype(np.float32)
    return (torch.as_tensor(idx, device=dev), torch.as_tensor(val, device=dev),
            torch.as_tensor(mask, device=dev))


def phase_kernels() -> dict:
    from albedo_tpu_torch.ops import als as ops_als

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    worst = {name: 0.0 for name in KERNELS}
    cases = []
    for k in (16, 50):
        n_source = 300
        src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32), device=dev)
        yty = ops_als.gramian(src)
        for length in (1, 37, 200):
            idx, val, mask = _bucket(rng, n_source, 64, length, 8, dev)
            corr, b_vec = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0)
            corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0)
            e1 = max(rel_err(corr, corr_p)[1], rel_err(b_vec, b_p)[1])
            n_b = mask.sum(dim=1, dtype=torch.float32)
            x = ops_als.solve_corrected(yty, corr_p, b_p, n_b, 0.5)
            x_p = ops_als.solve_corrected_reference(yty, corr_p, b_p, n_b, 0.5)
            e2 = rel_err(x, x_p)[1]
            x0 = torch.as_tensor((rng.standard_normal((64, k)) * 0.1).astype(np.float32), device=dev)
            y = ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3)
            y_p = ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3)
            e3 = rel_err(y, y_p)[1]
            torch.cuda.synchronize()
            for name, e in (("als_partials", e1), ("solve_corrected", e2), ("bucket_cg", e3)):
                worst[name] = max(worst[name], e)
            cases.append({"k": k, "L": length, "rel": [e1, e2, e3]})

    # K5: I not a multiple of any tile, duplicated item rows (exact ties),
    # -1-padded exclusion lists with duplicates, no exclusion list, then
    # fewer admissible items than k.
    n_users, n_items, r, top = 500, 19991, 50, 30
    uf = (rng.standard_normal((n_users, r)) / np.sqrt(r)).astype(np.float32)
    vf = (rng.standard_normal((n_items, r)) / np.sqrt(r)).astype(np.float32)
    vf[5000:5400] = vf[:400]
    vf[19990] = vf[3]
    excl = np.full((n_users, 80), -1, dtype=np.int32)
    excl[:, :60] = rng.integers(0, n_items, size=(n_users, 60))
    excl[:, 60] = excl[:, 0]
    k5_exact = True
    for u, v, ex in (
        (uf, vf, excl),
        (uf, vf, None),
        (uf[:20], vf[:40], np.tile(np.arange(25, dtype=np.int32), (20, 1))),
    ):
        u_t, v_t = (torch.as_tensor(a, device=dev) for a in (u, v))
        ex_t = None if ex is None else torch.as_tensor(ex, device=dev)
        k5_exact &= _hold_topk(u_t, v_t, top, ex_t)[1] == 0.0
    worst["topk_scores"] = 0.0 if k5_exact else float("inf")
    ok = all(worst[n] <= REL_TOL for n in ("als_partials", "solve_corrected", "bucket_cg")) and k5_exact
    emit({"phase": "kernels", "ok": ok, "rel_tol": REL_TOL, "worst_rel": worst,
          "topk_exact": k5_exact, "cases": cases})
    if not ok:
        raise SystemExit("chip_smoke: a kernel disagrees with its plain version")
    return worst


# ------------------------------------------------------------------ phase 4


def _run_job(argv: list[str]) -> dict:
    from albedo_tpu_torch import cli, kernels

    out = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    text = out.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise SystemExit(f"chip_smoke: {argv} exited {rc}")
    ndcg = float(re.search(r"NDCG@30 = (\S+)", text).group(1))
    health = re.search(r"fit health = (\{.*\})", text).group(1)
    nonfinite = int(re.search(r"'nonfinite': (\d+)", health).group(1))
    return {"argv": argv, "ndcg": ndcg, "nonfinite": nonfinite, "seconds": round(seconds, 3),
            "launches": launches}


def _hold_at_job(argv: list[str], needed: tuple[str, ...]) -> None:
    """Hold each kernel in ``needed`` against its plain version on the
    inputs the job run ``argv`` gives it: the same arguments rebuild the
    same tables, matrix, bucket groups and seeded fit; K1-K3 take every
    group of one iteration at the fitted tables, K5 the job's test users
    with no exclusion list (``ALSRecommender(exclude_seen=False)``)."""
    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import TOP_K, JobContext

    ctx = JobContext(cli.parse_args(argv))
    model = ctx.als_model()
    est = ctx.als_estimator()
    if (est.alpha, est.reg_param, est.cg_steps) != (ALPHA, REG, CG_STEPS):
        raise SystemExit(f"chip_smoke: the job's alpha, reg and CG steps are not {ALPHA, REG, CG_STEPS}")
    calls = _sweep_calls(est, ctx.matrix(), model)
    errs = _hold_sweeps(calls, [n for n in needed if n != "topk_scores"])
    rows = torch.as_tensor(ctx.test_user_dense(), dtype=torch.int64, device=model.device)
    errs["topk_scores"] = _hold_topk(model.user_table[rows].contiguous(), model.item_table, TOP_K, None)
    ok = _within_tol(errs)
    emit({"phase": "job_kernels", "argv": argv, "ok": ok, "groups": len(calls),
          "users": int(rows.numel()), "rel_tol": REL_TOL, "err": errs})
    if not ok:
        raise SystemExit(f"chip_smoke: a kernel disagrees with its plain version at the inputs of {argv}")


def phase_job() -> dict:
    launches = {}
    for argv, needed in (
        (["train_als"], ("als_partials", "solve_corrected", "topk_scores")),
        (["train_als", "--solver", "cg"], ("bucket_cg", "topk_scores")),
    ):
        report = _run_job(argv)
        counts = report["launches"]
        ok = all(counts[n] > 0 for n in needed) and report["nonfinite"] == 0 and bool(np.isfinite(report["ndcg"]))
        emit(dict(report, phase="job", ok=ok))
        if not ok:
            raise SystemExit(f"chip_smoke: {argv} did not launch {needed} or produced non-finite factors")
        for n in needed:
            launches[n] = max(launches.get(n, 0), counts[n])
        _hold_at_job(argv, needed)
    return launches


# ------------------------------------------------------ shared by 4 and 5

ALPHA, REG, CG_STEPS = 40.0, 0.5, 3  # the fits' alpha, reg and CG steps


def _sweep_calls(est, matrix, model) -> list[tuple]:
    """The per-group kernel inputs of one fit iteration at ``model``'s
    tables, both half-sweeps (items first), formed as ``ops.als.half_sweep``
    forms them: (source, yty, idx, val, mask, x0, rows that are not padding,
    entries per row)."""
    from albedo_tpu_torch.ops import als as ops_als

    ug, ig, _, _ = est.device_groups(matrix)
    uf, vf = model.user_table, model.item_table
    calls = []
    for source, target, groups in ((uf, vf, ig), (vf, uf, ug)):
        yty = ops_als.gramian(source)
        for g in groups:
            n, b, length = g.idx.shape
            idx, val, mask = (t.reshape(n * b, length) for t in (g.idx, g.val, g.mask))
            x0 = target[g.row_ids.reshape(-1).clamp(min=0).long()]
            valid = g.row_ids.reshape(-1) >= 0
            calls.append((source, yty, idx, val, mask, x0, valid, mask.sum(dim=1, dtype=torch.float32)))
    return calls


def _k1(fn, calls):
    return [fn(c[0], c[2], c[3], c[4], ALPHA) for c in calls]


def _k2(fn, calls, partials):
    return [fn(c[1], p[0], p[1], c[7], REG) for c, p in zip(calls, partials)]


def _k3(fn, calls):
    return [fn(*c[:6], REG, ALPHA, CG_STEPS) for c in calls]


def _worst(calls, got, want) -> tuple[float, float]:
    """(max abs, max rel) error of ``got`` against ``want`` over every call,
    leaving out the padding slots (the landing drops them)."""
    errs = []
    for c, g, w in zip(calls, got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        for a, b in zip(g, w):
            if a.dim() >= 2 and a.shape[0] == c[6].shape[0]:
                a, b = a[c[6]], b[c[6]]
            errs.append(rel_err(a, b))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _hold_sweeps(calls, names) -> dict:
    """Each of the named kernels among K1-K3 against its plain version over
    ``calls``; K2 takes K1's plain output, so each is held on its own."""
    from albedo_tpu_torch.ops import als as ops_als

    out = {}
    partials = _k1(ops_als.bucket_partial_terms_reference, calls)
    if "als_partials" in names:
        out["als_partials"] = _worst(calls, _k1(ops_als.bucket_partial_terms, calls), partials)
    if "solve_corrected" in names:
        out["solve_corrected"] = _worst(calls, _k2(ops_als.solve_corrected, calls, partials),
                                        _k2(ops_als.solve_corrected_reference, calls, partials))
    if "bucket_cg" in names:
        out["bucket_cg"] = _worst(calls, _k3(ops_als.bucket_cg_body, calls),
                                  _k3(ops_als.bucket_cg_reference, calls))
    return out


def _hold_topk(q, items, k, ex) -> tuple[float, float]:
    """K5 against its plain version: (max abs score error, 0.0 when indices
    and scores are all equal, ties and -inf slots included, else inf)."""
    from albedo_tpu_torch.ops import topk as ops_topk

    s, i = ops_topk.topk_scores(q, items, k, ex)
    s_p, i_p = ops_topk.topk_scores_reference(q, items, k, ex)
    exact = bool(torch.equal(i, i_p)) and bool(torch.equal(s, s_p))
    diff = torch.where(s == s_p, torch.zeros_like(s), (s - s_p).abs())
    return float(diff.max()), 0.0 if exact else float("inf")


def _within_tol(errs: dict) -> bool:
    """rel 1e-4 for K1-K3; K5 exact."""
    return all(rel <= (0.0 if name == "topk_scores" else REL_TOL) for name, (_, rel) in errs.items())


# ------------------------------------------------------------------ phase 5


def phase_bench() -> dict:
    from albedo_tpu_torch.datasets import random_split_by_user, sample_test_users
    from albedo_tpu_torch.datasets.ragged import padded_rows
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars
    from albedo_tpu_torch.evaluators import RankingEvaluator, UserItems, user_actual_items
    from albedo_tpu_torch.models.als import ImplicitALS

    t0 = time.perf_counter()
    matrix = synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)
    train, test = random_split_by_user(matrix, test_ratio=0.1, seed=42)
    rng = np.random.default_rng(42)
    s = np.float32(1 / np.sqrt(50))
    u0 = (rng.standard_normal((train.n_users, 50)) * s).astype(np.float32)
    v0 = (rng.standard_normal((train.n_items, 50)) * s).astype(np.float32)
    users = sample_test_users(train, n=500, seed=42)
    indptr, cols, _ = train.csr()
    excl = padded_rows(indptr, cols, users)
    actual = user_actual_items(test, k=30)
    data_s = time.perf_counter() - t0

    models = {}
    for solver in ("cholesky", "cg"):
        est = ImplicitALS(rank=50, reg_param=REG, alpha=ALPHA, max_iter=26, seed=42,
                          solver=solver, cg_steps=CG_STEPS, init_factors=(u0, v0), device="cuda")
        model = est.fit(train)
        _, idx = model.recommend(users, k=30, exclude_idx=excl)
        ndcg = RankingEvaluator(metric_name="ndcg@k", k=30).evaluate(
            UserItems(users=users, items=idx.astype(np.int32)), actual
        )
        ok = abs(ndcg - JAX_NDCG[solver]) <= NDCG_TOL[solver] and est.last_fit_report["health"]["nonfinite"] == 0
        emit({"phase": "bench", "solver": solver, "ndcg": ndcg, "jax_ndcg": JAX_NDCG[solver],
              "tol": NDCG_TOL[solver], "ok": ok, "fit_s": est.last_fit_report["device_s"],
              "prep_s": est.last_fit_report["prep_s"], "data_s": round(data_s, 3),
              "train_nnz": train.nnz, "health": est.last_fit_report["health"]})
        if not ok:
            raise SystemExit(f"chip_smoke: bench NDCG@30 ({solver}) {ndcg} is off {JAX_NDCG[solver]}")
        models[solver] = (est, model)
    est, model = models["cholesky"]
    return _time_kernels(est, model, train, users, excl)


def _time_kernels(est, model, train, users, excl) -> dict:
    """Each kernel against its plain version and a library call, at the
    shapes of the bench fit: K1-K3 over all bucket groups of one iteration
    (both half-sweeps), K5 over the 500 evaluation users."""
    from albedo_tpu_torch.ops import als as ops_als
    from albedo_tpu_torch.ops import topk as ops_topk

    uf, vf = model.user_table, model.item_table
    k = uf.shape[1]
    calls = _sweep_calls(est, train, model)
    errs = _hold_sweeps(calls, ("als_partials", "solve_corrected", "bucket_cg"))

    def k1_library(src, idx, val, mask, a):
        gathered = src[idx.long()]
        c1 = a * val
        corr = torch.bmm((gathered * c1[..., None]).transpose(1, 2), gathered)
        w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
        return corr, torch.bmm(w[:, None, :], gathered)[:, 0]

    partials = _k1(ops_als.bucket_partial_terms_reference, calls)

    def breakdown(per_call_fns) -> dict:
        """Each bucket group's own kernel time (one timed launch after a
        warm-up): the five slowest groups as [rows, L, ms], and the share of
        the iteration spent in groups with fewer rows than the card has SMs,
        where a one-CTA-per-row grid leaves most of the card idle."""
        for fn in per_call_fns:
            fn()
        torch.cuda.synchronize()
        events = []
        for fn in per_call_fns:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            fn()
            ev[1].record()
            events.append(ev)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in events]
        shapes = [tuple(c[2].shape) for c in calls]
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        narrow = [i for i, (rows, _) in enumerate(shapes) if rows < n_sm]
        top = sorted(range(len(ms)), key=lambda i: -ms[i])[:5]
        return {"top": [[shapes[i][0], shapes[i][1], ms[i]] for i in top],
                "narrow_groups": len(narrow), "narrow_share": sum(ms[i] for i in narrow) / sum(ms)}

    groups_ms = {
        "als_partials": breakdown([
            (lambda c=c: ops_als.bucket_partial_terms(c[0], c[2], c[3], c[4], ALPHA)) for c in calls]),
        "solve_corrected": breakdown([
            (lambda c=c, p=p: ops_als.solve_corrected(c[1], p[0], p[1], c[7], REG))
            for c, p in zip(calls, partials)]),
        "bucket_cg": breakdown([
            (lambda c=c: ops_als.bucket_cg_body(*c[:6], REG, ALPHA, CG_STEPS)) for c in calls]),
    }
    # K2's plain version is the library call (``cholesky_ex`` +
    # ``cholesky_solve``), so it is timed once and reported as both.
    k2_plain_ms = cuda_ms(lambda: _k2(ops_als.solve_corrected_reference, calls, partials))
    res = {
        "als_partials": errs["als_partials"] + (
            cuda_ms(lambda: _k1(ops_als.bucket_partial_terms, calls)),
            cuda_ms(lambda: _k1(ops_als.bucket_partial_terms_reference, calls)),
            cuda_ms(lambda: _k1(k1_library, calls)),
        ),
        "solve_corrected": errs["solve_corrected"] + (
            cuda_ms(lambda: _k2(ops_als.solve_corrected, calls, partials)), k2_plain_ms, k2_plain_ms,
        ),
        "bucket_cg": errs["bucket_cg"] + (
            cuda_ms(lambda: _k3(ops_als.bucket_cg_body, calls)),
            cuda_ms(lambda: _k3(ops_als.bucket_cg_reference, calls)),
            None,
        ),
    }

    q = uf[torch.as_tensor(users, dtype=torch.int64, device=uf.device)].contiguous()
    ex = torch.as_tensor(excl, device=uf.device)

    def k5_library():
        scores = q @ vf.T
        ex_l = torch.where(ex < 0, vf.shape[0], ex.long())
        hit = torch.zeros((q.shape[0], vf.shape[0] + 1), dtype=torch.bool, device=q.device)
        hit.scatter_(1, ex_l, True)
        return torch.topk(scores.masked_fill(hit[:, :-1], float("-inf")), 30, dim=1)

    res["topk_scores"] = _hold_topk(q, vf, 30, ex) + (
        cuda_ms(lambda: ops_topk.topk_scores(q, vf, 30, ex)),
        cuda_ms(lambda: ops_topk.topk_scores_reference(q, vf, 30, ex)),
        cuda_ms(k5_library),
    )

    # Least time for the same work: each input byte read once, each output
    # written once, over HBM bandwidth; the operations these inputs need
    # over FP32 peak. K1 counts the symmetric k(k+1) + 2k FLOP per
    # masked-in entry; K2 k^3/3 + 2k^2 per system; K3 its b/diag pass and
    # steps + 1 matvecs over the masked-in entries plus the YtY products.
    slots = sum(c[2].numel() for c in calls)
    entries = sum(int(c[4].sum()) for c in calls)
    rows = sum(c[2].shape[0] for c in calls)
    table_bytes = 4 * (uf.numel() + vf.numel())
    slot_bytes = 9 * slots  # idx 4 + val 4 + mask 1
    work = {
        "als_partials": (slot_bytes + table_bytes + 4 * rows * (k * k + k),
                         entries * (k * (k + 1) + 2 * k)),
        "solve_corrected": (4 * rows * (k * k + 2 * k + 1) + 4 * k * k * 2,
                            rows * (k ** 3 / 3 + 2 * k * k)),
        "bucket_cg": (slot_bytes + table_bytes + 4 * rows * 2 * k + 4 * k * k * 2,
                      entries * 4 * k * (CG_STEPS + 2) + rows * ((CG_STEPS + 1) * 2 * k * k + CG_STEPS * 10 * k)),
        "topk_scores": (4 * (q.numel() + vf.numel() + ex.numel()) + 8 * q.shape[0] * 30,
                        2 * q.shape[0] * vf.shape[0] * k),
    }
    out = {}
    for name, (abs_err, rel, ms, plain_ms, lib_ms) in res.items():
        nbytes, flops = work[name]
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        out[name] = {
            "max_abs_err": abs_err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
    ok = _within_tol({name: (v["max_abs_err"], v["rel_err"]) for name, v in out.items()})
    emit({"phase": "bench_kernels", "ok": ok, "groups": len(calls), "slots": slots,
          "per_group": groups_ms,
          "entries": entries, "rows": rows, "timed": out})
    if not ok:
        raise SystemExit("chip_smoke: a kernel disagrees with its plain version at the bench shapes")
    return out


def main() -> int:
    card = phase_device()
    phase_build()
    phase_kernels()
    launches = phase_job()
    timed = phase_bench()
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches.get(name, 0), "max_abs_err": timed[name]["max_abs_err"],
         "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"],
         "bound_ms": timed[name]["bound_ms"], "bound_by": timed[name]["bound_by"],
         "library_ms": timed[name]["library_ms"]}
        for name, (src, rep) in KERNELS.items()
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
