"""K1-K3 timings on the card beyond ``chip_smoke.py``'s: every bucket group
of one iteration of the bench ALS fit, group by group.

    python -m albedo_tpu_torch.kernels.als_partials_bench groups
    python -m albedo_tpu_torch.kernels.als_partials_bench groups --against /path/to/other/root
    python -m albedo_tpu_torch.kernels.als_partials_bench variants
    python -m albedo_tpu_torch.kernels.als_partials_bench wide --against /path/to/other/root
    python -m albedo_tpu_torch.kernels.als_partials_bench variants k3w
    python -m albedo_tpu_torch.kernels.als_partials_bench orders --seed 2

``groups``: the bench split (``synthetic_stars(30000, 20000, rank=24,
mean_stars=60, seed=42)``, 10% of each user's stars held out, seed 42), its
74 bucket groups as ``ImplicitALS(rank=50).device_groups`` builds them, and
rank-50 tables from the bench's pinned numpy init. For float32 and bf16
gathers, each group's K1 call (``ops.als.bucket_partial_terms``) is held
against its plain version (max relative error) and timed: the card's kernel
ms of each group (``torch.profiler`` sums over 5 calls), the five slowest
groups as [rows, L, ms], ``narrow_share`` (the share of the kernel time in
groups with fewer rows than the card has SMs), the iteration's kernel ms,
and CUDA-event ms of the iteration's 74 calls (host launch path included)
beside the library yardstick (the gather, then two batched matrix
products). K2 (``solve_corrected``, on each group's plain K1 terms, the live
rows held) and K3 / K3-bf16 (``bucket_cg_body``, 3 steps from the other
table's rows) are held and timed the same way (K2's yardstick, its plain
version, is ``cholesky_ex`` + ``cholesky_solve``; K3 has none; K3-bf16
also row by row against F9's limits, ``over_limit`` the worst row's share
of its ``ops.als.bucket_cg_bf16_limits``). With
``--against ROOT`` the groups, tables and the train split
are saved under ``build/bench/`` and each tree times them, and the bench
fit's device seconds (Cholesky, CG-3, and both at bf16 gathers, 26
iterations from the pinned init), in a process of its own,
importing its own package (and building its own kernels), in the order
ROOT, this tree, this tree, ROOT: the parent-against-change comparison of
one card. ``variants``: the float32 groups' kernel ms and ``narrow_share``
under other plans of the split design (``PLAN_VARIANTS``: units aimed at an
SM, the shortest chunk, CTAs an SM for packed rows) and through copies of
its source with a part cut out (``SOURCE_VARIANTS``). Prints one JSON line
(``--against``: each tree's, then the comparison). ``variants k2``: K2 over
the groups through copies of its source with other tuning constants
(``K2_SOURCE_VARIANTS``); ``variants k1w`` and ``variants k2w``: the same
for K1's and K2's wide paths over the rank-100 fit's groups (K1's plans and
sources; ``K2_WIDE_VARIANTS``); ``variants k3``: K3 and K3-bf16 with other
lengths of the rows warp mode takes (``K3_PACK_VARIANTS``), other
widest clusters (``K3_CLUSTER_VARIANTS``) and widest spreads of few-row
groups (``K3_SPREAD_VARIANTS``). ``ranks``: K2
alone at ranks 8 to 64 on random systems (``K2_RANKS``). ``wide [--against
ROOT]``: K1 wide, K1-bf16 wide and K2 wide over the rank-100 fit's 54
groups (``WIDE_GROUPS``; ``time_wide``), held and timed as ``groups``
does, then the rank-100 fit's device seconds and the real cv_als grid's
wall seconds (``time_wide_fits``), each tree in its own process with
``--against``; also K3 wide and K3-bf16 wide over the same groups
(``time_wide_k3``: K3-bf16 also row by row to F9's limits,
``over_limit``) and the 26-iteration rank-100 CG fit and the real grid by
CG. ``variants k3w``: K3 and K3-bf16 wide over those groups under other
warp-mode lengths (``K3W_PACK_VARIANTS``) and widest spreads
(``K3W_SPREAD_VARIANTS``). Needs a GPU; the
CPU has nothing to measure here, but ``orders [--seed N]``: F9's row limits
against further random orders of the sums at the bench's long groups
(``time_orders``; the plain version only, so also on the CPU).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# The bench fit's bucket groups (rows B, slots L), items' half-sweep then
# users': ``ImplicitALS(rank=50).device_groups`` of the bench split above.
BENCH_GROUPS = [
    (1, 5008), (1, 6624), (1, 7624), (2, 5760), (4, 3288), (8, 2856), (8, 3784), (16, 1872),
    (16, 2152), (16, 2480), (32, 1408), (32, 1624), (64, 1), (64, 920), (64, 1064), (64, 1224),
    (128, 2), (128, 800), (256, 448), (256, 520), (256, 600), (256, 696), (512, 4), (512, 280),
    (512, 328), (512, 384), (1024, 8), (1024, 64), (1024, 112), (1024, 128), (1024, 152),
    (1024, 176), (1024, 208), (1024, 240), (2048, 16), (2048, 24), (2048, 32), (2048, 40),
    (2048, 48), (2048, 56), (2048, 80), (2048, 96),
    (2, 1624), (8, 1064), (8, 1224), (8, 1408), (16, 1), (16, 920), (32, 2), (32, 800), (64, 600),
    (64, 696), (128, 4), (128, 520), (256, 384), (256, 448), (512, 8), (512, 280), (512, 328),
    (1024, 176), (1024, 208), (1024, 240), (2048, 56), (2048, 64), (2048, 112), (2048, 128),
    (2048, 152), (3072, 16), (3072, 24), (3072, 32), (3072, 40), (3072, 48), (3072, 80),
    (3072, 96),
]
# The rank-100 fit's bucket groups (rows B, slots L), items' half-sweep then
# users': ``ImplicitALS(rank=100).device_groups`` of the ``train_als`` job's
# tables, the fit ``chip_smoke.py``'s ``wide_rank`` phase and ``cv_als``'s
# rank-100 grid points run through K1's and K2's wide paths. The CPU plan
# tests take their shapes from here; ``wide_data`` builds the groups
# themselves, and tests/test_torch_ops_als.py holds this list to them.
WIDE_GROUPS = [
    (1, 1224), (2, 1064), (4, 600), (4, 696), (4, 800), (16, 384), (16, 448), (16, 520), (32, 240), (32, 280),
    (32, 328), (64, 128), (64, 176), (64, 208), (128, 1), (128, 2), (128, 56), (128, 64), (128, 96), (128, 112),
    (128, 152), (256, 4), (256, 32), (256, 40), (256, 48), (256, 80), (512, 8), (512, 16), (512, 24),
    (1, 448), (1, 600), (1, 696), (2, 384), (8, 280), (8, 328), (16, 240), (32, 1), (32, 176), (32, 208), (64, 2),
    (64, 112), (64, 128), (64, 152), (128, 96), (256, 4), (256, 56), (256, 64), (256, 80), (512, 40), (512, 48),
    (1024, 8), (1024, 24), (1024, 32), (2048, 16),
]
ALPHA, RANK, REPS, REG, CG_STEPS = 40.0, 50, 5, 0.5, 3
# name -> (K1_UNITS_PER_SM, K1_MIN_CHUNK, K1_CTAS_PER_SM) of ops/als.py.
# Source variants of csrc/als_partials.cu (text replaced, built beside the
# package's build; their answers are not K1's): "no products" skips the FMA
# loop (what is left is staging, synchronization and the output), "no row
# copy" skips the coalesced copy of each unsplit row's output from shared
# memory to the card's memory.
SOURCE_VARIANTS = {
    "no products": [("      if (!active[q]) continue;\n      const float* yb",
                     "      if (!active[q] || nl >= 0) continue;\n      const float* yb")],
    "no row copy": [("e < k * k / 4; e += blockDim.x)", "e < 0; e += blockDim.x)"),
                    ("e < k * k; e += blockDim.x) out[e] = so[e];", "e < 0; e += blockDim.x) out[e] = so[e];")],
}
# Source variants of csrc/solve_corrected.cu: K2's CTAs an SM (registers
# capped for more), the column sums' shuffles as __shfl_sync (which the
# compiler may hoist), and copies with a part cut out, for where the time
# goes (their answers are not K2's): "no column dots" skips the sums of the
# finished columns, "no substitutions" the two triangular solves, "no
# staging" the copy of the next system's correction (a stale slab is read).
K2_SOURCE_VARIANTS = {
    "default": [],
    "min ctas 3": [("constexpr int MIN_CTAS = 1;", "constexpr int MIN_CTAS = 3;")],
    "min ctas 4": [("constexpr int MIN_CTAS = 1;", "constexpr int MIN_CTAS = 4;")],
    "no column dots": [("#pragma unroll\n      for (int p = 0; p < j; ++p) {",
                        "#pragma unroll\n      for (int p = 0; p < 0; ++p) {")],
    "no substitutions": [("    for (int j = 0; j < KC; ++j) {\n      if (j >= k) break;\n      const float yj",
                          "    for (int j = 0; j < 0; ++j) {\n      if (j >= k) break;\n      const float yj"),
                         ("    for (int j = KC - 1; j >= 0; --j) {", "    for (int j = -1; j >= 0; --j) {")],
    "no staging": [("    if (s + step < B) stage_upper(", "    if (false) stage_upper(")],
    "builtin shuffles": [("        const float v = shfl_in_order(j < 32 ? A0(p) : A1(p), j & 31);",
                          "        const float v = __shfl_sync(FULL, j < 32 ? A0(p) : A1(p), j & 31);")],
}
# Source variants of K2's wide path (csrc/solve_corrected.cu): the next
# system staged or not, 8-warp CTAs for every group, and copies with a phase
# cut out (their answers are not K2's).
K2_WIDE_VARIANTS = {
    "default": [],
    "unstaged": [("constexpr int WIDE_STAGE_MAX = 113 * 1024;", "constexpr int WIDE_STAGE_MAX = 0;")],
    "8 warps only": [("  if (busy > per_sm * n_sm && per_sm_half >= 2 * per_sm) {", "  if (false) {")],
    "no diagonal blocks": [("      if (warp == 0) factor_diagonal(A, dinv, p0, nb, w, lane);", "")],
    "no trailing update": [("        trailing_update(A, Lt, nb, r0, w);", "")],
    "no back substitution": [("    for (int p0 = (k - 1) / NB * NB; p0 >= 0; p0 -= NB) {",
                              "    for (int p0 = -1; p0 >= 0; p0 -= NB) {")],
    "no panel rows": [("      for (int i = r0 + threadIdx.x; i <= k; i += THREADS) panel_row(",
                       "      for (int i = k + 1; i <= k; i += THREADS) panel_row(")],
    "no staging": [("      if (s + step < B)\n        stage_system<true>", "      if (false)\n        stage_system<true>")],
}
# K3's plan variants: the longest row warp mode takes (ops/als.py K3_PACK_L).
K3_PACK_VARIANTS = (32, 64, 128)
K3_CLUSTER_VARIANTS = (8, 16)  # the widest cluster a K3 plan may take (c_max of ops/als.py _k3_plan)
K3_SPREAD_VARIANTS = (4, 8, 16)  # the widest cluster a group of few rows is spread over (K3_SPREAD)
PLAN_VARIANTS = {"default": (8, 64, 16), "units 4, ctas 8": (4, 64, 8), "units 2, ctas 8": (2, 64, 8),
                 "units 4, ctas 16": (4, 64, 16), "units 8, ctas 8": (8, 64, 8), "chunk 128": (8, 128, 16),
                 "chunk 32": (8, 32, 16), "ctas 4": (8, 64, 4)}
DATA = Path("build") / "bench" / "als_partials_groups.pt"


def bench_data(torch, dev) -> dict:
    """The bench split's groups (flattened to (N B, L)) and the pinned
    rank-50 tables, on ``dev``: calls [(source side, idx, val, mask, row
    ids)] (a row id -1 is a padding slot)."""
    from albedo_tpu_torch.datasets import random_split_by_user
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars
    from albedo_tpu_torch.models.als import ImplicitALS

    matrix = synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)
    train, _ = random_split_by_user(matrix, test_ratio=0.1, seed=42)
    rng = np.random.default_rng(42)
    s = np.float32(1 / np.sqrt(RANK))
    u0 = (rng.standard_normal((train.n_users, RANK)) * s).astype(np.float32)
    v0 = (rng.standard_normal((train.n_items, RANK)) * s).astype(np.float32)
    ug, ig, _, _ = ImplicitALS(rank=RANK, device=str(dev)).device_groups(train)
    calls = []
    for side, groups in (("users", ig), ("items", ug)):  # the fixed side each half-sweep gathers
        for g in groups:
            n, b, length = g.idx.shape
            calls.append((side, *(t.reshape(n * b, length).contiguous() for t in (g.idx, g.val, g.mask)),
                          g.row_ids.reshape(-1).contiguous()))
    split = [torch.as_tensor(a) for a in (train.user_ids, train.item_ids, train.rows, train.cols, train.vals)]
    return {"users": torch.as_tensor(u0, device=dev), "items": torch.as_tensor(v0, device=dev), "calls": calls,
            "train": split}


def time_fits(data: dict) -> dict:
    """The bench fit's device seconds (rank 50, 26 iterations, reg 0.5,
    alpha 40, from the pinned init), Cholesky and CG-3, at float32 and bf16
    gathers, as ``chip_smoke.py``'s bench phases fit it; ``<name>_total``
    adds the graph's capture (``compile_s``; a tree without it counts 0)."""
    from albedo_tpu_torch.datasets.star_matrix import StarMatrix
    from albedo_tpu_torch.models.als import ImplicitALS

    train = StarMatrix(*(t.cpu().numpy() for t in data["train"]))
    init = (data["users"].cpu().numpy(), data["items"].cpu().numpy())
    out = {}
    for name, solver, dtype in (("cholesky", "cholesky", None), ("cg", "cg", None),
                                ("cholesky_bf16", "cholesky", "bfloat16"), ("cg_bf16", "cg", "bfloat16")):
        est = ImplicitALS(rank=RANK, reg_param=REG, alpha=ALPHA, max_iter=26, solver=solver, cg_steps=3,
                          init_factors=init, gather_dtype=dtype, device="cuda")
        est.fit(train)
        report = est.last_fit_report
        out[name] = report["device_s"]
        out[f"{name}_total"] = report["device_s"] + report.get("compile_s", 0.0)
    return out


def library(torch, src, idx, val, mask):
    """K1's yardstick: the gather, then two batched matrix products."""
    gathered = src[idx.long()].float()
    c1 = ALPHA * val
    corr = torch.bmm((gathered * c1[..., None]).transpose(1, 2), gathered)
    w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
    return corr, torch.bmm(w[:, None, :], gathered)[:, 0]


def kernel_ms_each(torch, fns, reps: int = REPS) -> list[float]:
    """The card's kernel ms of each of ``fns`` (a profiler session over
    ``reps`` rounds of all of them, each call inside its own
    ``record_function``, whose device time sums the kernels it launched).
    The profiler now and then records no kernel for some calls: a session
    with a call at 0 is run again (three tries), and zeros are returned for
    calls it never saw launch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for i, fn in enumerate(fns):
                    with record_function(f"group_{i}"):
                        fn()
            torch.cuda.synchronize()
        ms = [0.0] * len(fns)
        for e in prof.key_averages():
            if e.key.startswith("group_"):
                dev_us = getattr(e, "device_time_total", None)
                if dev_us is None:
                    dev_us = e.cuda_time_total
                ms[int(e.key.rsplit("_", 1)[1])] = dev_us / 1e3 / reps
        if all(ms):
            break
    return ms


def summarize(shapes, ms, n_sm: int) -> dict:
    """Per-group ms of one iteration's (rows, L) groups: the total, the
    five slowest groups as [rows, L, ms], and the share (and ms) of the
    groups with fewer rows than ``n_sm``, where a grid of one CTA per row
    would leave most of the card idle."""
    narrow = [i for i, (rows, _) in enumerate(shapes) if rows < n_sm]
    total = sum(ms)
    top = sorted(range(len(ms)), key=lambda i: -ms[i])[:5]
    return {"kernel_ms": total, "top": [[shapes[i][0], shapes[i][1], ms[i]] for i in top],
            "narrow_groups": len(narrow), "narrow_ms": sum(ms[i] for i in narrow),
            "narrow_share": sum(ms[i] for i in narrow) / total if total else None}


def _events_ms(torch, fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel(got, want, rows=None) -> float:
    """Max |got - want| over max |want| (over ``rows`` when given)."""
    if rows is not None:
        got, want = got[rows], want[rows]
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _timed_groups(torch, shapes, fns, n_sm: int) -> dict:
    """The card's kernel ms of each group's call, summarized, with the
    iteration's event ms."""
    ms = kernel_ms_each(torch, fns)
    return {**summarize(shapes, ms, n_sm), "per_group_ms": [[s[0], s[1], m] for s, m in zip(shapes, ms)],
            "events_ms": _events_ms(torch, lambda: [fn() for fn in fns])}


def time_groups(torch, data: dict) -> dict:
    """Each gather dtype's K1 per-group kernel ms, top five, narrow share,
    errors against the plain version, and iteration ms against the library;
    then K2 and K3 / K3-bf16 alike (``solve_corrected``, ``bucket_cg``,
    ``bucket_cg_bf16``)."""
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [tuple(c[1].shape) for c in data["calls"]]
    out = {}
    for dtype in (None, "bfloat16"):
        tables = {side: ops_als.gather_table(data[side], dtype) for side in ("users", "items")}
        calls = [(tables[side], idx, val, mask) for side, idx, val, mask, _ in data["calls"]]
        worst = 0.0
        for src, idx, val, mask in calls:
            got = ops_als.bucket_partial_terms(src, idx, val, mask, ALPHA, dtype)
            want = ops_als.bucket_partial_terms_reference(src, idx, val, mask, ALPHA, dtype)
            for a, b in zip(got, want):
                worst = max(worst, _rel(a, b))
        fns = [(lambda c=c: ops_als.bucket_partial_terms(*c, ALPHA, dtype)) for c in calls]
        wide_src = [(src.float(), idx, val, mask) for src, idx, val, mask in calls]
        out["float32" if dtype is None else dtype] = {
            "max_rel_err": worst,
            **_timed_groups(torch, shapes, fns, n_sm),
            "library_ms": _events_ms(torch, lambda: [library(torch, *c) for c in wide_src]),
        }

    other = {"users": "items", "items": "users"}
    yty = {side: ops_als.gramian(data[side]) for side in ("users", "items")}
    k2 = []
    for side, idx, val, mask, _ in data["calls"]:
        corr, b_vec = ops_als.bucket_partial_terms_reference(data[side], idx, val, mask, ALPHA)
        k2.append((yty[side], corr, b_vec, mask.sum(dim=1, dtype=torch.float32)))
    worst = max(_rel(ops_als.solve_corrected(*c, REG), ops_als.solve_corrected_reference(*c, REG), c[3] > 0)
                for c in k2)
    out["solve_corrected"] = {
        "max_rel_err": worst,
        **_timed_groups(torch, shapes, [(lambda c=c: ops_als.solve_corrected(*c, REG)) for c in k2], n_sm),
        "library_ms": _events_ms(torch, lambda: [ops_als.solve_corrected_reference(*c, REG) for c in k2]),
    }
    del k2
    for dtype in (None, "bfloat16"):
        tables = {side: ops_als.gather_table(data[side], dtype) for side in ("users", "items")}  # cast once
        k3 = [(tables[side], yty[side], idx, val, mask, data[other[side]][rows.clamp(min=0).long()].contiguous())
              for side, idx, val, mask, rows in data["calls"]]
        worst, over = 0.0, 0.0
        for c in k3:
            got = ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS, gather_dtype=dtype)
            want = ops_als.bucket_cg_reference(*c, REG, ALPHA, CG_STEPS, dtype)
            worst = max(worst, _rel(got, want))
            if dtype is not None and hasattr(ops_als, "bucket_cg_bf16_limits"):  # F9's row check (not in older trees)
                limits = ops_als.bucket_cg_bf16_limits(*c, REG, ALPHA, CG_STEPS)
                over = max(over, float(ops_als.bucket_cg_bf16_over(got, want, limits).max()))
        fns = [(lambda c=c: ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS, gather_dtype=dtype)) for c in k3]
        out["bucket_cg" if dtype is None else "bucket_cg_bf16"] = {
            "max_rel_err": worst, **({"over_limit": over} if dtype else {}),
            **_timed_groups(torch, shapes, fns, n_sm), "library_ms": None}
    return out


def _build_variants(source: str = "als_partials", variants: dict | None = None) -> dict:
    """Source variants of ``csrc/<source>.cu`` (default: K1's
    SOURCE_VARIANTS) built with nvcc: name -> loaded library."""
    import ctypes

    from albedo_tpu_torch.kernels import build

    variants = SOURCE_VARIANTS if variants is None else variants
    src = (build.CSRC / f"{source}.cu").read_text()
    work = build.BUILD_DIR / f"{source}_variants"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {source}.cu")
            text = text.replace(old, new)
        (work / f"v{i}.cu").write_text(text)
        procs[name] = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                        str(work / f"v{i}.so"), str(work / f"v{i}.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        # each kernel's registers and spills, for the record
        print(json.dumps({"variant": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                                      if "registers" in ln or "spill" in ln]}), file=sys.stderr)
    libs = {}
    for i, name in enumerate(variants):
        lib = ctypes.CDLL(str(work / f"v{i}.so"))
        fn = getattr(lib, f"{source}_launch")
        fn.argtypes = build.SIGNATURES[source]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variants(torch, data: dict) -> dict:
    """The float32 groups under each plan of PLAN_VARIANTS and each source
    of SOURCE_VARIANTS (default plan): kernel ms and narrow share."""
    from albedo_tpu_torch.kernels import build
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    calls = [(data[side], idx, val, mask) for side, idx, val, mask, _ in data["calls"]]
    shapes = [tuple(c[1].shape) for c in calls]
    saved = (ops_als.K1_UNITS_PER_SM, ops_als.K1_MIN_CHUNK, ops_als.K1_CTAS_PER_SM)
    out = {}
    try:
        for name, plan in PLAN_VARIANTS.items():
            ops_als.K1_UNITS_PER_SM, ops_als.K1_MIN_CHUNK, ops_als.K1_CTAS_PER_SM = plan
            ms = kernel_ms_each(torch, [(lambda c=c: ops_als.bucket_partial_terms(*c, ALPHA)) for c in calls])
            out[name] = {"plan": list(plan), **summarize(shapes, ms, n_sm)}
    finally:
        ops_als.K1_UNITS_PER_SM, ops_als.K1_MIN_CHUNK, ops_als.K1_CTAS_PER_SM = saved
    build.build()
    default = build._libs["als_partials"]
    try:
        for name, lib in _build_variants().items():
            build._libs["als_partials"] = lib  # the wrapper launches through the variant
            ms = kernel_ms_each(torch, [(lambda c=c: ops_als.bucket_partial_terms(*c, ALPHA)) for c in calls])
            out[name] = summarize(shapes, ms, n_sm)
    finally:
        build._libs["als_partials"] = default
    return out


def time_k2_variants(torch, data: dict) -> dict:
    """K2 over the bench groups (each group's plain K1 terms) under each
    source of K2_SOURCE_VARIANTS: kernel ms, narrow share, the slowest
    groups and the error against the plain version."""
    from albedo_tpu_torch.kernels import build
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    yty = {side: ops_als.gramian(data[side]) for side in ("users", "items")}
    calls = []
    for side, idx, val, mask, _ in data["calls"]:
        corr, b_vec = ops_als.bucket_partial_terms_reference(data[side], idx, val, mask, ALPHA)
        calls.append((yty[side], corr, b_vec, mask.sum(dim=1, dtype=torch.float32)))
    shapes = [tuple(c[1].shape[:1]) + (int(d[1].shape[1]),) for c, d in zip(calls, data["calls"])]
    want = [ops_als.solve_corrected_reference(*c, REG) for c in calls]
    build.build()
    default = build._libs["solve_corrected"]
    out = {}
    try:
        for name, lib in _build_variants("solve_corrected", K2_SOURCE_VARIANTS).items():
            build._libs["solve_corrected"] = lib
            err = max(_rel(ops_als.solve_corrected(*c, REG), w, c[3] > 0) for c, w in zip(calls, want))
            ms = kernel_ms_each(torch, [(lambda c=c: ops_als.solve_corrected(*c, REG)) for c in calls])
            out[name] = {"max_rel_err": err, **summarize(shapes, ms, n_sm)}
    finally:
        build._libs["solve_corrected"] = default
    return out


def time_k2_wide_variants(torch, data: dict) -> dict:
    """K2's wide path over the rank-100 fit's groups (each group's plain K1
    terms) under each source of K2_WIDE_VARIANTS: kernel ms, narrow share,
    the slowest groups and the error against the plain version."""
    from albedo_tpu_torch.kernels import build
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    yty = {side: ops_als.gramian(data[side]) for side in ("users", "items")}
    calls = []
    for side, idx, val, mask, _ in data["calls"]:
        corr, b_vec = ops_als.bucket_partial_terms_reference(data[side], idx, val, mask, ALPHA)
        calls.append((yty[side], corr, b_vec, mask.sum(dim=1, dtype=torch.float32)))
    shapes = [tuple(c[1].shape) for c in data["calls"]]
    want = [ops_als.solve_corrected_reference(*c, REG) for c in calls]
    build.build()
    default = build._libs["solve_corrected"]
    out = {}
    try:
        for name, lib in _build_variants("solve_corrected", K2_WIDE_VARIANTS).items():
            build._libs["solve_corrected"] = lib
            err = max(_rel(ops_als.solve_corrected(*c, REG), w, c[3] > 0) for c, w in zip(calls, want))
            ms = kernel_ms_each(torch, [(lambda c=c: ops_als.solve_corrected(*c, REG)) for c in calls])
            out[name] = {"max_rel_err": err, **summarize(shapes, ms, n_sm)}
    finally:
        build._libs["solve_corrected"] = default
    return out


def time_k3_variants(torch, data: dict) -> dict:
    """K3 and K3-bf16 over the bench groups under each K3_PACK_VARIANTS
    value of ops/als.py K3_PACK_L, then under plans whose widest cluster is
    each of K3_CLUSTER_VARIANTS, then each K3_SPREAD_VARIANTS value of
    K3_SPREAD: kernel ms, narrow share, the slowest groups and the error
    against the plain version."""
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    other = {"users": "items", "items": "users"}
    yty = {side: ops_als.gramian(data[side]) for side in ("users", "items")}
    shapes = [tuple(c[1].shape) for c in data["calls"]]
    saved = ops_als.K3_PACK_L, ops_als.k3_plan_for, ops_als.K3_SPREAD
    out = {}

    def timed(calls, want, dtype):
        err = max(_rel(ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS, gather_dtype=dtype), w)
                  for c, w in zip(calls, want))
        ms = kernel_ms_each(torch, [(lambda c=c: ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS,
                                                                         gather_dtype=dtype)) for c in calls])
        return {"max_rel_err": err, **summarize(shapes, ms, n_sm)}

    try:
        for dtype in (None, "bfloat16"):
            tables = {side: ops_als.gather_table(data[side], dtype) for side in ("users", "items")}
            calls = [(tables[side], yty[side], idx, val, mask, data[other[side]][rows.clamp(min=0).long()].contiguous())
                     for side, idx, val, mask, rows in data["calls"]]
            want = [ops_als.bucket_cg_reference(*c, REG, ALPHA, CG_STEPS, dtype) for c in calls]
            for pack in K3_PACK_VARIANTS:
                ops_als.K3_PACK_L = pack
                out[f"{dtype or 'float32'} pack {pack}"] = timed(calls, want, dtype)
            ops_als.K3_PACK_L = saved[0]
            for c_max in K3_CLUSTER_VARIANTS:
                ops_als.k3_plan_for = (lambda b, length, k, g, dev, c_max=c_max:
                                       ops_als._k3_plan(b, length, k, g is not None, n_sm, c_max))
                out[f"{dtype or 'float32'} clusters up to {c_max}"] = timed(calls, want, dtype)
            ops_als.k3_plan_for = saved[1]
            for spread in K3_SPREAD_VARIANTS:
                ops_als.K3_SPREAD = spread
                out[f"{dtype or 'float32'} spread over up to {spread}"] = timed(calls, want, dtype)
            ops_als.K3_SPREAD = saved[2]
    finally:
        ops_als.K3_PACK_L, ops_als.k3_plan_for, ops_als.K3_SPREAD = saved
    return out


# K3's wide plan variants (ranks 65-512): the shared bytes a warp-mode CTA
# may take (ops/als.py K3_WIDE_PACK_SMEM: three, two or one CTA an SM; 0
# leaves warp mode only rows of at most 4 slots) and the widest cluster a
# group of few rows is spread over (K3_WIDE_SPREAD).
K3W_PACK_VARIANTS = (0, 76 * 1024, 113 * 1024, 227 * 1024)
K3W_SPREAD_VARIANTS = (2, 4, 8, 16)


def time_k3_wide_variants(torch, data: dict) -> dict:
    """K3 and K3-bf16 over the rank-100 fit's groups under each
    K3W_PACK_VARIANTS value of ops/als.py K3_WIDE_PACK_SMEM, then each
    K3W_SPREAD_VARIANTS value of K3_WIDE_SPREAD: kernel ms, narrow share,
    the slowest groups and the error against the plain version."""
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [tuple(c[1].shape) for c in data["calls"]]
    saved = ops_als.K3_WIDE_PACK_SMEM, ops_als.K3_WIDE_SPREAD
    out = {}

    def timed(calls, want, dtype):
        err = max(_rel(ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS, gather_dtype=dtype), w)
                  for c, w in zip(calls, want))
        ms = kernel_ms_each(torch, [(lambda c=c: ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS,
                                                                         gather_dtype=dtype)) for c in calls])
        return {"max_rel_err": err, **summarize(shapes, ms, n_sm)}

    try:
        for dtype in (None, "bfloat16"):
            calls = _wide_k3_calls(torch, data, dtype)
            want = [ops_als.bucket_cg_reference(*c, REG, ALPHA, CG_STEPS, dtype) for c in calls]
            for pack in K3W_PACK_VARIANTS:
                ops_als.K3_WIDE_PACK_SMEM = pack
                out[f"{dtype or 'float32'} warp-mode CTA up to {pack} bytes"] = timed(calls, want, dtype)
            ops_als.K3_WIDE_PACK_SMEM = saved[0]
            for spread in K3W_SPREAD_VARIANTS:
                ops_als.K3_WIDE_SPREAD = spread
                out[f"{dtype or 'float32'} spread over up to {spread}"] = timed(calls, want, dtype)
            ops_als.K3_WIDE_SPREAD = saved[1]
    finally:
        ops_als.K3_WIDE_PACK_SMEM, ops_als.K3_WIDE_SPREAD = saved
    return out


K2_RANKS = (8, 16, 17, 24, 32, 33, 40, 50, 64)


def time_k2_ranks(torch) -> dict:
    """K2 alone at each rank of K2_RANKS on 65 536 random positive definite
    systems (YtY of a table of 4k + 40 rows, the Gramian of 8 random rows a
    system, reg 0.5 x 8): CUDA-event ms of a call over 5 calls, ns a system,
    and the max abs error against the plain version. Compares K2's rank
    classes (16, 32, 64: a class's code is unrolled to its width)."""
    from albedo_tpu_torch.ops import als as ops_als

    dev = torch.device("cuda")
    b, out = 65536, {}
    for k in K2_RANKS:
        g = torch.Generator(device=dev).manual_seed(k)
        yty = ops_als.gramian(torch.randn(4 * k + 40, k, device=dev, generator=g) / k ** 0.5)
        y = torch.randn(b, 8, k, device=dev, generator=g) / k ** 0.5
        args = (yty, torch.einsum("bli,blj->bij", y, y).contiguous(), torch.randn(b, k, device=dev, generator=g),
                torch.full((b,), 8.0, device=dev), REG)
        err = float((ops_als.solve_corrected(*args) - ops_als.solve_corrected_reference(*args)).abs().max())
        ms = _events_ms(torch, lambda: ops_als.solve_corrected(*args), reps=5)
        out[str(k)] = {"ms": ms, "ns_per_system": ms * 1e6 / b, "max_abs_err": err}
    return out


def time_orders(torch, data: dict, proxies: int = 8, seed: int = 1) -> dict:
    """F9's row limits (``ops.als.bucket_cg_bf16_limits``) against further
    orders of the sums at the bench groups' K3-bf16 calls of 300 slots and
    more, where the roundings flip: ``proxies`` random orders of each
    group's entries and columns (``ops.als._k3_reorders``, seeded ``seed`` +
    L), each row's max |reordered - plain| over its limit: the worst share,
    the rows over 1 and the row trials, and the largest limit as a share of
    its group's max |x|. Runs the plain version only: on the card or the CPU."""
    from albedo_tpu_torch.ops import als as ops_als

    other = {"users": "items", "items": "users"}
    worst, over, trials, widest = 0.0, 0, 0, 0.0
    for side, idx, val, mask, rows in data["calls"]:
        if idx.shape[1] < 300:
            continue
        src = data[side]
        call = (src, ops_als.gramian(src), idx, val, mask, data[other[side]][rows.clamp(min=0).long()].contiguous(),
                REG, ALPHA, CG_STEPS)
        live = rows >= 0
        want = ops_als.bucket_cg_bf16_reordered(*call)
        limit = ops_als.bucket_cg_bf16_limits(*call, rows=live)[live]
        widest = max(widest, float(limit.max()) / float(want[live].abs().max()))
        orders = list(ops_als._k3_reorders(mask, src.shape[1], torch.Generator().manual_seed(seed + idx.shape[1]),
                                           proxies + 2))[2:]  # shuffles only
        for src_pos, cols in orders:
            moved = (ops_als.bucket_cg_bf16_reordered(*call, src_pos, cols) - want).abs().amax(dim=1)[live]
            worst = max(worst, float((moved / limit).max()))
            over += int((moved > limit).sum())
        trials += proxies * int(live.sum())
    return {"seed": seed, "worst": worst, "rows_over": over, "row_trials": trials,
            "widest_limit_share": widest}


WIDE_DATA = Path("build") / "bench" / "als_wide_groups.pt"
WIDE_RANK, WIDE_SEED = 100, 1  # chip_smoke.py's wide_rank phase: rank 100 from its shared numpy init


def wide_data(torch, dev) -> dict:
    """The rank-100 fit's groups (``ImplicitALS(rank=100).device_groups``
    of the ``train_als`` job's tables, the shapes of ``WIDE_GROUPS``)
    flattened to (N B, L), and tables from the shared numpy init at rank 100
    (``builders.jobs.shared_als_init``, seed 1, as chip_smoke.py's), on
    ``dev``."""
    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import JobContext, shared_als_init
    from albedo_tpu_torch.models.als import ImplicitALS

    matrix = JobContext(cli.parse_args(["train_als", "--device", "cpu"])).matrix()
    u0, v0 = shared_als_init(matrix.n_users, matrix.n_items, WIDE_RANK, WIDE_SEED)
    ug, ig, _, _ = ImplicitALS(rank=WIDE_RANK, device=str(dev)).device_groups(matrix)
    calls = []
    for side, groups in (("users", ig), ("items", ug)):
        for g in groups:
            n, b, length = g.idx.shape
            calls.append((side, *(t.reshape(n * b, length).contiguous() for t in (g.idx, g.val, g.mask)),
                          g.row_ids.reshape(-1).contiguous()))
    job = [torch.as_tensor(a) for a in (matrix.user_ids, matrix.item_ids, matrix.rows, matrix.cols, matrix.vals)]
    return {"users": torch.as_tensor(u0, device=dev), "items": torch.as_tensor(v0, device=dev), "calls": calls,
            "job": job}


def time_wide_fits(torch, data: dict) -> dict:
    """The rank-100 fit's device seconds (26 iterations from the shared
    init, as chip_smoke.py's ``wide_rank`` fits it: ``fit_s`` by Cholesky,
    ``cg_fit_s`` by 3-step CG; two fits each) and the wall seconds of the
    real cv_als grid (13 iterations, 2 folds, every fit from the shared
    numpy init of its rank, as chip_smoke.py's ``cv`` phase runs it:
    ``grid_s`` by Cholesky, ``cg_grid_s`` by CG; two runs each).
    ``fit_total_s`` and ``cg_fit_total_s`` add each fit's graph capture
    (``compile_s``; a tree without it counts 0) to its device seconds."""
    from albedo_tpu_torch.builders.jobs import CV_ALS_TABLES_GRID, cv_als_evaluate, shared_als_init
    from albedo_tpu_torch.cv import cross_validate, param_grid
    from albedo_tpu_torch.datasets.star_matrix import StarMatrix
    from albedo_tpu_torch.models.als import ImplicitALS

    matrix = StarMatrix(*(t.cpu().numpy() for t in data["job"]))
    init = (data["users"].cpu().numpy(), data["items"].cpu().numpy())
    out = {}
    for solver, fit_key, grid_key in (("cholesky", "fit_s", "grid_s"), ("cg", "cg_fit_s", "cg_grid_s")):
        fits, totals = [], []
        for _ in range(2):
            est = ImplicitALS(rank=WIDE_RANK, max_iter=26, init_factors=init, solver=solver, device="cuda")
            est.fit(matrix)
            fits.append(est.last_fit_report["device_s"])
            totals.append(fits[-1] + est.last_fit_report.get("compile_s", 0.0))

        def fit(params, train, solver=solver):
            return ImplicitALS(max_iter=13, init_factors=shared_als_init(train.n_users, train.n_items,
                                                                         params["rank"], WIDE_SEED),
                               solver=solver, device="cuda", **params).fit(train)

        grids = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cross_validate(fit, cv_als_evaluate, matrix, param_grid(**CV_ALS_TABLES_GRID), n_folds=2)
            torch.cuda.synchronize()
            grids.append(time.perf_counter() - t0)
        out.update({fit_key: fits, fit_key.replace("fit_s", "fit_total_s"): totals, grid_key: grids})
    return out


def _wide_k3_calls(torch, data: dict, dtype) -> list[tuple]:
    """K3's calls over the rank-100 fit's groups: (fixed side's table as
    gathered, its YtY, idx, val, mask, x0 from the other side's rows)."""
    from albedo_tpu_torch.ops import als as ops_als

    other = {"users": "items", "items": "users"}
    yty = {side: ops_als.gramian(data[side]) for side in other}
    tables = {side: ops_als.gather_table(data[side], dtype) for side in other}
    return [(tables[side], yty[side], idx, val, mask, data[other[side]][rows.clamp(min=0).long()].contiguous())
            for side, idx, val, mask, rows in data["calls"]]


def time_wide_k3(torch, data: dict) -> dict:
    """K3 wide and K3-bf16 wide over the rank-100 fit's groups (3 steps, the
    bench's reg and alpha): each held against its plain version (max rel
    error over the rows that are not padding; K3-bf16 also row by row to
    F9's limits, ``over_limit`` the worst row's share of its limit), the
    same bits on a second call, and timed as ``time_wide`` times K1 and K2
    (the plain version's events ms as ``plain_ms``; K3 has no library
    call); ``plan_us`` is the host's microseconds to make a group's plan
    (``ops.als.k3_plan_for``), the mean over 20 passes of the groups."""
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [tuple(c[1].shape) for c in data["calls"]]
    out = {}
    for dtype in (None, "bfloat16"):
        calls = _wide_k3_calls(torch, data, dtype)
        worst, over, same = 0.0, 0.0, True
        for c, (_, _, _, _, rows) in zip(calls, data["calls"]):
            got = ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS, gather_dtype=dtype)
            same &= torch.equal(got, ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS, gather_dtype=dtype))
            want = ops_als.bucket_cg_reference(*c, REG, ALPHA, CG_STEPS, dtype)
            live = rows >= 0
            worst = max(worst, _rel(got, want, live))
            if dtype is not None:
                limits = ops_als.bucket_cg_bf16_limits(*c, REG, ALPHA, CG_STEPS, rows=live)
                over = max(over, float(ops_als.bucket_cg_bf16_over(got[live], want[live], limits[live]).max()))
        fns = [(lambda c=c: ops_als.bucket_cg_body(*c, REG, ALPHA, CG_STEPS, gather_dtype=dtype)) for c in calls]
        dev, k = calls[0][0].device, calls[0][0].shape[1]
        t0 = time.perf_counter()
        for _ in range(20):
            for shape in shapes:
                ops_als.k3_plan_for(*shape, k, dtype, dev)
        plan_us = (time.perf_counter() - t0) / (20 * len(shapes)) * 1e6
        out["bucket_cg_wide" if dtype is None else "bucket_cg_bf16_wide"] = {
            "max_rel_err": worst, "same_bits": same, **({"over_limit": over} if dtype else {}), "plan_us": plan_us,
            **_timed_groups(torch, shapes, fns, n_sm),
            "plain_ms": _events_ms(torch, lambda: [ops_als.bucket_cg_reference(*c, REG, ALPHA, CG_STEPS, dtype)
                                                   for c in calls]),
            "library_ms": None}
    return out


def time_wide(torch, data: dict) -> dict:
    """K1 wide, K1-bf16 wide and K2 wide over the rank-100 fit's groups:
    each held against its plain version (max rel error over the rows that
    are not padding, the same bits on a second call), each group's kernel
    ms (profiler sums), the iteration's kernel ms, ``narrow_share``, the
    five slowest groups and CUDA-event ms of the iteration's calls."""
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [tuple(c[1].shape) for c in data["calls"]]
    out = {}
    for dtype in (None, "bfloat16"):
        tables = {side: ops_als.gather_table(data[side], dtype) for side in ("users", "items")}
        calls = [(tables[side], idx, val, mask) for side, idx, val, mask, _ in data["calls"]]
        worst, same = 0.0, True
        for src, idx, val, mask in calls:
            got = ops_als.bucket_partial_terms(src, idx, val, mask, ALPHA, dtype)
            again = ops_als.bucket_partial_terms(src, idx, val, mask, ALPHA, dtype)
            want = ops_als.bucket_partial_terms_reference(src, idx, val, mask, ALPHA, dtype)
            worst = max([worst] + [_rel(a, b) for a, b in zip(got, want)])
            same &= all(torch.equal(a, b) for a, b in zip(got, again))
        fns = [(lambda c=c: ops_als.bucket_partial_terms(*c, ALPHA, dtype)) for c in calls]
        out["als_partials_wide" if dtype is None else "als_partials_bf16_wide"] = {
            "max_rel_err": worst, "same_bits": same, **_timed_groups(torch, shapes, fns, n_sm)}
    yty = {side: ops_als.gramian(data[side]) for side in ("users", "items")}
    k2 = []
    for side, idx, val, mask, _ in data["calls"]:
        corr, b_vec = ops_als.bucket_partial_terms_reference(data[side], idx, val, mask, ALPHA)
        k2.append((yty[side], corr, b_vec, mask.sum(dim=1, dtype=torch.float32)))
    worst, same = 0.0, True
    for c in k2:
        got = ops_als.solve_corrected(*c, REG)
        same &= torch.equal(got, ops_als.solve_corrected(*c, REG))
        worst = max(worst, _rel(got, ops_als.solve_corrected_reference(*c, REG), c[3] > 0))
    out["solve_corrected_wide"] = {
        "max_rel_err": worst, "same_bits": same,
        **_timed_groups(torch, shapes, [(lambda c=c: ops_als.solve_corrected(*c, REG)) for c in k2], n_sm),
        "library_ms": _events_ms(torch, lambda: [ops_als.solve_corrected_reference(*c, REG) for c in k2])}
    return out


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv: list[str]) -> int:
    import torch

    if argv[:1] == ["orders"]:  # the plain version only: on the card, else the CPU
        dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
        seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 1
        print(json.dumps({"mode": "orders", "device": str(dev), **time_orders(torch, bench_data(torch, dev), seed=seed)}))
        return 0
    if not torch.cuda.is_available():
        print("als_partials_bench: needs a GPU", file=sys.stderr)
        return 1
    if not argv or argv[0] not in ("groups", "time", "variants", "ranks", "wide", "time_wide"):
        print("usage: als_partials_bench groups [--against ROOT] | wide [--against ROOT] | variants [k2|k3|k1w|k2w|k3w] | "
              "ranks | orders [--seed N]", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if argv[0] in ("wide", "time_wide"):
        return main_wide(torch, dev, argv)
    if argv[0] == "ranks":
        print(json.dumps({"mode": "ranks", "card": _card(), **time_k2_ranks(torch)}), flush=True)
        return 0
    if argv[0] == "time":  # a child of --against: ``time ROOT DATA``, importing ROOT's package
        root, path = argv[1], argv[2]
        sys.path.insert(0, root)
        data = torch.load(path, map_location=dev)
        print(json.dumps({"root": root, **time_groups(torch, data), "fit_s": time_fits(data)}), flush=True)
        return 0
    if argv[0] == "variants":
        which = argv[1] if len(argv) > 1 else "k1"
        data = wide_data(torch, dev) if which in ("k1w", "k2w", "k3w") else bench_data(torch, dev)
        timed = {"k1": time_variants, "k2": time_k2_variants, "k3": time_k3_variants, "k1w": time_variants,
                 "k2w": time_k2_wide_variants, "k3w": time_k3_wide_variants}[which](torch, data)
        print(json.dumps({"mode": f"variants {which}", "card": _card(), **timed}), flush=True)
        return 0
    data = bench_data(torch, dev)
    if "--against" not in argv:
        print(json.dumps({"mode": "groups", "card": _card(), **time_groups(torch, data)}), flush=True)
        return 0
    other = str(Path(argv[argv.index("--against") + 1]).resolve())
    here = str(Path(__file__).resolve().parents[2])
    DATA.parent.mkdir(parents=True, exist_ok=True)
    torch.save(data, DATA)
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "time", root, str(DATA.resolve())],
                              cwd=root, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {
        name: {key: [r[name][key] for r in runs] for key in ("kernel_ms", "narrow_share", "events_ms",
                                                             "library_ms", "max_rel_err")}
        for name in ("float32", "bfloat16", "solve_corrected", "bucket_cg", "bucket_cg_bf16")
    }
    summary["fit_s"] = {name: [r["fit_s"][name] for r in runs] for name in runs[0]["fit_s"]}
    print(json.dumps({"mode": "groups", "card": _card(), "order": [other, here, here, other], **summary}), flush=True)
    return 0


def main_wide(torch, dev, argv: list[str]) -> int:
    """``wide [--against ROOT]`` and its child ``time_wide ROOT DATA``."""
    if argv[0] == "time_wide":  # a child of --against, importing ROOT's package
        root, path = argv[1], argv[2]
        sys.path.insert(0, root)
        data = torch.load(path, map_location=dev)
        print(json.dumps({"root": root, **time_wide(torch, data), **time_wide_k3(torch, data),
                          **time_wide_fits(torch, data)}), flush=True)
        return 0
    data = wide_data(torch, dev)
    if "--against" not in argv:
        print(json.dumps({"mode": "wide", "card": _card(), **time_wide(torch, data), **time_wide_k3(torch, data),
                          **time_wide_fits(torch, data)}), flush=True)
        return 0
    other = str(Path(argv[argv.index("--against") + 1]).resolve())
    here = str(Path(__file__).resolve().parents[2])
    WIDE_DATA.parent.mkdir(parents=True, exist_ok=True)
    torch.save(data, WIDE_DATA)
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "time_wide", root,
                               str(WIDE_DATA.resolve())], cwd=root, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {name: {key: [r[name].get(key) for r in runs]
                      for key in ("kernel_ms", "narrow_share", "events_ms", "max_rel_err", "same_bits", "over_limit",
                                  "plain_ms")}
               for name in ("als_partials_wide", "als_partials_bf16_wide", "solve_corrected_wide", "bucket_cg_wide",
                            "bucket_cg_bf16_wide")}
    summary.update({key: [r[key][1] for r in runs]
                    for key in ("fit_s", "fit_total_s", "grid_s", "cg_fit_s", "cg_fit_total_s", "cg_grid_s")})
    print(json.dumps({"mode": "wide", "card": _card(), "order": [other, here, here, other], **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
