"""K1/K1-bf16 timings on the card beyond ``chip_smoke.py``'s: every bucket
group of one iteration of the bench ALS fit, group by group.

    python -m albedo_tpu_torch.kernels.als_partials_bench groups
    python -m albedo_tpu_torch.kernels.als_partials_bench groups --against /path/to/other/root
    python -m albedo_tpu_torch.kernels.als_partials_bench variants

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
products). With ``--against ROOT`` the groups, tables and the train split
are saved under ``build/bench/`` and each tree times them, and the bench
fit's device seconds (Cholesky, CG-3, Cholesky at bf16 gathers, 26
iterations from the pinned init), in a process of its own,
importing its own package (and building its own kernels), in the order
ROOT, this tree, this tree, ROOT: the parent-against-change comparison of
one card. ``variants``: the float32 groups' kernel ms and ``narrow_share``
under other plans of the split design (``PLAN_VARIANTS``: units aimed at an
SM, the shortest chunk, CTAs an SM for packed rows) and through copies of
its source with a part cut out (``SOURCE_VARIANTS``). Prints one JSON line
(``--against``: each tree's, then the comparison). Needs a GPU; the CPU has
nothing to measure here.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
ALPHA, RANK, REPS = 40.0, 50, 5
# name -> (K1_UNITS_PER_SM, K1_MIN_CHUNK, K1_CTAS_PER_SM) of ops/als.py.
# Source variants of csrc/als_partials.cu (text replaced, built beside the
# package's build; their answers are not K1's): "no products" skips the FMA
# loop (what is left is staging, synchronization and the output), "no row
# copy" skips the coalesced copy of each unsplit row's output from shared
# memory to the card's memory.
SOURCE_VARIANTS = {
    "no products": [("    if (active) {\n      const float* yb", "    if (active && nl < 0) {\n      const float* yb")],
    "no row copy": [("e < k * k / 4; e += blockDim.x)", "e < 0; e += blockDim.x)"),
                    ("e < k * k; e += blockDim.x) out[e] = so[e];", "e < 0; e += blockDim.x) out[e] = so[e];")],
}
PLAN_VARIANTS = {"default": (8, 64, 16), "units 4, ctas 8": (4, 64, 8), "units 2, ctas 8": (2, 64, 8),
                 "units 4, ctas 16": (4, 64, 16), "units 8, ctas 8": (8, 64, 8), "chunk 128": (8, 128, 16),
                 "chunk 32": (8, 32, 16), "ctas 4": (8, 64, 4)}
DATA = Path("build") / "bench" / "als_partials_groups.pt"


def bench_data(torch, dev) -> dict:
    """The bench split's groups (flattened to (N B, L)) and the pinned
    rank-50 tables, on ``dev``: calls [(source side, idx, val, mask)]."""
    from albedo_tpu_torch.datasets import random_split_by_user
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars
    from albedo_tpu_torch.models.als import ImplicitALS

    matrix = synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)
    train, _ = random_split_by_user(matrix, test_ratio=0.1, seed=42)
    rng = np.random.default_rng(42)
    s = np.float32(1 / np.sqrt(RANK))
    u0 = (rng.standard_normal((train.n_users, RANK)) * s).astype(np.float32)
    v0 = (rng.standard_normal((train.n_items, RANK)) * s).astype(np.float32)
    ug, ig, _, _ = ImplicitALS(rank=RANK, device="cuda").device_groups(train)
    calls = []
    for side, groups in (("users", ig), ("items", ug)):  # the fixed side each half-sweep gathers
        for g in groups:
            n, b, length = g.idx.shape
            calls.append((side, *(t.reshape(n * b, length).contiguous() for t in (g.idx, g.val, g.mask))))
    split = [torch.as_tensor(a) for a in (train.user_ids, train.item_ids, train.rows, train.cols, train.vals)]
    return {"users": torch.as_tensor(u0, device=dev), "items": torch.as_tensor(v0, device=dev), "calls": calls,
            "train": split}


def time_fits(data: dict) -> dict:
    """The bench fit's device seconds (rank 50, 26 iterations, reg 0.5,
    alpha 40, from the pinned init), Cholesky, CG-3 and Cholesky at bf16
    gathers, as ``chip_smoke.py``'s bench phases fit it."""
    from albedo_tpu_torch.datasets.star_matrix import StarMatrix
    from albedo_tpu_torch.models.als import ImplicitALS

    train = StarMatrix(*(t.cpu().numpy() for t in data["train"]))
    init = (data["users"].cpu().numpy(), data["items"].cpu().numpy())
    out = {}
    for name, solver, dtype in (("cholesky", "cholesky", None), ("cg", "cg", None),
                                ("cholesky_bf16", "cholesky", "bfloat16")):
        est = ImplicitALS(rank=RANK, reg_param=0.5, alpha=ALPHA, max_iter=26, solver=solver, cg_steps=3,
                          init_factors=init, gather_dtype=dtype, device="cuda")
        est.fit(train)
        out[name] = est.last_fit_report["device_s"]
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


def time_groups(torch, data: dict) -> dict:
    """Each gather dtype's per-group kernel ms, top five, narrow share,
    errors against the plain version, and iteration ms against the library."""
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype in (None, "bfloat16"):
        tables = {side: ops_als.gather_table(data[side], dtype) for side in ("users", "items")}
        calls = [(tables[side], idx, val, mask) for side, idx, val, mask in data["calls"]]
        worst = 0.0
        for src, idx, val, mask in calls:
            got = ops_als.bucket_partial_terms(src, idx, val, mask, ALPHA, dtype)
            want = ops_als.bucket_partial_terms_reference(src, idx, val, mask, ALPHA, dtype)
            for a, b in zip(got, want):
                worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        fns = [(lambda c=c: ops_als.bucket_partial_terms(*c, ALPHA, dtype)) for c in calls]
        ms = kernel_ms_each(torch, fns)
        shapes = [tuple(c[1].shape) for c in calls]
        wide_src = [(src.float(), idx, val, mask) for src, idx, val, mask in calls]
        out["float32" if dtype is None else dtype] = {
            "max_rel_err": worst,
            **summarize(shapes, ms, n_sm),
            "per_group_ms": [[s[0], s[1], m] for s, m in zip(shapes, ms)],
            "events_ms": _events_ms(torch, lambda: [fn() for fn in fns]),
            "library_ms": _events_ms(torch, lambda: [library(torch, *c) for c in wide_src]),
        }
    return out


def _build_variants() -> dict:
    """SOURCE_VARIANTS built with nvcc: name -> loaded library."""
    import ctypes

    from albedo_tpu_torch.kernels import build

    src = (build.CSRC / "als_partials.cu").read_text()
    work = build.BUILD_DIR / "als_variants"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(SOURCE_VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in als_partials.cu")
            text = text.replace(old, new)
        (work / f"v{i}.cu").write_text(text)
        procs[name] = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(work / f"v{i}.so"),
                                        str(work / f"v{i}.cu")])
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("nvcc failed for a variant")
    libs = {}
    for i, name in enumerate(SOURCE_VARIANTS):
        lib = ctypes.CDLL(str(work / f"v{i}.so"))
        lib.als_partials_launch.argtypes = build.SIGNATURES["als_partials"]
        lib.als_partials_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variants(torch, data: dict) -> dict:
    """The float32 groups under each plan of PLAN_VARIANTS and each source
    of SOURCE_VARIANTS (default plan): kernel ms and narrow share."""
    from albedo_tpu_torch.kernels import build
    from albedo_tpu_torch.ops import als as ops_als

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    calls = [(data[side], idx, val, mask) for side, idx, val, mask in data["calls"]]
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


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("als_partials_bench: needs a GPU", file=sys.stderr)
        return 1
    if not argv or argv[0] not in ("groups", "time", "variants"):
        print("usage: als_partials_bench groups [--against ROOT] | variants", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if argv[0] == "time":  # a child of --against: ``time ROOT DATA``, importing ROOT's package
        root, path = argv[1], argv[2]
        sys.path.insert(0, root)
        data = torch.load(path, map_location=dev)
        print(json.dumps({"root": root, **time_groups(torch, data), "fit_s": time_fits(data)}), flush=True)
        return 0
    data = bench_data(torch, dev)
    if argv[0] == "variants":
        print(json.dumps({"mode": "variants", "card": _card(), **time_variants(torch, data)}), flush=True)
        return 0
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
        dtype: {key: [r[dtype][key] for r in runs] for key in ("kernel_ms", "narrow_share", "events_ms",
                                                               "library_ms", "max_rel_err")}
        for dtype in ("float32", "bfloat16")
    }
    summary["fit_s"] = {name: [r["fit_s"][name] for r in runs] for name in runs[0]["fit_s"]}
    print(json.dumps({"mode": "groups", "card": _card(), "order": [other, here, here, other], **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
