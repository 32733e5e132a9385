"""K5/K14 timings on the card beyond ``chip_smoke.py``'s, and the edge cases
K5's split design must get right.

    python -m albedo_tpu_torch.kernels.topk_bench calls
    python -m albedo_tpu_torch.kernels.topk_bench variants
    python /path/to/topk_bench.py calls     # from any checkout's root
    python -m albedo_tpu_torch.kernels.topk_bench streaming

``calls``: K5 (``ops.topk.topk_scores``) at the shapes of ``CALLS`` (the
bench's 500 users at k 30 and 512, the ``train_als`` and ``ranking_mf``
jobs' test users, one user against the job's catalogue, and K14's content
and tf-idf queries), on factor tables made from a numpy seed at each call's
shape, with exclusion rows of the width the jobs give. Each call is first
held exactly against its plain version, then timed: CUDA-event ms (host
launch path included), the card's kernel ms (``torch.profiler``, also
kernel by kernel), the host's ms to enqueue a call, and the library
yardstick (``torch.topk`` of the masked ``Q @ V^T``) by events and kernel
time, beside the call's bounds (bytes over 3.35 TB/s; FLOP over 67 TFLOP/s, and
over half that without FMA, which K5's arithmetic forbids). It imports the
package from the working directory and calls only ``topk_scores``, so
running it from two checkouts on one card compares them. ``variants``: the
same calls through other plans of the current kernel (item tile 32 or 128,
splits for 0.5 to 4 waves of CTAs) and through copies of its source
(``SOURCE_VARIANTS``: the selection cut out, the sorting network for every
candidate batch, 128 columns a step), kernel ms only. ``streaming``: the
calls of the streaming body (``STREAMING``: K11's masked_topk, K6, K7) held
exactly and timed (kernel and event ms), also importing from the working
directory. Each mode prints one JSON line. Needs a GPU; the CPU has nothing
to measure here.
"""

from __future__ import annotations

import json
import sys

import numpy as np

PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12

# name -> (rows, items, rank, k, exclusion width): the K5/K14 calls of
# PERF.md's kernel table (chip_smoke.py records them at the jobs' inputs).
CALLS = {
    "K5 bench k30": (500, 19991, 50, 30, 662),
    "K5 bench k512": (500, 19991, 50, 512, 1533),
    "K5 train_als": (250, 2936, 50, 30, 0),
    "K5 ranking_mf": (250, 2936, 33, 30, 209),
    "K5 one row": (1, 2936, 50, 30, 60),
    "K14 content": (100, 2936, 200, 30, 30),
    "K14 tfidf row": (1, 2936, 3010, 11, 0),
}
VARIANT_TILES, VARIANT_WAVES = (32, 128), (0.5, 1, 2, 4)


def call_inputs(rows: int, items: int, r: int, k: int, width: int, seed: int = 0):
    """numpy (queries, items, k, exclusions or None) of one call: rows of
    N(0, 1/r); K14's wide rows are nonnegative and L2-normalized, as tf-idf
    and document vectors are; each exclusion row lists up to ``width``
    distinct items, -1-padded."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((rows, r)) / np.sqrt(r)).astype(np.float32)
    v = (rng.standard_normal((items, r)) / np.sqrt(r)).astype(np.float32)
    if r > 64:
        q, v = (np.abs(a) / np.linalg.norm(a, axis=1, keepdims=True) for a in (q, v))
    ex = None
    if width:
        ex = np.full((rows, width), -1, dtype=np.int32)
        for u in range(rows):
            n = width if u == 0 else int(rng.integers(0, width + 1))
            ex[u, :n] = rng.choice(items, size=n, replace=False)
    return q.astype(np.float32), v.astype(np.float32), k, ex


def k5_edge_cases(seed: int = 0) -> list[tuple]:
    """(label, queries, items, k, exclusions or None) numpy cases: ties
    planted across every 32-item boundary (so across any tile and split)
    and across the 1024-item mark, a query row of zeros (every score ties at
    +0), scores that cancel to 0 beside negative and positive ones, NaN and
    +-inf scores, exclusion rows with -1, out-of-range entries and
    duplicates, a row excluding every item, fewer admissible items than k,
    a row whose first-pass floor admits every item, one row and 500 rows,
    ranks 1 to 3010."""
    rng = np.random.default_rng(seed)

    def factors(n, r):
        return (rng.standard_normal((n, r)) / np.sqrt(r)).astype(np.float32)

    def exclusions(rows, items, width):
        ex = np.full((rows, width), -1, dtype=np.int32)
        ex[:, : width - 10] = rng.integers(0, items, size=(rows, width - 10))
        ex[:, width - 10] = ex[:, 0]          # a duplicate
        ex[:, width - 9] = -7                 # out of range, below
        ex[:, width - 8] = items + 5          # out of range, above
        ex[:, width - 7] = 2**31 - 1
        return ex

    cases = []
    for r in (1, 50, 65, 3010):
        items = 3000 if r < 3010 else 2936
        v = factors(items, r)
        v[32::32] = v[31:-1:32][: len(v[32::32])]   # item 32m ties item 32m - 1
        v[1024:1124] = v[:100]
        u = factors(37, r)
        u[0] = 0.0                                 # every score ties at +0
        ex = exclusions(37, items, 120)
        ex[5, :] = -1
        for k in (1, 30, 129, 512):
            cases.append((f"r={r}, k={k}, ties across boundaries, exclusions", u, v, k, ex))
            cases.append((f"r={r}, k={k}, one row", u[1:2], v, k, ex[1:2]))
        cases.append((f"r={r}, k=50, no exclusion", u, v, 50, None))
    # Scores of 0 from cancelling products (u = e0 - e1 against rows with
    # v0 = v1), beside positive and negative scores; NaN and +-inf.
    v = factors(2000, 16)
    v[::3, 1] = v[::3, 0]
    v[7, 2], v[900, 5], v[901, 5] = np.nan, np.nan, np.nan
    v[40, 3], v[1500, 3], v[41, 4] = np.inf, np.inf, -np.inf
    u = np.zeros((6, 16), dtype=np.float32)
    u[:, 0], u[:, 1] = 1.0, -1.0
    u[1, 3:6] = (0.5, -0.25, 1.0)
    u[2, 4] = 1.0
    u[3, 3] = -2.0
    u[4] = factors(1, 16)[0]
    for k in (10, 30, 512):
        cases.append((f"zeros, NaN, +-inf, k={k}", u, v, k, None))
        cases.append((f"zeros, NaN, +-inf, k={k}, exclusions", u, v, k, exclusions(6, 2000, 40)))
    # A row excluding every item; fewer admissible items than k.
    v = factors(600, 50)
    u = factors(9, 50)
    ex = np.tile(np.arange(200, dtype=np.int32), (9, 1))
    ex = np.concatenate([ex, np.full((9, 400), -1, np.int32)], axis=1)
    ex[2, :] = np.arange(600)
    ex[3, 200:] = 599 - np.arange(400)
    for k in (30, 400, 512):
        cases.append((f"all excluded, 400 admissible of 600, k={k}", u, v, k, ex))
    # 500 rows, the bench catalogue's width, all three list sizes. Row 7
    # scores items 0-1999 at -50 (its first-pass floor falls that low, so
    # above k = 32 every item of a split is kept and the slots overflow
    # into sorted lists).
    v = factors(19991, 50)
    v[5000:5400] = v[:400]
    v[:2000, 0] = -50.0
    u = factors(500, 50)
    u[:, 0] = 0.0
    u[7] = 0.0
    u[7, 0] = 1.0
    ex = exclusions(500, 19991, 700)
    for k in (30, 129, 512):
        cases.append((f"500 x 19991, k={k}, a row of low scores", u, v, k, ex))
    return cases


def same(torch, got, want) -> bool:
    """Indices equal; scores equal bit for bit, NaN where NaN."""
    (s, i), (s_p, i_p) = got, want
    nan, nan_p = torch.isnan(s), torch.isnan(s_p)
    return (bool(torch.equal(i, i_p)) and bool(torch.equal(nan, nan_p))
            and bool(torch.equal(torch.where(nan, 0.0, s), torch.where(nan_p, 0.0, s_p))))


def library(torch, q, v, k, ex):
    """The yardstick: the masked score matrix, then ``torch.topk``."""
    scores = q @ v.T
    if ex is not None:
        ex_l = torch.where((ex < 0) | (ex >= v.shape[0]), v.shape[0], ex.long())
        hit = torch.zeros((q.shape[0], v.shape[0] + 1), dtype=torch.bool, device=q.device)
        hit.scatter_(1, ex_l, True)
        scores = scores.masked_fill(hit[:, :-1], float("-inf"))
    return torch.topk(scores, k, dim=1)


def _events_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(torch, fn, reps: int = 20) -> float:
    """Host milliseconds to enqueue one call (the card's queue absorbs
    ``reps`` calls without blocking)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def _kernel_ms(torch, fn, reps: int = 20, by_name: bool = False):
    """The card's kernel milliseconds a run of ``fn`` (profiler, ``reps``
    runs); with ``by_name``, also each kernel's, by its name and template
    arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names: dict[str, float] = {}
    for _ in range(3):  # the profiler now and then records no kernel: try again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.key_averages():
            if e.device_type == cuda:
                name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")[:48]
                names[name] = names.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
        if names:
            break
    total = sum(names.values())
    return (total, names) if by_name else total


def _device_calls(torch, dev) -> dict:
    out = {}
    for name, shape in CALLS.items():
        q, v, k, ex = call_inputs(*shape)
        out[name] = (torch.as_tensor(q, device=dev), torch.as_tensor(v, device=dev), k,
                     None if ex is None else torch.as_tensor(ex, device=dev))
    return out


def bounds(q, v, k, ex) -> dict:
    """The call's least times on an H100 (ms): bytes (inputs read once,
    outputs written once), FLOP at the FP32 peak, and at half of it (no FMA)."""
    n_bytes = 4 * (q.numel() + v.numel() + (0 if ex is None else ex.numel())) + 8 * q.shape[0] * k
    flops = 2 * q.shape[0] * v.shape[0] * q.shape[1]
    return {"bytes_ms": n_bytes / PEAK_BYTES * 1e3, "ops_ms": flops / PEAK_FP32 * 1e3,
            "ops_no_fma_ms": 2 * flops / PEAK_FP32 * 1e3}


def mode_calls(torch) -> dict:
    sys.path.insert(0, ".")  # the checkout this runs from, not the script's
    from albedo_tpu_torch.ops import topk

    dev = torch.device("cuda", 0)
    out = {}
    for name, (q, v, k, ex) in _device_calls(torch, dev).items():
        kernel = lambda: topk.topk_scores(q, v, k, ex)  # noqa: E731
        lib = lambda: library(torch, q, v, k, ex)  # noqa: E731
        kernel_ms, parts = _kernel_ms(torch, kernel, by_name=True)
        out[name] = {
            "shape": list(CALLS[name]),
            "exact": same(torch, kernel(), topk.topk_scores_reference(q, v, k, ex)),
            "ms": [_events_ms(torch, kernel) for _ in range(3)],
            "host_ms": _host_ms(torch, kernel),
            "kernel_ms": kernel_ms,
            "kernels": parts,
            "library_ms": [_events_ms(torch, lib) for _ in range(3)],
            "library_kernel_ms": _kernel_ms(torch, lib),
            **bounds(q, v, k, ex),
        }
    return out


# Source variants of csrc/topk_scores.cu (text replaced, built beside the
# package's build): "score only" keeps the scoring and staging and skips the
# selection (its answer is not K5's); "no insertion" sends every candidate
# batch of k <= 32 through the sorting network; "128 columns" stages 128
# columns a step in every 32-item tile (the default keeps that for a few
# rows of a wide rank).
SOURCE_VARIANTS = {
    "score only": ("    if (chunk != n_chunks - 1) continue;",
                   "    float t = 0.f;\n"
                   "    for (int i = 0; i < TR; ++i) for (int j = 0; j < TI; ++j) t += acc[i][j];\n"
                   "    if (t != 1.5e38f || chunk != n_chunks - 1) continue;"),
    "no insertion": ("thr[i] = __popc(bal[i]) > 4 ? warp_network(", "thr[i] = true ? warp_network("),
    "128 columns": ("  if (wide) {", "  if (true) {"),
}


def _build_variants(torch) -> dict:
    import ctypes
    import subprocess

    from albedo_tpu_torch.kernels import build

    src = (build.CSRC / "topk_scores.cu").read_text()
    work = build.BUILD_DIR / "topk_variants"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (old, new)) in enumerate(SOURCE_VARIANTS.items()):
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in topk_scores.cu")
        (work / f"v{i}.cu").write_text(src.replace(old, new))
        procs[name] = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                                        "-o", str(work / f"v{i}.so"), str(work / f"v{i}.cu")])
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("nvcc failed for a variant")
    fns = {}
    for i, name in enumerate(SOURCE_VARIANTS):
        fn = ctypes.CDLL(str(work / f"v{i}.so")).topk_scores_launch
        fn.argtypes, fn.restype = build.SIGNATURES["topk_scores"], ctypes.c_int
        fns[name] = fn
    return fns


def _launch(torch, fn, q, v, k, ex, plan):
    """K5 through launch function ``fn`` with ``plan`` (tile, split, split1, rows)."""
    from albedo_tpu_torch.utils import pow2_at_least

    tile, split, split1, rows = plan
    dev = q.device
    n_items = v.shape[0]
    n_splits = max(1, -(-n_items // split))
    ws = torch.empty(rows * n_splits * (pow2_at_least(k) + 1), dtype=torch.int64, device=dev)
    bws = torch.empty(rows * -(-n_items // split1), dtype=torch.int64, device=dev) if split1 else None
    mask = None if ex is None else torch.empty(max(1, rows * -(-n_items // 32)), dtype=torch.int32, device=dev)
    s = torch.empty((q.shape[0], k), device=dev)
    i = torch.empty((q.shape[0], k), dtype=torch.int32, device=dev)
    rc = fn(q.data_ptr(), v.data_ptr(), None if ex is None else ex.data_ptr(), s.data_ptr(), i.data_ptr(),
            q.shape[0], n_items, q.shape[1], k, 0 if ex is None else ex.shape[1], tile, split, split1, rows,
            ws.data_ptr(), *(None if t is None else t.data_ptr() for t in (bws, mask)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"K5 refused the plan {plan}: cudaError {rc}")
    return s, i


def _variant(torch, fn, want) -> dict:
    """A variant's exactness and kernel ms, or the error that refused it."""
    try:
        return {"exact": same(torch, fn(), want), "kernel_ms": _kernel_ms(torch, fn)}
    except RuntimeError as err:
        return {"error": str(err)}


def mode_variants(torch) -> dict:
    from albedo_tpu_torch.kernels import build
    from albedo_tpu_torch.ops import topk

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    build.build()
    default = getattr(build._libs["topk_scores"], "topk_scores_launch")
    fns = _build_variants(torch)
    out = {}
    for name, (q, v, k, ex) in _device_calls(torch, dev).items():
        plan = topk._k5_plan(q.shape[0], v.shape[0], k, ex is not None, n_sm)
        want = topk.topk_scores_reference(q, v, k, ex)
        rec = {"default": {"plan": list(plan), "kernel_ms": _kernel_ms(torch, lambda: _launch(
            torch, default, q, v, k, ex, plan))}}
        for tile in VARIANT_TILES:
            for waves in VARIANT_WAVES:
                p = topk._k5_plan(q.shape[0], v.shape[0], k, ex is not None, max(1, int(n_sm * waves)), tile=tile)
                fn = lambda p=p: _launch(torch, default, q, v, k, ex, p)  # noqa: E731
                rec[f"tile {tile}, {waves} waves"] = {"plan": list(p), **_variant(torch, fn, want)}
        for vname, fn_v in fns.items():
            rec[vname] = _variant(torch, lambda f=fn_v: _launch(torch, f, q, v, k, ex, plan), want)
        out[name] = rec
    return out


# name -> shape of the streaming body's calls (csrc/topk_merge.cuh): K11's
# masked_topk on a CF job's block (users, items, stars, k), K6 at the serve
# job's scale (users, items, history width, batch, k), K7's item-mean query
# (items, d, examples, batch, k).
STREAMING = {"masked_topk": (256, 2936, 280, 30), "gather_topk": (5000, 2936, 280, 64, 32),
             "bank_query": (2936, 50, 32, 64, 30)}


def mode_streaming(torch) -> dict:
    """The streaming body's calls (K6, K7, K11's masked_topk) from a numpy
    seed at ``STREAMING``'s shapes: exact against the plain version, the
    card's kernel ms (profiler) and CUDA-event ms. Imports the package from
    the working directory, so running it from two checkouts compares them."""
    sys.path.insert(0, ".")
    from albedo_tpu_torch.ops import spmm
    from albedo_tpu_torch.ops import topk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    b, n, stars, k = STREAMING["masked_topk"]
    block = t(rng.normal(size=(n, b)).astype(np.float32)).t()
    starred = t(np.stack([rng.choice(n, size=stars, replace=False) for _ in range(b)]).astype(np.int32))
    norm = t(rng.uniform(0.5, 3.0, size=n).astype(np.float32))
    users, items, width, bucket, k6 = STREAMING["gather_topk"]
    uf, vf = t(rng.normal(size=(users, 50)).astype(np.float32)), t(rng.normal(size=(items, 50)).astype(np.float32))
    table = t(np.stack([rng.choice(items, size=width, replace=False) for _ in range(users)]).astype(np.int32))
    ui = t(rng.integers(0, users, size=bucket).astype(np.int32))
    n7, d, q, b7, k7 = STREAMING["bank_query"]
    vec = t(np.abs(rng.normal(size=(n7, d))).astype(np.float32))
    q_idx = t(rng.integers(-1, n7, size=(b7, q)).astype(np.int32))
    calls = {
        "masked_topk": (lambda: spmm.masked_topk(block, starred, k, norm),
                        lambda: spmm.masked_topk_reference(block, starred, k, norm)),
        "gather_topk": (lambda: topk.gather_topk(uf, vf, ui, k6, exclude_table=table),
                        lambda: topk.gather_topk_reference(uf, vf, ui, k6, exclude_table=table)),
        "bank_query": (lambda: topk.bank_query(vec, k7, q_idx=q_idx), lambda: topk.bank_query_reference(vec, k7, q_idx=q_idx)),
    }
    return {name: {"shape": list(STREAMING[name]), "exact": same(torch, fn(), plain()), "kernel_ms": _kernel_ms(torch, fn),
                   "ms": [_events_ms(torch, fn) for _ in range(3)]}
            for name, (fn, plain) in calls.items()}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_bench: needs a GPU", file=sys.stderr)
        return 1
    modes = {"calls": mode_calls, "variants": mode_variants, "streaming": mode_streaming}
    if len(argv) != 1 or argv[0] not in modes:
        print(f"usage: topk_bench {{{'|'.join(modes)}}}", file=sys.stderr)
        return 2
    print(json.dumps({"mode": argv[0], "card": torch.cuda.get_device_name(0), **modes[argv[0]](torch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
