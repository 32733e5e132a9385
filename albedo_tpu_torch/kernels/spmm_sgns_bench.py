"""K11 ``spmm_rows`` and K9s ``sgns_shared`` timed on the card beyond
``chip_smoke.py``'s, the parent design beside the change.

    python -m albedo_tpu_torch.kernels.spmm_sgns_bench calls
    python -m albedo_tpu_torch.kernels.spmm_sgns_bench calls --against /path/to/other/root
    python -m albedo_tpu_torch.kernels.spmm_sgns_bench variants

``calls``: K11 at the CF score blocks of 256 users, both passes of item-CF
and user-CF, on the ``train_als`` job's tables (``job``: 5000 x 3000) and on
the bench split (``bench``: ``synthetic_stars(30000, 20000, rank=24,
mean_stars=60, seed=42)``, 10% of each user's stars held out), as the
recommenders call it; and K9s at the refscale Word2Vec step (B 65 536,
K 512, d 200, V 56 182; centers, contexts and the pool drawn from the
refscale corpus's Zipf(1.05) unigram, the pool through its 0.75 power, as
the fit draws them; tables at the init's scale). Each is held against its
plain version (K11: max error over each element's L1 mass; K9s: its plain
version in float64, over ``ops.sgns.sgns_shared_grad_mass``), checked for
the same bits on a second call, and timed: CUDA-event ms (host launch path
included), the card's kernel ms (``torch.profiler`` sums, kernels by name),
the plain version's ms and the library yardstick's (K11: cuSPARSE SpMM
through ``torch.sparse.mm``; K9s: cuBLAS ``torch.mm`` of its three
products on rows gathered beforehand, a partial yardstick that leaves out
the gathers, the sigmoid, the loss and the sums into the tables). With
``--against ROOT`` each tree times the same inputs in a process of its own,
importing its own package (and building its own kernels), in the order
ROOT, this tree, this tree, ROOT: the parent-against-change comparison of
one card. Prints one JSON line a tree, then the comparison. ``variants``:
K9s and K11 (bench) through copies of their sources with other tuning
constants and under other plan settings (``K9S_VARIANTS``,
``K11_VARIANTS``), kernel ms each. Needs a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPS = 10

# Variants (``variants``): name -> (source edits [(text, replacement)],
# plan settings {name: value} of ops.spmm while it is timed; K9s's plan is
# its library's own, so a source edit changes it).
K9S_VARIANTS = {
    "default": ([], {}),
    "BK 16, 2 stages": ([("constexpr int BK = 8;", "constexpr int BK = 16;"),
                         ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")], {}),
    "G^T Vc aimed at 264 CTAs": ([("constexpr int TARGET_CTAS = 528;", "constexpr int TARGET_CTAS = 264;")], {}),
    "1 CTA an SM": ([("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 1;")], {}),
    "no loss in L's epilogue": ([("        loss += bce;\n", "")], {}),
}
K11_VARIANTS = {
    "default": ([], {}),
    "8 warps a CTA": ([("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")], {}),
    "2 warps a CTA": ([("constexpr int WARPS = 4;", "constexpr int WARPS = 2;")], {}),
    "8 rows in flight": ([("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")], {}),
    "chunk 64": ([], {"SPMM_CHUNK": 64}),
}


def _events_ms(torch, fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(torch, fn, reps: int = REPS) -> tuple[float, dict]:
    """The card's kernel ms of one ``fn()`` (a profiler session over
    ``reps`` calls) and its kernels' ms by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_name[e.key[:90]] = us / 1e3 / reps
    return sum(by_name.values()), dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])


def cf_calls(torch, dev, scale: str) -> list:
    """The spmm_rows calls of one score block of 256 users, item-CF then
    user-CF, as (w, x)."""
    from albedo_tpu_torch.datasets import random_split_by_user, sample_test_users
    from albedo_tpu_torch.datasets.ragged import padded_rows
    from albedo_tpu_torch.recommenders import cf

    if scale == "job":
        from albedo_tpu_torch import cli
        from albedo_tpu_torch.builders.jobs import JobContext

        train = JobContext(cli.parse_args(["train_als", "--device", dev.type])).matrix()
    else:
        from albedo_tpu_torch.datasets.synthetic import synthetic_stars

        train, _ = random_split_by_user(synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42),
                                        test_ratio=0.1, seed=42)
    indptr, cols, _ = train.csr()
    users = sample_test_users(train, n=256, seed=42)
    star_idx = torch.as_tensor(padded_rows(indptr, cols, users), device=dev)
    calls = []
    real = cf.spmm_rows

    def recording(w, x):
        calls.append((w, x))
        return real(w, x)

    cf.spmm_rows = recording
    try:
        for cls in (cf.ItemCFRecommender, cf.UserCFRecommender):
            cls(train, top_k=30, device=dev)._score_block(star_idx, 30)
    finally:
        cf.spmm_rows = real
    return [(w, x) for w, x in calls if x.shape[1] > 1]


def time_spmm(torch, calls) -> dict:
    from albedo_tpu_torch.ops import spmm

    csr = []
    for w, _ in calls:
        val = w.val if w.val is not None else torch.ones_like(w.idx, dtype=torch.float32)
        csr.append(torch.sparse_csr_tensor(w.indptr, w.idx, val, size=(w.n_rows, w.n_cols), check_invariants=False))
    err, same = 0.0, True
    for w, x in calls:
        got, again = spmm.spmm_rows(w, x), spmm.spmm_rows(w, x)
        want, mass = spmm.spmm_rows_reference(w, x), spmm.spmm_rows_mass(w, x)
        err = max(err, float(((got - want).abs() / mass.clamp_min(1e-30)).max()))
        same &= bool((got == again).all())

    def run():
        for w, x in calls:
            spmm.spmm_rows(w, x)

    kernel_ms, kernels = _kernel_ms(torch, run)
    return {"events_ms": _events_ms(torch, run), "kernel_ms": kernel_ms, "kernels": kernels,
            "plain_ms": _events_ms(torch, lambda: [spmm.spmm_rows_reference(w, x) for w, x in calls], 3),
            "library_ms": _events_ms(torch, lambda: [torch.sparse.mm(m, x) for m, (_, x) in zip(csr, calls)]),
            "max_rel_mass_err": err, "same_bits": same,
            "calls": [[w.n_rows, w.n_cols, int(w.idx.numel()), int(x.shape[1])] for w, x in calls]}


def refscale_batch(torch, dev, b: int = 65536, k: int = 512, d: int = 200, v: int = 56182):
    """A refscale-shaped K9s step: Zipf(1.05) centers and contexts, the pool
    from its 0.75 power, tables at the init's scale (in: uniform(+-0.5/d),
    out: normal(0, 0.1))."""
    rng = np.random.default_rng(42)
    freq = 1.0 / np.arange(1, v + 1) ** 1.05
    freq /= freq.sum()
    noise = freq**0.75
    noise /= noise.sum()
    c, o = (rng.choice(v, size=b, p=freq).astype(np.int32) for _ in range(2))
    pool = rng.choice(v, size=k, p=noise).astype(np.int32)
    in_t = rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32)
    out_t = rng.normal(scale=0.1, size=(v, d)).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (in_t, out_t, c, o, pool)]


def time_k9s(torch, dev) -> dict:
    from albedo_tpu_torch.ops import sgns

    in_t, out_t, c, o, pool = refscale_batch(torch, dev)
    b, d, k = c.shape[0], in_t.shape[1], pool.shape[0]
    scale = 5 / k
    ws = (sgns.sgns_shared_workspace(b, d, k, dev) if hasattr(sgns, "sgns_shared_workspace")
          else torch.empty(b * k, device=dev))
    res = []
    for _ in range(2):
        g = (torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, device=dev))
        sgns.sgns_shared_step(in_t, out_t, c, o, pool, *g, scale, ws)
        res.append(g)
    same = all(bool((a == e).all()) for a, e in zip(res[0], res[1]))  # before the timing adds into res[0]
    dd = [t.double() for t in (in_t, out_t)]
    want = (torch.zeros_like(dd[0]), torch.zeros_like(dd[1]), torch.zeros(1, dtype=torch.float64, device=dev))
    sgns.sgns_shared_step_reference(*dd, c, o, pool, *want, scale)
    mass = sgns.sgns_shared_grad_mass(*dd, c, o, pool, scale)
    err = max(float(((a.double() - e).abs() / m.clamp_min(1e-300)).max()) for a, e, m in zip(res[0], want, mass))
    err = max(err, float((res[0][2].double() - want[2]).abs() / want[2].abs()))
    g = res[0]

    def run():
        sgns.sgns_shared_step(in_t, out_t, c, o, pool, *g, scale, ws)

    vc, vo, vn = in_t[c.long()], out_t[o.long()], out_t[pool.long()]
    gmat = torch.rand((b, k), device=dev)

    def library():  # the three products alone, on rows gathered beforehand
        torch.mm(vc, vn.T)
        torch.mm(gmat, vn)
        torch.mm(gmat.T, vc)

    kernel_ms, kernels = _kernel_ms(torch, run)
    return {"events_ms": _events_ms(torch, run), "kernel_ms": kernel_ms, "kernels": kernels,
            "plain_ms": _events_ms(torch, lambda: sgns.sgns_shared_step_reference(in_t, out_t, c, o, pool, *g, scale),
                                   3),
            "library_ms": _events_ms(torch, library), "max_rel_mass_err_f64": err,
            "same_bits": same,
            "shape": {"B": b, "K": k, "d": d, "V": int(in_t.shape[0]),
                      "max_center_run": int(torch.bincount(c.long()).max()),
                      "max_pool_slots": int(torch.bincount(pool.long()).max())}}


def k9s_faults(in_t, out_t, c, o, pool, scale: float, got: tuple, want: tuple, limits: tuple, plan: dict) -> dict:
    """F8's check (``ops.sgns.sgns_shared_limits``) against faults planted
    in K9s's result ``got`` (grad_in, grad_out, loss) on one batch, ``want``
    its plain version in float64: the worst error over its limit
    (``ops.sgns.sgns_shared_over``; the check refuses a fault above 1) of
    - ``dropped pair``: the first pair of the batch's most frequent center
      left out of its ``grad_in`` row (H_b = g_b vo_b + (G Vn)_b);
    - ``split left out``: G^T Vc's first split (``plan["chunk"]`` pairs)
      left out of the pool words' ``grad_out`` rows;
    - ``tf32 operands``: the plain version in float64 on the tables rounded
      to TF32 (10 mantissa bits, to nearest), as products on TF32 tensor
      cores would round them."""
    import torch

    from albedo_tpu_torch.ops import sgns

    b = c.shape[0]
    dd = [t.double() for t in (in_t, out_t)]
    vc, vo, vn = dd[0][c.long()], dd[1][o.long()], dd[1][pool.long()]
    gs = float(np.float32(scale)) / b
    hot = int(torch.bincount(c.long()).argmax())
    first = int((c == hot).nonzero()[0, 0])
    h = -torch.sigmoid(-(vc[first] * vo[first]).sum()) / b * vo[first] + (torch.sigmoid(vc[first] @ vn.T) * gs) @ vn
    dropped = got[0].double().index_add(0, torch.tensor([hot], device=h.device), -h[None])
    chunk = plan["chunk"]
    split = (torch.sigmoid(vc[:chunk] @ vn.T) * gs).T @ vc[:chunk]
    left_out = got[1].double().index_add(0, pool.long(), -split)

    def tf32(t):
        return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32).double()

    rounded = (torch.zeros_like(dd[0]), torch.zeros_like(dd[1]), torch.zeros_like(want[2]))
    sgns.sgns_shared_step_reference(tf32(in_t), tf32(out_t), c, o, pool, *rounded, scale)
    return {"dropped pair": sgns.sgns_shared_over((dropped, got[1], got[2]), want, limits),
            "split left out": sgns.sgns_shared_over((got[0], left_out, got[2]), want, limits),
            "tf32 operands": sgns.sgns_shared_over(rounded, want, limits),
            "hot_center_pairs": int((c == hot).sum())}


def time_variants(torch, dev) -> dict:
    """K9s at the refscale step and K11 at the bench's CF block through each
    variant (``K9S_VARIANTS``, ``K11_VARIANTS``: a copy of the source with
    other constants, other plan settings, or both): kernel ms by the
    profiler, and the largest difference from the default's result."""
    from albedo_tpu_torch.kernels import build
    from albedo_tpu_torch.kernels.als_partials_bench import _build_variants
    from albedo_tpu_torch.ops import sgns, spmm

    build.build()
    in_t, out_t, c, o, pool = refscale_batch(torch, dev)
    scale = 5 / pool.shape[0]
    calls = cf_calls(torch, dev, "bench")
    out = {}

    def run_k9s():
        g = (torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, device=dev))
        sgns.sgns_shared_step(in_t, out_t, c, o, pool, *g, scale)
        return g

    def run_k11():
        return [spmm.spmm_rows(w, x) for w, x in calls]

    for entry, module, variants, run in (("sgns_shared", sgns, K9S_VARIANTS, run_k9s),
                                         ("spmm_rows", spmm, K11_VARIANTS, run_k11)):
        base = run()
        default = build._libs[entry]
        libs = _build_variants(entry, {name: edits for name, (edits, _) in variants.items()})
        for name, (_, settings) in variants.items():
            saved = {key: getattr(module, key) for key in settings}
            build._libs[entry] = libs[name]
            try:
                for key, value in settings.items():
                    setattr(module, key, value)
                for w, _ in calls:
                    w.plan = None
                got = run()
                out[f"{entry} {name}"] = {
                    "kernel_ms": _kernel_ms(torch, run)[0],
                    "max_abs_diff": max(float((a - e).abs().max()) for a, e in zip(got, base))}
            except RuntimeError as err:  # a variant the card refuses to launch
                out[f"{entry} {name}"] = {"error": str(err)}
            finally:
                build._libs[entry] = default
                for key, value in saved.items():
                    setattr(module, key, value)
                for w, _ in calls:
                    w.plan = None
    return out


def time_all(torch, dev) -> dict:
    out = {f"spmm_rows {scale}": time_spmm(torch, cf_calls(torch, dev, scale)) for scale in ("job", "bench")}
    out["sgns_shared"] = time_k9s(torch, dev)
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
        print("spmm_sgns_bench: needs a GPU", file=sys.stderr)
        return 1
    if not argv or argv[0] not in ("calls", "time", "variants"):
        print("usage: spmm_sgns_bench calls [--against ROOT] | variants", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if argv[0] == "variants":
        print(json.dumps({"mode": "variants", "card": _card(), **time_variants(torch, dev)}), flush=True)
        return 0
    if argv[0] == "time":  # a child of --against: ``time ROOT``, importing ROOT's package
        sys.path.insert(0, argv[1])
        print(json.dumps({"root": argv[1], **time_all(torch, dev)}), flush=True)
        return 0
    if "--against" not in argv:
        print(json.dumps({"mode": "calls", "card": _card(), **time_all(torch, dev)}), flush=True)
        return 0
    other = str(Path(argv[argv.index("--against") + 1]).resolve())
    here = str(Path(__file__).resolve().parents[2])
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "time", root], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {name: {key: [r[name][key] for r in runs] for key in ("events_ms", "kernel_ms", "library_ms")}
               for name in ("spmm_rows job", "spmm_rows bench", "sgns_shared")}
    print(json.dumps({"mode": "calls", "card": _card(), "order": [other, here, here, other], **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
