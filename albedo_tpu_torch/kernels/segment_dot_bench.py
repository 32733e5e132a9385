"""K8/K8g timings on the card beyond ``chip_smoke.py``'s: the 20 calls of
one ranker forward and backward, rebuilt from their recorded shapes, and the
LR fits that run them.

    python -m albedo_tpu_torch.kernels.segment_dot_bench calls
    python -m albedo_tpu_torch.kernels.segment_dot_bench variants
    python /path/to/segment_dot_bench.py fits     # from any checkout's root

``calls``: K8 (and K8g at G = 5) on 20 synthetic calls with the nnz,
segment counts and longest segments that ``chip_smoke.py`` recorded at the
ranker fit (one long segment, the rest split at random, sorted indices into
257 023 rows), against cuSPARSE (a CSR ``@``): CUDA-event milliseconds of the
20 calls (host launch path included), the card's kernel time of them
(``torch.profiler``), and K8g against G launches of K8. ``variants``: the
same 20 K8 calls through copies of ``segment_dot.cu`` built with other
threads-per-CTA and steps-per-thread, kernel time only. ``fits``: the
``train_lr`` job's LR inputs (default size) through ``LogisticRegression.fit``
and ``fit_many`` over 5 weight rows, three times each, with the card's busy
time of one more; it imports the package from the working directory, so
running it from two checkouts on one card compares them. Each mode prints
one JSON line. Needs a GPU; the CPU has nothing to measure here.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import subprocess
import sys
import time
import warnings

import numpy as np

# (nnz, segments, longest segment, val given) of the 20 K8 calls of one
# forward and backward of the ranker's LR objective, as chip_smoke.py's
# ``ranker_job_kernels`` records them on an H100.
RANKER_CALLS = [
    (54024, 4962, 16, True), (109143, 4973, 34, True), (3780, 1212, 4, True), (257023, 2593, 4747, False),
    (257023, 16, 31123, False), (257023, 4983, 1123, False), (257023, 3, 206705, False),
    (257023, 12, 63457, False), (257023, 13, 39548, False), (257023, 3, 207805, False),
    (257023, 17, 25415, False), (257023, 17, 25415, False), (257023, 4984, 1123, False),
    (257023, 2602, 4747, False), (257023, 4962, 1123, False), (257023, 4973, 1123, False),
    (257023, 1212, 54776, False), (3780, 34, 170, True), (109143, 34, 4076, True), (54024, 16, 3761, True),
]
N_X = 257_023
VARIANTS = {"128x2": (128, 2), "128x1": (128, 1), "256x2": (256, 2), "128x4": (128, 4), "128x8": (128, 8)}


def _calls(torch, dev, grid: int | None, seed: int = 0) -> list[tuple]:
    rng = np.random.default_rng(seed)
    out = []
    for nnz, n_seg, longest, with_val in RANKER_CALLS:
        rest = np.floor(rng.dirichlet(np.ones(n_seg - 1)) * (nnz - longest)) if n_seg > 1 else np.zeros(0)
        counts = np.concatenate([[longest], rest]).astype(np.int64)
        counts[-1] += nnz - counts.sum()
        rng.shuffle(counts)
        ip = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), device=dev)
        x = torch.as_tensor(rng.normal(size=(N_X,) if grid is None else (grid, N_X)).astype(np.float32), device=dev)
        idx = torch.as_tensor(np.sort(rng.integers(0, N_X, nnz)).astype(np.int32), device=dev)
        val = torch.as_tensor(rng.normal(size=nnz).astype(np.float32), device=dev) if with_val else None
        out.append((x, idx, val, ip))
    return out


def _events_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(torch, fn, reps: int = 10) -> float:
    """The card's kernel milliseconds a run of ``fn`` (profiler, ``reps`` runs)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == cuda) / 1e3 / reps


def _csr(torch, calls, grid: bool):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch's beta-state notice for sparse CSR
        mats = [torch.sparse_csr_tensor(ip, idx, val if val is not None else torch.ones_like(idx, dtype=torch.float32),
                                        size=(ip.shape[0] - 1, N_X), check_invariants=False)
                for _, idx, val, ip in calls]
    rhs = [x.T.contiguous() if grid else x for x, _, _, _ in calls]
    return lambda: [m @ r for m, r in zip(mats, rhs)]


def mode_calls(torch) -> dict:
    from albedo_tpu_torch.ops import sparse_linear as sl

    dev = torch.device("cuda", 0)
    out = {}
    for grid in (None, 5):
        calls = _calls(torch, dev, grid)
        kernel = lambda: [sl.segment_dot(*c) for c in calls]  # noqa: E731
        library = _csr(torch, calls, grid is not None)
        rec = {"ms": [_events_ms(torch, kernel) for _ in range(3)],
               "library_ms": [_events_ms(torch, library) for _ in range(3)],
               "kernel_ms": _kernel_ms(torch, kernel), "library_kernel_ms": _kernel_ms(torch, library)}
        if grid is not None:
            rows = [(x[g].contiguous(), *c) for x, *c in calls for g in range(grid)]
            k8_rows = lambda: [sl.segment_dot(*r) for r in rows]  # noqa: E731
            rec.update(k8_rows_ms=_events_ms(torch, k8_rows), k8_rows_kernel_ms=_kernel_ms(torch, k8_rows))
        out["K8" if grid is None else f"K8g G={grid}"] = rec
    return out


def mode_variants(torch) -> dict:
    """Kernel ms of the 20 K8 calls through copies of segment_dot.cu with
    other THREADS and IPT (K8g's instantiation dropped: at 2048 steps its
    staging outgrows static shared memory)."""
    from albedo_tpu_torch.kernels import build

    src = (build.CSRC / "segment_dot.cu").read_text()
    work = build.BUILD_DIR / "variants"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (threads, ipt) in VARIANTS.items():
        text = (src.replace("constexpr int THREADS = 128;", f"constexpr int THREADS = {threads};")
                .replace("constexpr int IPT = 2;", f"constexpr int IPT = {ipt};")
                .replace("constexpr int GC = 8;", "constexpr int GC = 1;"))
        (work / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(work / f"{name}.so"),
                                        str(work / f"{name}.cu")])
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("nvcc failed for a variant")
    dev = torch.device("cuda", 0)
    calls = _calls(torch, dev, None)
    ws = torch.zeros(9 * 8192, dtype=torch.int32, device=dev)
    outs = [torch.empty(ip.numel() - 1, device=dev) for _, _, _, ip in calls]
    out = {}
    for name, (threads, ipt) in VARIANTS.items():
        fn = ctypes.CDLL(str(work / f"{name}.so")).segment_dot_launch
        fn.argtypes, fn.restype = build.SIGNATURES["segment_dot"], ctypes.c_int

        def run():
            stream = torch.cuda.current_stream(dev).cuda_stream
            for (x, idx, val, ip), o in zip(calls, outs):
                rc = fn(x.data_ptr(), idx.data_ptr(), None if val is None else val.data_ptr(), ip.data_ptr(),
                        o.data_ptr(), ip.numel() - 1, idx.numel(), ws.data_ptr(), 8192, stream)
                if rc:
                    raise RuntimeError(f"variant {name} refused: cudaError {rc}")

        out[name] = {"threads": threads, "steps_a_thread": ipt, "kernel_ms": _kernel_ms(torch, run)}
    out["cusparse"] = {"kernel_ms": _kernel_ms(torch, _csr(torch, calls, False))}
    return out


def mode_fits(torch) -> dict:
    sys.path.insert(0, ".")  # the checkout this runs from, not the script's
    from torch.profiler import ProfilerActivity, profile

    from albedo_tpu_torch import cli
    from albedo_tpu_torch.models import logistic_regression as lr_mod

    recorded = {}
    fit = lr_mod.LogisticRegression.fit

    def recording_fit(self, fm, labels, sample_weight=None, _damped_retry=False):
        recorded["lr"] = (self, fm, labels, sample_weight)
        return fit(self, fm, labels, sample_weight, _damped_retry)

    lr_mod.LogisticRegression.fit = recording_fit
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["train_lr", "--now", "1600000000"])
    finally:
        lr_mod.LogisticRegression.fit = fit
    est, fm, labels, w = recorded["lr"]
    w = np.asarray(w, np.float32)
    ws = np.stack([w * np.float32(1 + 0.5 * i) for i in range(5)])
    out = {}
    for name, fn in (("fit", lambda: est.fit(fm, labels, w)), ("fit_many", lambda: est.fit_many(fm, labels, ws))):
        fn()
        seconds = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = fn()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == cuda) / 1e6
        model = model[0] if isinstance(model, list) else model
        out[name] = {"s": seconds, "device_busy_s": busy, "iterations": model.n_iter_run, "loss": model.train_loss}
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("segment_dot_bench: needs a GPU", file=sys.stderr)
        return 1
    modes = {"calls": mode_calls, "variants": mode_variants, "fits": mode_fits}
    if len(argv) != 1 or argv[0] not in modes:
        print(f"usage: segment_dot_bench {{{'|'.join(modes)}}}", file=sys.stderr)
        return 2
    print(json.dumps({"mode": argv[0], "card": torch.cuda.get_device_name(0), **modes[argv[0]](torch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
