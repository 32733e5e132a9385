"""``lbfgs_direction`` timings on the card beyond ``chip_smoke.py``'s: the
kernel at the L-BFGS fits' shapes (P = 8 382 parameters, G = 1 and 5 rows, a
memory of 10 slots that has wrapped, iteration 12), against copies of
``lbfgs_direction.cu`` built with other designs of one slot of the
recursion.

    python -m albedo_tpu_torch.kernels.lbfgs_direction_bench variants

``variants``: each design's kernel milliseconds (``torch.profiler``, the
card's time of 50 calls) and CUDA-event milliseconds (host launch path
included), alternated over three rounds, with each variant's direction
held against the committed kernel's bits. ``regs``: a thread's entries of
the slot's two rows loaded together into registers before the slot's sum
(one round trip to L2 a slot), up to P = 16 384; ``loop``: the committed
source, which reads the two rows in two passes. Prints one JSON line with the
card's name and power limit. Needs a GPU; the CPU has nothing to measure
here.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np

P, SLOTS, COUNT = 8382, 10, 12

# The register design of one slot, as a patch to the committed source: a
# thread's REG entries of x and y in registers, the same arithmetic in the
# same order as slot_loop.
REGS_SLOT = """
constexpr int REG = 16;

template <typename Coef>
__device__ __forceinline__ void slot_regs(const float* __restrict__ x, const float* __restrict__ y, float* vec, int P,
                                          float* red, Coef coef) {
  float xr[REG], yr[REG];
#pragma unroll
  for (int e = 0; e < REG; ++e) {
    const int k = threadIdx.x + e * THREADS;
    xr[e] = k < P ? x[k] : 0.0f;
    yr[e] = k < P ? y[k] : 0.0f;
  }
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < REG; ++e) {
    const int k = threadIdx.x + e * THREADS;
    if (k < P) s = add(s, mul(xr[e], vec[k]));
  }
  const float c = coef(block_sum(s, red));
#pragma unroll
  for (int e = 0; e < REG; ++e) {
    const int k = threadIdx.x + e * THREADS;
    if (k < P) vec[k] = add(vec[k], mul(c, yr[e]));
  }
}

__global__"""


def _variant_source(src: str, name: str) -> str:
    if name == "loop":
        return src
    text = src.replace("\n__global__", REGS_SLOT, 1)
    text = text.replace("slot_loop(dwi, dui, vec, P, red, coef);",
                        "if (P <= REG * THREADS) slot_regs(dwi, dui, vec, P, red, coef); "
                        "else slot_loop(dwi, dui, vec, P, red, coef);")
    text = text.replace("slot_loop(dui, dwi, vec, P, red, coef);",
                        "if (P <= REG * THREADS) slot_regs(dui, dwi, vec, P, red, coef); "
                        "else slot_loop(dui, dwi, vec, P, red, coef);")
    if text.count("slot_regs(") != 3:
        raise RuntimeError("lbfgs_direction_bench: the source no longer matches the regs patch")
    return text


def _events_ms(torch, fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(torch, fn, reps: int = 50) -> float:
    """The card's kernel milliseconds a call of ``fn`` (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == cuda) / 1e3 / reps


def mode_variants(torch) -> dict:
    from albedo_tpu_torch.kernels import build

    src = (build.CSRC / "lbfgs_direction.cu").read_text()
    work = build.BUILD_DIR / "direction_variants"
    work.mkdir(parents=True, exist_ok=True)
    names = ("loop", "regs")
    procs = {}
    for name in names:
        (work / f"{name}.cu").write_text(_variant_source(src, name))
        procs[name] = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(work / f"{name}.so"),
                                        str(work / f"{name}.cu")])
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("nvcc failed for a variant")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    out: dict = {"card": card, "P": P, "slots": SLOTS, "count": COUNT}
    for g in (1, 5):
        rng = np.random.default_rng(g)

        def t(*shape):
            return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

        grad, params = t(g, P), t(g, P)
        memory = (t(SLOTS, g, P), t(SLOTS, g, P), torch.as_tensor(rng.uniform(0.5, 1.5, (SLOTS, g)).astype(np.float32),
                                                                   device=dev), t(g, P), t(g, P))
        iters = torch.full((1,), COUNT, dtype=torch.int32, device=dev)
        fns = {}
        for name in names:
            fn = ctypes.CDLL(str(work / f"{name}.so")).lbfgs_direction_launch
            fn.argtypes, fn.restype = build.SIGNATURES["lbfgs_direction"], ctypes.c_int
            fns[name] = fn

        def runner(name, mem, outs):
            def run():
                rc = fns[name](grad.data_ptr(), params.data_ptr(), *(m.data_ptr() for m in mem), iters.data_ptr(), 1,
                               g, P, SLOTS, outs[0].data_ptr(), outs[1].data_ptr(), None,
                               torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {name} refused: cudaError {rc}")
            return run

        results = {}
        for name in names:  # one call each on a fresh copy of the memory: the same bits?
            mem = [m.clone() for m in memory]
            outs = (torch.empty(g, P, device=dev), torch.empty(g, device=dev))
            runner(name, mem, outs)()
            torch.cuda.synchronize()
            results[name] = [outs[0].clone(), outs[1].clone(), *mem]
        same = all(torch.equal(a, b) for a, b in zip(results["loop"], results["regs"]))
        rec: dict = {name: {"kernel_ms": [], "events_ms": []} for name in names}
        for _ in range(3):
            for name in names:
                mem = [m.clone() for m in memory]
                run = runner(name, mem, (torch.empty(g, P, device=dev), torch.empty(g, device=dev)))
                rec[name]["kernel_ms"].append(_kernel_ms(torch, run))
                rec[name]["events_ms"].append(_events_ms(torch, run))
        out[f"G={g}"] = dict(rec, same_bits=same)
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("lbfgs_direction_bench: needs a GPU", file=sys.stderr)
        return 1
    modes = {"variants": mode_variants}
    if len(argv) != 1 or argv[0] not in modes:
        print(f"usage: lbfgs_direction_bench {{{'|'.join(modes)}}}", file=sys.stderr)
        return 2
    print(json.dumps(modes[argv[0]](torch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
