"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` exports a C function ``<name>_launch`` for each
of its entry points (one, named as the source, unless ``ENTRIES`` names
more), that takes raw device pointers, sizes and a CUDA stream, launches its
kernel and returns ``cudaGetLastError()``. Each source compiles on its own into a shared
library under ``build/kernels/`` at the root of the checkout, named by the
hash of its source and of the shared headers (``csrc/*.cuh``), so an edited
source is rebuilt and a stale library is never loaded. The ``nvcc``
processes of all sources run at once.

Nothing here runs at import: the first call to :func:`call` (or an explicit
:func:`build`) compiles, on the machine with the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# name -> argtypes of ``<name>_launch`` (pointers and the stream as c_void_p,
# so ctypes never cuts a 64-bit address to an int).
SIGNATURES: dict[str, list] = {
    # source, idx, val, mask, corr, bvec, B, L, k, alpha, chunk, n_chunks, per_cta, ws, stream
    "als_partials": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P, _P],
    # the same, with source bf16
    "als_partials_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P, _P],
    # yty, corr, bvec, n_b, reg, x, B, k, ws, stream
    "solve_corrected": [_P, _P, _P, _P, _F, _P, _I, _I, _P, _I, _P],
    # source, yty, idx, val, mask, x0, x, B, L, k, reg, alpha, cg_steps, mode, c, slice, resident, ws, stream
    "bucket_cg": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _P, _P],
    # the same, with source bf16
    "bucket_cg_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _P, _P],
    # users, items, excl, out_s, out_i, U, I, r, k, E, tile, split, split1, rows, ws, bws, mask, stream
    "topk_scores": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # uf_all, items, user_idx, excl, excl_by_user, out_s, out_i, B, I, r, k, E, Epad, stream
    "gather_topk": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # users, items, user_idx, excl, excl_map, mean_rows, out_s, out_i, B, I, d, k, E, Epad, dpad, stream
    "bank_query": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, idx, val, indptr, out, S, nnz, ws, cap, stream
    "segment_dot": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P],
    # x, n_x, idx, val, indptr, out, S, G, nnz, ws, cap, stream
    "segment_dot_grid": [_P, _L, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    # in, out, centers, contexts, negs, grad_in, grad_out, loss_acc, B, d, K, stream
    "sgns_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # in, out, centers, contexts, pool, grad_in, grad_out, loss_acc, keys, perm, ws, ws_numel, B, V, d, K,
    # neg_scale, stream
    "sgns_shared": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _P],
    # p, g, m, v, n, lr, b1, b2, 1-b1, 1-b2, eps, bc1, bc2, bias (the pair on the device, or null), stream
    "adam_dense": [_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    # x, indptr, idx, val, out, units, n_units, long_rows, n_long, ws, S, B, stream
    "spmm_rows": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _P],
    # scores, sb, si, starred, norm, out_s, out_i, B, n, k, L, Lpad, stream
    "masked_topk": [_P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # scores, sb, si, starred, norm, out_s, out_i, row0, B, n, k, L, scratch, sortbuf, sort_pad, stream
    "masked_select": [_P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # users, items, user_idx, excl, excl_by_user, excl_map, mean_rows, out_s, out_i, row0, B, I,
    # r, k, E, dpad, qbuf, has, scratch, sortbuf, sort_pad, stream
    "topk_select": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    # base, tables (host array of J pointers), idxs (likewise), J, N, out, stream
    "gather_sum": [_P, _P, _P, _I, _I, _P, _P],
    # base, tables, idxs, sizes (host array of J sizes), J, N, G, out, stream
    "gather_sum_grid": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    # pool, n_slots, target, landing, out, n_target, k, stream
    "land_rows": [_P, _L, _P, _P, _P, _I, _I, _P],
    # target, row_ids, solved, out, n_slots, n_target, k, stream
    "scatter_rows": [_P, _P, _P, _P, _I, _I, _I, _P],
    # u, nu, v, nv, parts, G, out, stream
    "factor_health": [_P, _L, _P, _L, _P, _I, _P, _P],
    # x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc, B, N, r, d, reg, stream
    "bpr_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

# Entry points of a source other than the one named as the source: entry ->
# source. K8g and K8c-g (K8 and K8c over a leading grid axis) live beside
# their one-row kernels; ``scatter_rows`` (K4's ``scatter_solved``) beside
# ``land_rows`` (K4's landing); K1-bf16 and K3-bf16 (the bf16 gathers) are
# K1 and K3 instantiated for a bf16 table; ``masked_select`` (K11's
# masked_topk at any k and starred width) lives beside the select path.
ENTRIES = {
    "segment_dot_grid": "segment_dot",
    "gather_sum_grid": "gather_sum",
    "scatter_rows": "land_rows",
    "als_partials_bf16": "als_partials",
    "bucket_cg_bf16": "bucket_cg",
    "masked_select": "topk_select",
}


def source_of(name: str) -> str:
    """The ``csrc/<source>.cu`` that defines entry point ``name``."""
    return ENTRIES.get(name, name)


# Second code paths of a kernel, counted apart from the first: count name ->
# library. K1-K3's wide paths (rank > 64) and K1's and K3's tiled paths (rank > 512)
# are other __global__ functions behind the same launch function; K5 at rank > 64 (the content sources,
# K14) runs K5's kernels and is counted apart as K14; the select path of
# K5-K7 (k > 512; for K6 and K7 also exclusion rows their streaming body
# cannot sort) is its own library, counted per caller, and K11's masked_topk
# takes it above k = 128 or a starred row of 32768 (``masked_select``); K9's
# and K10's wide paths (d > 512; rank > 128 or side width > 32) are other
# __global__ functions behind their launch functions.
PATHS = {
    "topk_scores_wide": "topk_scores",
    "als_partials_wide": "als_partials",
    "solve_corrected_wide": "solve_corrected",
    "bucket_cg_wide": "bucket_cg",
    "als_partials_bf16_wide": "als_partials",
    "als_partials_tiled": "als_partials",
    "als_partials_bf16_tiled": "als_partials",
    "bucket_cg_bf16_wide": "bucket_cg",
    "bucket_cg_tiled": "bucket_cg",
    "bucket_cg_bf16_tiled": "bucket_cg",
    "topk_scores_select": "topk_select",
    "gather_topk_select": "topk_select",
    "bank_query_select": "topk_select",
    "masked_topk_select": "topk_select",
    "sgns_step_wide": "sgns_step",
    "bpr_step_wide": "bpr_step",
}

# Launches of each kernel (and path) that the card ran in this process (see
# ``kernels.reset_launches``). Launches come from several threads (the
# serving batcher's worker, HTTP handler threads), so every update holds
# ``LAUNCHES_LOCK``. A launch made while a CUDA graph is captured is counted
# in the capturing thread's :class:`LaunchRecord` instead, and each replay of
# the graph adds the recorded counts here.
LAUNCHES: dict[str, int] = dict.fromkeys([*SIGNATURES, *PATHS], 0)
LAUNCHES_LOCK = threading.Lock()
_RECORDING = threading.local()  # .record: the LaunchRecord open in this thread, if any


class LaunchRecord:
    """The launches :func:`call` makes in one thread while the record is
    open (``with record:``, around a CUDA graph's capture): they are kept in
    ``counts``, not added to ``LAUNCHES``, because a capture runs nothing on
    the card. :meth:`replayed` adds them to ``LAUNCHES`` once for each replay
    of the graph. Launches from other threads meanwhile count as usual."""

    def __init__(self) -> None:
        self.counts: dict[str, int] = {}

    def __enter__(self) -> "LaunchRecord":
        if getattr(_RECORDING, "record", None) is not None:
            raise RuntimeError("a launch record is already open in this thread")
        _RECORDING.record = self
        return self

    def __exit__(self, *exc) -> None:
        _RECORDING.record = None

    def replayed(self, times: int = 1) -> None:
        """Count ``times`` replays of the recorded launches in ``LAUNCHES``."""
        with LAUNCHES_LOCK:
            for name, n in self.counts.items():
                LAUNCHES[name] += n * times


def count_launch(name: str) -> None:
    """Count one launch of ``name`` (a key of ``SIGNATURES`` or ``PATHS``): in
    the thread's open :class:`LaunchRecord`, else in ``LAUNCHES``."""
    record = getattr(_RECORDING, "record", None)
    if record is not None:
        record.counts[name] = record.counts.get(name, 0) + 1
        return
    with LAUNCHES_LOCK:
        LAUNCHES[name] += 1

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # entry point -> its source's loaded library


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on ``PATH``."""
    for cand in (
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared headers (topk_body.cuh, topk_merge.cuh)
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict[str, float]:
    """Compile every kernel whose library is missing, all ``nvcc`` runs in
    parallel, and load all of them. Returns the seconds each source's build took
    (0.0 for one already built). ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report of registers, shared memory and spills."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
        sources = sorted({source_of(name) for name in SIGNATURES})
        seconds = {name: 0.0 for name in sources}
        for name in sources:
            out = _library_path(name)
            if out.is_file():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if verbose or proc.returncode:
                print(f"[kernels] nvcc {name}.cu (rc={proc.returncode}):\n{log}", flush=True)
            if proc.returncode:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        loaded: dict[str, ctypes.CDLL] = {}
        for name in SIGNATURES:
            if name not in _libs:
                src = source_of(name)
                if src not in loaded:
                    loaded[src] = ctypes.CDLL(str(_library_path(src)))
                lib = loaded[src]
                fn = getattr(lib, f"{name}_launch")
                fn.argtypes = SIGNATURES[name]
                fn.restype = ctypes.c_int
                _libs[name] = lib
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of entry point ``name`` (building every kernel on
    first use), for a query function its source exports beside the launch
    functions (``bucket_cg_clusters``, ``bucket_cg_smem``, ``sgns_shared_plan``)."""
    if name not in _libs:
        build()
    return _libs[name]


def call(name: str, device, *args, count: str | None = None) -> None:
    """Launch kernel ``name`` on CUDA ``device`` (building all kernels on
    first use), raise if the launch was refused, and count it under
    ``count`` (a key of ``PATHS``) or ``name`` (:func:`count_launch`).
    ``args`` are the launch function's arguments before the stream; the
    launch runs with ``device`` current, on PyTorch's current stream there,
    whichever device the caller had current. When ``device`` (a
    ``torch.device`` with an index) is already current, the launch skips the
    device switch and takes the raw stream handle, a few microseconds less a
    launch: K8 launches thousands of times a fit."""
    import torch

    if name not in _libs:
        build()  # under the build lock: a second thread waits, then loads
    fn = getattr(_libs[name], f"{name}_launch")
    index = getattr(device, "index", None)
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # None in a CPU-only build
    if index is not None and raw_stream is not None and index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    count_launch(count or name)


def on_cpu(kernel: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper runs its plain
    version); False when all lie on one CUDA device (it launches the
    kernel); raises ``ValueError`` otherwise. There is no fallback."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"{kernel}: operands must all be on the CPU or on one CUDA device, got {types}")


def check_operand(kernel: str, name: str, t, dtype, shape: tuple, device) -> None:
    """Raise ``ValueError`` unless tensor ``t`` is a contiguous ``dtype``
    tensor of ``shape`` on ``device``, as kernel ``kernel`` reads it."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
