"""CUDA graphs of a fit's loop: the capture and replay that the whole-loop
programs share (K16 the ALS fit, ``ops/als.py fit_loop``; K17 the Word2Vec
epoch, ``models/word2vec.py``; K18 the BPR fit,
``models/ranking_factorization.py``, both through :func:`replay_epochs`).

A fit's loop is ``n`` units of identical work (an ALS iteration, an epoch).
:func:`replay_loop` runs unit 0 eagerly on the thread's capture stream (the
warm-up: kernels built and planned, cuBLAS's workspace, first-use
allocations), captures one unit, and replays it ``n - 1`` times, so the host
enqueues a replay a unit, not a kernel call at a time. Everything that
differs between units reaches the graph through static buffers the caller
refills before each replay (a Python value read during the capture is fixed
in the graph). The launches the capture records are counted once a replay
(:class:`~albedo_tpu_torch.kernels.build.LaunchRecord`).

The capture runs in ``thread_local`` mode: it refuses a host sync in this
thread (a hidden sync in a unit raises), and ignores other threads' CUDA
calls, which go to their own streams, so serving threads neither fail a fit
nor land in its graph. A capture or replay that fails raises
``RuntimeError`` naming the fit: there is no eager fallback.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterable

import torch

from albedo_tpu_torch.kernels.build import LaunchRecord

_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process, as torch's graphs require
_GRAPH_FITS = threading.local()  # .streams, .keepers: this thread's capture stream and pool keeper a device


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """This thread's stream for graph fits on ``dev``: unit 0, the capture
    and the replays run there, so no other thread's work lands in a
    capture, and cuBLAS's workspace for it is set up once."""
    streams = _GRAPH_FITS.__dict__.setdefault("streams", {})
    if dev.index not in streams:
        streams[dev.index] = torch.cuda.Stream(dev)
    return streams[dev.index]


def graph_pool(dev: torch.device) -> tuple:
    """This thread's memory pool for graph fits on ``dev``: the pool of a
    one-node graph the thread keeps, which holds the pool open between fits.
    A fit's graph allocates its tensors there during the capture; they are
    free again once the fit has dropped its graph, so the next fit's capture
    reuses the blocks: the thread's fits hold one pool, not one each, and a
    capture needs no ``cudaMalloc`` once the pool is as large as the fits
    ask. Called under ``_CAPTURE_LOCK``, on the capture stream."""
    keepers = _GRAPH_FITS.__dict__.setdefault("keepers", {})
    if dev.index not in keepers:
        keeper = torch.cuda.CUDAGraph()
        keeper.capture_begin(capture_error_mode="thread_local")
        try:
            torch.zeros(1, device=dev)
        finally:
            keeper.capture_end()
        keepers[dev.index] = keeper
    return keepers[dev.index].pool()


def abandon_graph_pool(dev: torch.device, pool: tuple) -> None:
    """After a failed capture: stop sending this thread's allocations to
    ``pool`` (torch ends that only when a capture ends cleanly) and drop the
    thread's keeper, so that its next graph fit captures into a new pool."""
    with contextlib.suppress(RuntimeError):  # raised where the capture never began to allocate
        torch._C._cuda_endAllocateToPool(dev.index, pool)
    _GRAPH_FITS.__dict__.get("keepers", {}).pop(dev.index, None)


def replay_loop(
    name: str,
    dev: torch.device,
    unit: Callable[[int], None],
    n: int,
    *,
    refill: Callable[[int], None] | None = None,
    after: Callable[[int], None] | None = None,
    generators: Iterable[torch.Generator] = (),
    report: dict | None = None,
    span: str = "replay_loop.replays",
) -> None:
    """Run the ``n`` units of a fit on ``dev``'s card: ``unit(0)`` eagerly,
    then ``unit(1)`` captured once as a CUDA graph, replayed for units 1 to
    ``n - 1``. ``unit(0)`` runs the first unit from the fit's own inputs;
    ``unit(1)`` must enqueue the same work reading the static buffers that
    ``refill(i)`` fills before replay ``i`` (the capture runs nothing, so
    their contents at capture time do not matter). ``after(i)``, if given,
    runs after unit 0 and after each replay, on the same stream. Every
    ``torch.Generator`` the unit draws from besides the default one is in
    ``generators``: the graph then advances it as the eager units would, so
    each replay draws the numbers the eager loop draws, and the generator's
    next draw after the fit is the eager loop's. ``report``, if given, gets
    ``compile_s`` (capturing and instantiating) and ``compile_source``
    (``"capture"``) where a graph is captured (``n`` >= 2). The replays
    run inside a ``torch.profiler`` span named ``span``; ``name`` names the
    fit in errors. When it returns, the caller's stream waits for the
    fit's work; tensors the units allocated are the capture stream's."""
    if n <= 0:
        return
    caller = torch.cuda.current_stream(dev)
    stream = capture_stream(dev)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        unit(0)  # eager, the warm-up
        if after is not None:
            after(0)
        if n > 1:
            # Captured while unit 0 still runs on the card: the replays
            # follow it on the stream.
            t0 = time.perf_counter()
            graph, record = torch.cuda.CUDAGraph(), LaunchRecord()
            for gen in generators:
                try:
                    graph.register_generator_state(gen)
                except (AttributeError, RuntimeError) as exc:
                    raise RuntimeError(f"{name}: cannot register its generator with the CUDA graph: {exc}") from exc
            with _CAPTURE_LOCK, record:
                pool = None
                try:
                    pool = graph_pool(dev)
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        unit(1)
                    finally:
                        graph.capture_end()
                except Exception as exc:
                    if pool is not None:
                        abandon_graph_pool(dev, pool)
                    raise RuntimeError(f"{name}: the CUDA graph capture failed: {exc}") from exc
            if report is not None:
                report.update(compile_s=time.perf_counter() - t0, compile_source="capture")
            with torch.profiler.record_function(span):  # the replays' span in a trace
                for i in range(1, n):
                    if refill is not None:
                        refill(i)
                    try:
                        graph.replay()
                    except Exception as exc:
                        raise RuntimeError(f"{name}: replay {i} of the CUDA graph failed: {exc}") from exc
                    record.replayed()
                    if after is not None:
                        after(i)
            stream.synchronize()  # no replay runs when the graph is destroyed
            del graph  # the graph goes with the fit; its pool serves the next capture
    caller.wait_stream(stream)


def replay_epochs(
    name: str,
    epoch: Callable[[torch.Tensor, torch.Tensor, tuple | None], None],
    n: int,
    bias: torch.Tensor,
    losses: torch.Tensor,
    schedule: tuple[torch.Tensor, ...] | None,
    generator: torch.Generator,
    report: dict,
    span: str,
) -> None:
    """The ``n`` epochs of an Adam fit by :func:`replay_loop`, an epoch a
    unit: ``epoch(bias_rows, loss_out, draws)`` enqueues one epoch whose
    steps take Adam's bias corrections from ``bias_rows`` (steps, 2),
    writes its mean loss into ``loss_out`` (1,), and reads its random draws
    from ``draws`` (one epoch's slice of each tensor of ``schedule``), or
    draws them from ``generator`` where ``schedule`` is None. ``bias`` is
    the fit's (n * steps, 2) table (``ops.sgns.bias_table``), ``losses``
    its (n,) per-epoch losses, ``schedule`` tensors with a leading epoch
    axis. Epoch 0 reads them in place; the captured epoch reads static
    copies, refilled before each replay with that epoch's rows, and its
    loss slot is copied into ``losses`` after it."""
    if n <= 0:
        return
    steps = bias.shape[0] // n
    static_bias = bias[:steps].clone()
    loss_slot = torch.zeros_like(losses[:1])
    draws = None if schedule is None else tuple(t[0].clone() for t in schedule)

    def unit(e):
        if e == 0:
            epoch(bias[:steps], losses[:1], None if schedule is None else tuple(t[0] for t in schedule))
        else:
            epoch(static_bias, loss_slot, draws)

    def refill(e):
        static_bias.copy_(bias[e * steps:(e + 1) * steps])
        for static, t in zip(draws or (), schedule or ()):
            static.copy_(t[e])

    def after(e):
        if e:
            losses[e:e + 1].copy_(loss_slot)

    replay_loop(name, losses.device, unit, n, refill=refill, after=after, generators=(generator,), report=report,
                span=span)
