"""CUDA graphs of a fit's loop: the capture and replay that the whole-loop
programs share (K16 the ALS fit, ``ops/als.py fit_loop``; K17 the Word2Vec
epoch, ``models/word2vec.py``; K18 the BPR fit,
``models/ranking_factorization.py``, both through :func:`replay_epochs`; LR's
Adam steps, ``models/logistic_regression.py``; K19 the L-BFGS fits, through
:func:`replay_while`).

A fit's loop is ``n`` units of identical work (an ALS iteration, an epoch).
:func:`replay_loop` runs unit 0 eagerly on the thread's capture stream (the
warm-up: kernels built and planned, cuBLAS's workspace, first-use
allocations), captures one unit, and replays it ``n - 1`` times, so the host
enqueues a replay a unit, not a kernel call at a time. Everything that
differs between units reaches the graph through static buffers the caller
refills before each replay (a Python value read during the capture is fixed
in the graph). The launches the capture records are counted once a replay
(:class:`~albedo_tpu_torch.kernels.build.LaunchRecord`).

A loop whose units decide on the card whether they run (the L-BFGS fits:
each iteration's line-search trials and stop test) goes through
:func:`replay_while`: unit 0 eagerly, then a block of units whose pieces
sit under conditional nodes, replayed while a device flag holds, the host
reading that flag once a block.

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


def _capture(name: str, dev: torch.device, graph: torch.cuda.CUDAGraph, record: LaunchRecord,
             enqueue: Callable[[], None]) -> None:
    """Capture what ``enqueue()`` enqueues on the current (capture) stream
    into ``graph``, in this thread's pool, its launches into ``record``.
    Called under ``_CAPTURE_LOCK``. A failed capture abandons the pool and
    raises ``RuntimeError`` naming the fit."""
    pool = None
    with record:
        try:
            pool = graph_pool(dev)
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                enqueue()
            finally:
                graph.capture_end()
        except Exception as exc:
            if pool is not None:
                abandon_graph_pool(dev, pool)
            raise RuntimeError(f"{name}: the CUDA graph capture failed: {exc}") from exc


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
    run inside a ``torch.profiler`` span named ``span``, which closes once
    the card has run them; ``name`` names the fit in errors. When it returns, the caller's stream waits for the
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
            graph, record = torch.cuda.CUDAGraph(), LaunchRecord(stream.cuda_stream)
            for gen in generators:
                try:
                    graph.register_generator_state(gen)
                except (AttributeError, RuntimeError) as exc:
                    raise RuntimeError(f"{name}: cannot register its generator with the CUDA graph: {exc}") from exc
            with _CAPTURE_LOCK:
                _capture(name, dev, graph, record, lambda: unit(1))
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
                stream.synchronize()  # no replay runs when the graph is destroyed, nor after the span closes
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


def replay_while(
    name: str,
    dev: torch.device,
    first: Callable[[], None],
    unit: Callable[[Callable], None],
    flag: torch.Tensor,
    max_units: int,
    resume,
    per_read: int,
    *,
    report: dict | None = None,
    span: str = "replay_while.replays",
) -> int:
    """Run a loop whose units decide on the card whether they run:
    ``first()`` enqueues the first unit's pieces before the one keyed
    ``resume``, eagerly (the warm-up); then one unit is captured once as a
    CUDA graph, the first unit's pieces from ``resume`` on run from a graph
    of their own, and the unit is launched up to ``max_units`` times, in
    blocks of ``per_read`` launches, while the 0-d device bool ``flag``
    holds after a block. Returns the blocks launched: the host reads of
    ``flag``.

    ``unit(when)`` enqueues a unit as pieces, each ``when(pred, key, fn)``:
    ``fn()`` enqueues the piece's work, which runs on the card only where
    the 0-d device bool ``pred`` holds when the unit reaches it (a piece that
    does not run leaves memory as it is). Each piece is captured as a CUDA
    graph of its own, and the unit's graph chains them, each under an IF
    conditional node (built by ``kernels/csrc/cond_graph.cu``: torch 2.11
    has none) whose switch also counts its runs. What a piece leaves for a
    later one must be in memory allocated before the unit; a Python value
    ``fn`` reads is fixed at capture. Each piece's launches are recorded at
    its capture and counted once for each of its runs, read from the card
    after the last block. ``report``, if given, gets ``compile_s``
    (capturing the pieces, building, instantiating and uploading the
    graphs), ``compile_source`` (``"capture"``), ``pieces``, ``blocks`` and
    ``key_runs`` (each piece's runs, by its ``key``). The launches run inside a
    ``torch.profiler`` span named ``span``, which closes after the last read
    of ``flag``, once the card has run them; ``name`` names the fit in
    errors; ``report`` also gets ``piece_nodes``, each piece's graph nodes
    by its key joined with "/". When it returns, the caller's stream waits
    for the loop's work."""
    import ctypes

    from albedo_tpu_torch.kernels.build import library

    caller = torch.cuda.current_stream(dev)
    stream = capture_stream(dev)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        first()
        t0 = time.perf_counter()
        lib = library("cond_graph")
        _P = ctypes.c_void_p
        lib.cond_graph_build.argtypes = [ctypes.c_int, _P, _P, _P, _P, _P, _P]
        lib.cond_graph_launch.argtypes = [_P, _P]
        lib.cond_graph_destroy.argtypes = [_P, _P]
        lib.cond_graph_nodes.argtypes = [_P, ctypes.POINTER(ctypes.c_size_t)]
        pieces: list[tuple[torch.Tensor, object, torch.cuda.CUDAGraph, LaunchRecord]] = []

        def when(pred: torch.Tensor, key, fn: Callable[[], None]) -> None:
            graph, record = torch.cuda.CUDAGraph(keep_graph=True), LaunchRecord(stream.cuda_stream)
            with _CAPTURE_LOCK:
                _capture(name, dev, graph, record, fn)
            pieces.append((pred, key, graph, record))

        unit(when)
        piece_nodes = {}
        for _, key, graph, _ in pieces:
            count = ctypes.c_size_t()
            if lib.cond_graph_nodes(graph.raw_cuda_graph(), ctypes.byref(count)) == 0:
                piece_nodes["/".join(map(str, key))] = count.value
        runs = torch.zeros(len(pieces), dtype=torch.int32, device=dev)
        execs = []  # (exec, graph): the unit's, then the first unit's rest

        def chain(start: int) -> None:
            exec_, parent = _P(), _P()
            part = pieces[start:]
            bodies = (_P * len(part))(*(g.raw_cuda_graph() for _, _, g, _ in part))
            preds = (_P * len(part))(*(p.data_ptr() for p, _, _, _ in part))
            rc = lib.cond_graph_build(len(part), bodies, preds, runs[start:].data_ptr(), stream.cuda_stream,
                                       ctypes.byref(exec_), ctypes.byref(parent))
            if rc != 0:
                raise RuntimeError(f"{name}: building the CUDA graph of its conditional pieces failed: "
                                   f"cudaError {rc}")
            execs.append((exec_, parent))

        def launch(exec_, what: str) -> None:
            rc = lib.cond_graph_launch(exec_, stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launching its CUDA graph ({what}) failed: cudaError {rc}")

        n = blocks = 0
        try:
            chain(0)
            chain([key for _, key, _, _ in pieces].index(resume))
            if report is not None:
                report.update(compile_s=time.perf_counter() - t0, compile_source="capture", pieces=len(pieces),
                              piece_nodes=piece_nodes)
            with torch.profiler.record_function(span):  # the launches' span in a trace
                launch(execs[1][0], "the first unit's rest")
                while n < max_units:
                    for _ in range(min(per_read, max_units - n)):
                        launch(execs[0][0], f"unit {n + 1}")
                        n += 1
                    blocks += 1
                    if not bool(flag):
                        break
            key_runs: dict = {}
            for (_, key, _, record), times in zip(pieces, runs.tolist()):
                record.replayed(times)
                key_runs[key] = key_runs.get(key, 0) + times
        finally:
            stream.synchronize()  # nothing runs when the graphs are destroyed
            for exec_, parent in execs:
                lib.cond_graph_destroy(exec_, parent)
        if report is not None:
            report.update(blocks=blocks, key_runs=key_runs)
        del pieces  # the pieces' graphs go with the fit; their pool serves the next capture
    caller.wait_stream(stream)
    return blocks
