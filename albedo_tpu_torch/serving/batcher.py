"""Dynamic micro-batcher: coalesce concurrent top-k requests into one launch.

Port of ``albedo_tpu/serving/batcher.py``. N concurrent requests for the
same factor tables are one batch away from each other: a background worker
collects them and answers the batch with one K6 launch
(``ops.topk.gather_topk``), which gathers the users' factor rows and
exclusion rows on the card and streams the item table once per user.

Mechanics:

- ``submit()`` enqueues ``(dense_user, k, exclude_row)`` and returns a
  ``concurrent.futures.Future``; the HTTP thread blocks on it.
- The worker pulls the first waiting request, drains whatever else is
  queued, and only when the batch would be a singleton waits up to
  ``window_ms`` for company.
- Collected requests are grouped by ``(pow2(k), exclusion mode)`` and each
  group is padded to a **power-of-two user bucket** (user 0 repeated;
  padded rows are computed and discarded). ``k`` is rounded up to a power
  of two and each request's row is sliced back to its own ``k``: the first
  j of an exact top-K are the exact top-j (same scores, same
  value-desc/index-asc tie rule at any width).
- One K6 launch and one device-to-host copy per group: the kernel writes
  the scores and the index bits into one (2, B, k) buffer. No request
  synchronizes on its own.
- ``warm()`` builds the kernels and makes one launch per (bucket, k, mode)
  of the ladder at startup, so no request pays the ``nvcc`` build or a
  first launch.
- Bounded queue: ``submit`` on a full queue raises :class:`QueueOverflow`
  (the HTTP layer turns it into a 429) with a ``Retry-After`` estimate
  priced from queue depth at the observed (EWMA) batch latency, scaled by
  the overload controller's admission limit and brownout level when one
  is attached (``overload=``): its AIMD limit is consulted on every submit,
  fed batch latency and head-of-queue sojourn after every batch, and its
  CoDel law sheds the oldest-lapsed queued work when standing delay builds.
- Deadline-aware admission control: a request whose ``deadline`` lapses
  while it queues is shed (:class:`DeadlineExceeded`, also a 429) before
  the worker spends a launch on it.

Parity: a batched answer is byte-identical to the single-request path
(``ALSModel.recommend``, K5). K6 runs K5's body on each user's row with the
same arithmetic, and a row's result does not depend on the rest of its
launch; the exclusion width only pads the sorted list. Pinned by
``tests/test_torch_serving_batcher.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from albedo_tpu_torch.models.als import ALSModel
from albedo_tpu_torch.ops.topk import EXCLUDE_MAX, gather_topk
from albedo_tpu_torch.serving.overload import tier_name
from albedo_tpu_torch.utils import pow2_at_least as _pow2_bucket

log = logging.getLogger(__name__)


class QueueOverflow(RuntimeError):
    """The batcher's bounded request queue is full — shed load upstream.

    ``retry_after_s`` (when set) is the batcher's estimate of when capacity
    returns — queue depth priced at the observed batch latency — which the
    HTTP layer surfaces as the 429's ``Retry-After`` header. ``tier`` /
    ``level`` carry the brownout ladder position that shed the request (when
    the overload layer did), so the 429 body can tag the degradation tier.
    """

    def __init__(
        self,
        message: str,
        retry_after_s: float | None = None,
        tier: str | None = None,
        level: int | None = None,
    ):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.tier = tier
        self.level = level


class DeadlineExceeded(QueueOverflow):
    """Admission control: the request's deadline expired while it waited in
    the queue. Computing its batch anyway would burn device time producing
    an answer the client has already abandoned — shed it instead (HTTP 429,
    same contract as queue overflow: come back later, with ``Retry-After``).
    """


class BatcherClosed(RuntimeError):
    """submit() raced a shutdown — the caller should re-resolve the current
    engine generation and retry, not fail the request."""


@dataclasses.dataclass
class _Request:
    dense_user: int
    k: int
    # None = no exclusion; True = device-table exclusion; ndarray = host row.
    exclude: "np.ndarray | bool | None"
    future: Future
    # Admission control: monotonic deadline; the worker sheds the request
    # instead of computing it if the deadline passes while it queues.
    deadline: float | None = None
    # Monotonic enqueue timestamp: the CoDel discipline sheds on the oldest
    # request's sojourn, and the worker reports head-of-queue wait per batch.
    enqueued_at: float = 0.0


_SENTINEL = object()


def _resolve(fut: Future, value=None, exc: BaseException | None = None) -> bool:
    """Resolve a request future, tolerating a client-side cancel racing the
    done() check (a deadline_ms caller cancels from the HTTP thread).
    Returns True if THIS call resolved the future."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
        return True
    except InvalidStateError:
        return False


class MicroBatcher:
    """Background coalescing worker over a trained :class:`ALSModel`.

    ``exclude_table`` (every user's -1-padded history, host numpy) is
    uploaded once; requests then pass ``exclude=True`` and K6 reads their
    rows on the card. Without it, requests carry their own rows, padded per
    batch to ``excl_width`` rounded up to a power of two. A width the kernel
    cannot sort (over ``ops.topk.EXCLUDE_MAX``) raises here: a clipped row
    would serve items the user already starred.
    """

    def __init__(
        self,
        model: ALSModel,
        exclude_table: np.ndarray | None = None,
        excl_width: int = 0,
        max_batch: int = 64,
        max_queue: int = 256,
        window_ms: float = 2.0,
        metrics=None,
        overload=None,
    ):
        self.model = model
        self._uf, self._vf = model.device_factors()
        self._device = self._uf.device
        self._excl_dev: torch.Tensor | None = None
        if exclude_table is not None:
            table = np.ascontiguousarray(exclude_table, dtype=np.int32)
            self.excl_width = int(table.shape[1])  # exact table width
        else:
            self.excl_width = _pow2_bucket(excl_width) if excl_width else 0
        if self.excl_width > EXCLUDE_MAX:
            raise ValueError(
                f"exclusion width {self.excl_width} exceeds the kernels' "
                f"{EXCLUDE_MAX}; clipping it would serve already-seen items"
            )
        if exclude_table is not None:
            self._excl_dev = torch.as_tensor(table).to(self._device)
        self.max_batch = max(1, _pow2_bucket(max_batch))
        self.window_s = float(window_ms) / 1e3
        self.metrics = metrics
        # Optional serving.overload.OverloadController, shared across model
        # generations by the service.
        self._overload = overload
        self._n_users = int(self._uf.shape[0])
        self._queue: "queue.Queue[_Request | object]" = queue.Queue(maxsize=max_queue)
        self._warmed_shapes: set[tuple[int, int, str]] = set()
        self._warm_lock = threading.Lock()
        self._stop = threading.Event()
        self._abort = threading.Event()
        # Guards the closed-check + enqueue in submit() against stop()'s
        # post-join drain: without it a submit could land its request AFTER
        # the drain, leaving a future nobody resolves. Held only for a
        # put_nowait.
        self._submit_lock = threading.Lock()
        self._closed = False
        # Worker-written, HTTP-thread-read statistics (batch counts, the
        # Retry-After EWMA) share one lock.
        self._stats_lock = threading.Lock()
        self.batches_run = 0
        self.requests_served = 0
        self.warmed = False
        # EWMA of batch execution latency (seconds) — prices the Retry-After
        # estimate; seeded pessimistically until the first real batch lands.
        self._ewma_batch_s = 0.05
        self._worker = threading.Thread(
            target=self._run, name="albedo-micro-batcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- public API

    @property
    def device_exclusion(self) -> bool:
        return self._excl_dev is not None

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def retry_after_s(self) -> float:
        """When should a shed client come back? Queue depth priced in batches
        at the observed batch latency, scaled by the overload layer's
        admission limit and brownout level; clamped to [1, 30] seconds."""
        depth = self._queue.qsize()
        batches_ahead = depth / self.max_batch + 1.0
        with self._stats_lock:
            ewma = self._ewma_batch_s
        base = batches_ahead * ewma
        if self._overload is not None:
            base = self._overload.price_retry_after(base, depth)
        return float(min(30.0, max(1.0, base)))

    def submit(
        self,
        dense_user: int,
        k: int,
        exclude: "np.ndarray | bool | None" = None,
        deadline: float | None = None,
    ) -> Future:
        """Enqueue one request; resolve to ``(scores (k,), item_idx (k,))``
        numpy arrays.

        ``exclude``: ``None`` scores all items; ``True`` uses the device
        exclusion table (requires one); an int32 row of seen item indices
        excludes host-side. ``deadline`` (``time.monotonic()`` timestamp)
        opts into admission control: a request still queued past its
        deadline is shed (:class:`DeadlineExceeded` on the future)."""
        if self._closed:
            raise BatcherClosed("batcher is shut down")
        if exclude is True and self._excl_dev is None:
            raise ValueError("exclude=True needs an exclude_table")
        if isinstance(exclude, np.ndarray) and exclude.size > self.excl_width:
            # Reject rather than silently truncate: a clipped exclusion row
            # would return already-seen items.
            raise ValueError(
                f"exclude row ({exclude.size}) wider than excl_width="
                f"{self.excl_width}; size the batcher to the longest history"
            )
        if not 0 <= int(dense_user) < self._n_users:
            raise IndexError(
                f"user index out of range [0, {self._n_users}): {dense_user}"
            )
        if self._overload is not None and not self._overload.admit(
            self._queue.qsize()
        ):
            # Adaptive admission shed: a 429 with honest pricing, never a
            # 5xx. Read the level once and derive the tier from it.
            if self.metrics is not None:
                self.metrics.shed.inc()
            lvl = self._overload.brownout_level
            raise QueueOverflow(
                "admission limit reached (adaptive overload control)",
                retry_after_s=self.retry_after_s(),
                tier=tier_name(lvl),
                level=lvl,
            )
        fut: Future = Future()
        req = _Request(
            int(dense_user), int(k), exclude, fut,
            deadline=deadline, enqueued_at=time.monotonic(),
        )
        try:
            with self._submit_lock:
                if self._closed:
                    raise BatcherClosed("batcher is shut down")
                self._queue.put_nowait(req)
        except queue.Full:
            if self.metrics is not None:
                self.metrics.shed.inc()
            if self._overload is not None:
                self._overload.count_shed()
            lvl = (
                self._overload.brownout_level
                if self._overload is not None else None
            )
            raise QueueOverflow(
                f"serving queue full ({self._queue.maxsize} waiting)",
                retry_after_s=self.retry_after_s(),
                tier=tier_name(lvl) if lvl is not None else None,
                level=lvl,
            ) from None
        return fut

    def warm(self, ks: tuple[int, ...] = (30,), with_exclusion: bool = True) -> dict:
        """Build the kernels and launch every (bucket, k, exclusion mode)
        shape of the ladder once, so no request pays the ``nvcc`` build or a
        first launch.

        Returns ``{(bucket, k, mode): source}``: ``build`` for the shape
        whose launch compiled the kernels, ``launch`` for a first launch
        here, ``memory`` for a shape warmed before."""
        from albedo_tpu_torch.kernels import build as kernel_build

        modes = {"none"}
        if with_exclusion:
            if self._excl_dev is not None:
                modes.add("device")
            elif self.excl_width:
                modes.add("host")
        sources: dict = {}
        built_here = False
        if self._device.type == "cuda" and "gather_topk" not in kernel_build._libs:
            t0 = time.perf_counter()
            kernel_build.build()
            built_here = True
            log.info("built the serving kernels (%.2fs)", time.perf_counter() - t0)
        k_ladder = sorted({_pow2_bucket(int(k)) for k in ks})
        bucket = 1
        with self._warm_lock:
            while bucket <= self.max_batch:
                for k in k_ladder:
                    for mode in sorted(modes):
                        key = (bucket, k, mode)
                        if key in self._warmed_shapes:
                            sources[key] = "memory"
                            continue
                        excl = (
                            np.full((bucket, self.excl_width), -1, dtype=np.int32)
                            if mode == "host" else None
                        )
                        self._launch(np.zeros(bucket, dtype=np.int32), k, mode, excl)
                        self._warmed_shapes.add(key)
                        sources[key] = "build" if built_here else "launch"
                        built_here = False
                bucket *= 2
        self.warmed = True
        return sources

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the worker. ``drain=True`` finishes queued work first;
        ``drain=False`` fails queued futures immediately."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        if not drain:
            self._abort.set()
        self._stop.set()
        # Nudge the worker out of its blocking get.
        try:
            self._queue.put_nowait(_SENTINEL)
        except queue.Full:
            pass
        self._worker.join(timeout=timeout)
        # Anything still queued after the join window fails loudly rather
        # than leaving HTTP threads blocked on futures nobody will resolve.
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(req, _Request):
                _resolve(req.future, exc=BatcherClosed("batcher shut down"))

    @property
    def mean_batch_size(self) -> float:
        with self._stats_lock:
            served, run = self.requests_served, self.batches_run
        return served / run if run else 0.0

    # ---------------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                if self._overload is not None:
                    # An empty queue is calm evidence: it lets the brownout
                    # ladder walk back down even when traffic stops entirely.
                    self._overload.idle_tick()
                continue
            if first is _SENTINEL:
                if self._stop.is_set() and self._queue.empty():
                    return
                continue
            # Self-clocking collection: drain whatever is already queued, and
            # only when the batch would be a singleton wait up to the window.
            batch = [first]
            self._drain_into(batch)
            if len(batch) == 1 and self.window_s > 0 and not self._stop.is_set():
                deadline = time.monotonic() + self.window_s
                while len(batch) == 1:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is not _SENTINEL:
                        batch.append(nxt)
                self._drain_into(batch)
            if self._abort.is_set():
                for req in batch:
                    _resolve(req.future, exc=BatcherClosed("batcher shut down"))
                continue
            batch = self._shed_expired(batch)
            batch = self._codel_shed(batch)
            if not batch:
                continue
            groups: dict[tuple[int, str], list[_Request]] = {}
            for req in batch:
                mode = (
                    "none" if req.exclude is None
                    else "device" if req.exclude is True
                    else "host"
                )
                groups.setdefault((_pow2_bucket(req.k), mode), []).append(req)
            for (k_exec, mode), reqs in groups.items():
                try:
                    self._execute(k_exec, mode, reqs)
                except Exception as e:  # noqa: BLE001 — fail the batch, not the worker
                    for req in reqs:
                        _resolve(req.future, exc=e)

    def _shed_expired(self, batch: list) -> list:
        """Admission control: fail requests whose deadline already passed
        rather than spending a launch on them."""
        now = time.monotonic()
        live: list[_Request] = []
        for req in batch:
            if req.deadline is not None and now >= req.deadline:
                # A lost _resolve race means the submitter already gave up
                # (it shed client-side and cancelled) — don't recount.
                if _resolve(req.future, exc=DeadlineExceeded(
                    "request deadline expired while queued",
                    retry_after_s=self.retry_after_s(),
                )):
                    if self.metrics is not None:
                        self.metrics.shed.inc()
                        self.metrics.deadline_shed.inc()
            else:
                live.append(req)
        return live

    def _codel_shed(self, batch: list) -> list:
        """CoDel queue discipline: when the OLDEST collected request's
        sojourn has stayed over target for a full interval, shed the
        oldest-lapsed work first at the ``interval/sqrt(count)`` cadence."""
        if self._overload is None or not batch:
            return batch
        # A batch that absorbed the whole queue IS the queue: its head
        # sojourn is batching + service latency, not standing delay. Only a
        # backlog the batch could not absorb engages the law; the drained
        # path feeds a zero sojourn so the controller resets.
        if self._queue.qsize() == 0 and len(batch) < self.max_batch:
            self._overload.codel_shed(0.0)
            return batch
        now = time.monotonic()
        while batch:
            head = min(batch, key=lambda r: r.enqueued_at)
            if not head.enqueued_at:
                break
            if not self._overload.codel_shed(now - head.enqueued_at):
                break
            batch.remove(head)
            lvl = self._overload.brownout_level
            if _resolve(head.future, exc=QueueOverflow(
                "shed standing queue delay (CoDel)",
                retry_after_s=self.retry_after_s(),
                tier=tier_name(lvl),
                level=lvl,
            )):
                if self.metrics is not None:
                    self.metrics.shed.inc()
        return batch

    def _drain_into(self, batch: list) -> None:
        while len(batch) < self.max_batch:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                return
            if nxt is not _SENTINEL:
                batch.append(nxt)

    def _launch(self, user_idx: np.ndarray, k: int, mode: str,
                excl: np.ndarray | None) -> tuple[np.ndarray, np.ndarray]:
        """One K6 launch for a bucket and one device-to-host copy of its
        (2, bucket, k) result: ``(scores, item_idx)`` numpy arrays."""
        dev = self._device
        out = torch.empty((2, user_idx.shape[0], k), dtype=torch.float32, device=dev)
        gather_topk(
            self._uf, self._vf, torch.from_numpy(user_idx).to(dev), k,
            exclude=None if excl is None else torch.from_numpy(excl).to(dev),
            exclude_table=self._excl_dev if mode == "device" else None,
            out=out,
        )
        host = out.cpu().numpy()
        return host[0], host[1].view(np.int32)

    def _execute(self, k: int, mode: str, reqs: list[_Request]) -> None:
        t0 = time.perf_counter()
        # Same clock as _Request.enqueued_at — head-of-queue sojourn at the
        # moment this batch started executing.
        dequeued_at = time.monotonic()
        bucket = _pow2_bucket(len(reqs))
        user_idx = np.zeros(bucket, dtype=np.int32)
        for i, req in enumerate(reqs):
            user_idx[i] = req.dense_user
        excl = None
        if mode == "host":
            excl = np.full((bucket, self.excl_width), -1, dtype=np.int32)
            for i, req in enumerate(reqs):
                row = req.exclude
                if isinstance(row, np.ndarray) and row.size:
                    excl[i, : row.size] = row
        vals, idx = self._launch(user_idx, k, mode, excl)
        for i, req in enumerate(reqs):
            # k was rounded up for the launch; each request gets exactly its
            # own top-k back (top-j == first j of top-K).
            _resolve(req.future, (vals[i, : req.k].copy(), idx[i, : req.k].copy()))
        batch_s = time.perf_counter() - t0
        with self._stats_lock:
            self.batches_run += 1
            self.requests_served += len(reqs)
            self._ewma_batch_s += 0.2 * (batch_s - self._ewma_batch_s)
        if self._overload is not None:
            # Outside the stats lock: the controller takes its own locks.
            stamps = [r.enqueued_at for r in reqs if r.enqueued_at]
            head_wait = max(0.0, dequeued_at - min(stamps)) if stamps else 0.0
            self._overload.observe_batch(batch_s, head_wait)
        if self.metrics is not None:
            self.metrics.batch_size.observe(len(reqs))
            self.metrics.batch_latency.observe(batch_s)
