"""Ragged -> dense bucketing for fixed-shape sparse row access.

The ALS sweep needs, per user (or per item on the alternate sweep), the dense
gather indices and ratings of that row's nonzeros. Row lengths follow a power
law, so one global pad-to-max would waste most of the FLOPs. Instead rows are
sorted by length and chunked into fixed-size batches, each padded to its own
power-of-two-ish length: O(log max_len) distinct (batch, length) shapes.

This numpy code is a verbatim copy of the JAX package's layout, so the
buckets and landing permutations are byte-identical between the two packages
(pinned by ``tests/test_torch_datasets.py``). Only :func:`to_device` is new:
it moves a bucket's arrays onto a torch device.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch


def segment_positions(counts: np.ndarray) -> np.ndarray:
    """0..count-1 position indices within each segment of a flat ragged array.

    For ``counts = [3, 2]`` returns ``[0, 1, 2, 0, 1]``. The shared idiom for
    walking concatenated per-user / per-sentence segments without a Python
    loop (used by the negative balancer and the skip-gram pair builder).
    """
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A fixed-shape batch of padded rows.

    ``row_ids[b]`` is the dense row index this slot solves for; padding slots
    have ``row_ids == -1``. ``idx/val`` are ``(B, L)`` with ``val == 0`` on pads
    (so confidence weights vanish); ``idx`` points at row 0 on pads, which is
    harmless under a zero weight.
    """

    row_ids: np.ndarray  # (B,) int32, -1 for padding slots
    idx: np.ndarray      # (B, L) int32 column indices
    val: np.ndarray      # (B, L) float32 ratings, 0 on padding
    mask: np.ndarray     # (B, L) bool

    @property
    def shape(self) -> tuple[int, int]:
        return self.idx.shape  # type: ignore[return-value]


def _pad_len(n: int, multiple: int) -> int:
    """Round up to the next length tier.

    Tiers are powers of two up to ``2 * multiple``, then ~1.15x geometric
    steps rounded up to ``multiple``. Pure power-of-two tiers cost up to 2x
    padding per row (measured 2.7x overall on the bench matrix); 1.15x steps
    bound per-row waste at ~15% (bench-matrix total overhead 1.48x vs 1.52x
    at 1.25x steps) while keeping the distinct-shape count (and therefore
    kernel-launch count) logarithmic in max_len (~33 shapes per sweep).
    """
    t = 1
    while t < n and t < 2 * multiple:
        t *= 2
    while t < n:
        nxt = ((int(t * 1.15) + multiple - 1) // multiple) * multiple
        t = max(nxt, t + multiple)  # strict growth even when rounding truncates
    return t


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One bucket's layout, decided before any array is filled.

    Splitting planning (a cheap sequential scan over the length-sorted rows)
    from filling (per-bucket NumPy scatters that release the GIL) is what lets
    the cold-path pipeline fill buckets on a thread pool and upload finished
    shape groups while later ones are still being packed — the plan fixes the
    exact same chunk boundaries and tier shapes the sequential path produces,
    so the filled buckets are byte-identical however they are scheduled.
    """

    rows: np.ndarray         # (n_take,) dense row ids, length-sorted chunk order
    shape: tuple[int, int]   # (B, L) allocated slot/length tiers
    cap: int                 # per-row entry cap (pad length or max_len)


def _slot_tier(n: int) -> int:
    """Quantize a bucket's slot count: powers of two up to 1024, then
    1024-multiples — the same tiers :func:`plan_buckets` allocates."""
    if n > 1024:
        return -(-n // 1024) * 1024
    return 1 << max(0, (n - 1).bit_length())


def coalesce_buckets(
    buckets,
    batch_size: int = 1024,
    max_entries: int | None = None,
):
    """Stream-merge same-width partial buckets into full ones.

    Out-of-core generation (``datasets.synthetic.generate_scale_dataset``)
    packs each user chunk independently, so every length tier ends in a
    partial bucket PER CHUNK — at n chunks the half-sweep dispatches ~n
    buckets per tier where one would do, and per-dispatch overhead grows
    linearly with the user count. This generator merges valid rows of
    same-``L`` buckets as they stream past, emitting full
    ``min(batch_size, max_entries // L)``-row buckets and flushing the
    per-tier remainders at the end (slot counts re-quantized to the
    planner's own tiers, so the merged shapes come from the same shape
    universe the capacity model prices).

    Numerically invisible by construction: every row keeps its exact
    entries and pad width (only same-``L`` buckets merge), each row still
    appears in exactly one bucket, and within-half-sweep bucket order is
    already irrelevant to the solves — pinned by the scale-harness parity
    tests. Host cost is one concatenation pass (~bytes of the slabs);
    what it buys is an ~n-fold cut in dispatch count on chunked data.
    """
    pending: dict[int, list] = {}  # L -> [row_ids, idx, val, mask] valid-only

    def build(parts, n_lo, n_hi, length, allowed):
        """One padded bucket from pending[L] rows [n_lo:n_hi)."""
        n = n_hi - n_lo
        b = max(n, min(_slot_tier(n), allowed))
        out = Bucket(
            row_ids=np.full((b,), -1, dtype=np.int32),
            idx=np.zeros((b, length), dtype=np.int32),
            val=np.zeros((b, length), dtype=np.float32),
            mask=np.zeros((b, length), dtype=bool),
        )
        out.row_ids[:n] = parts[0][n_lo:n_hi]
        out.idx[:n] = parts[1][n_lo:n_hi]
        out.val[:n] = parts[2][n_lo:n_hi]
        out.mask[:n] = parts[3][n_lo:n_hi]
        return out

    for bk in buckets:
        length = int(bk.idx.shape[1])
        allowed = batch_size
        if max_entries is not None:
            allowed = max(1, min(batch_size, max_entries // max(1, length)))
        valid = int((bk.row_ids >= 0).sum())  # fills front-pack valid rows
        if length not in pending and valid == bk.row_ids.shape[0] == allowed:
            yield bk  # already a full canonical bucket: pass through, no copy
            continue
        parts = pending.get(length)
        if parts is None:
            parts = pending[length] = [
                bk.row_ids[:valid], bk.idx[:valid], bk.val[:valid], bk.mask[:valid]
            ]
        else:
            for i, arr in enumerate(
                (bk.row_ids[:valid], bk.idx[:valid], bk.val[:valid], bk.mask[:valid])
            ):
                parts[i] = np.concatenate([parts[i], arr])
        n_have = parts[0].shape[0]
        lo = 0
        while n_have - lo >= allowed:
            yield build(parts, lo, lo + allowed, length, allowed)
            lo += allowed
        if lo:
            for i in range(4):
                parts[i] = parts[i][lo:]
            if parts[0].shape[0] == 0:
                del pending[length]
    for length, parts in sorted(pending.items()):
        n = parts[0].shape[0]
        if not n:
            continue
        allowed = batch_size
        if max_entries is not None:
            allowed = max(1, min(batch_size, max_entries // max(1, length)))
        yield build(parts, 0, n, length, allowed)


def plan_buckets(
    indptr: np.ndarray,
    batch_size: int = 1024,
    len_multiple: int = 8,
    max_len: int | None = None,
    max_entries: int | None = None,
) -> list[BucketPlan]:
    """Chunk CSR rows into fixed-shape bucket layouts (no fills yet).

    Rows are sorted by nonzero count so batch-mates have similar lengths; each
    batch is padded to a power-of-two-ish length (bounded padding waste,
    bounded compile count). ``max_entries`` bounds ``B * L`` per bucket so the
    downstream ``(B, L, rank)`` factor gather fits in device memory. Empty
    rows are skipped: ALS leaves those factors at their current value,
    matching cold-start behavior.
    """
    lengths = np.diff(indptr)
    nonempty = np.nonzero(lengths > 0)[0]
    # Stable sort by length keeps determinism across runs.
    order = nonempty[np.argsort(lengths[nonempty], kind="stable")]
    eff = lengths[order]
    if max_len is not None:
        eff = np.minimum(eff, max_len)

    def tier(n: int) -> int:
        pad_l = _pad_len(n, len_multiple)
        if max_len is not None:
            # Don't let tier rounding blow past the explicit bound.
            pad_l = min(pad_l, -(-max_len // len_multiple) * len_multiple)
            pad_l = max(pad_l, n)
        return pad_l

    plans: list[BucketPlan] = []
    start = 0
    n_rows = order.shape[0]
    while start < n_rows:
        # One bucket = consecutive (length-sorted) rows within one length tier,
        # so no row pads more than one tier up (~15%); slots are allocated for
        # the rows actually present (next power of two), so a tail bucket of a
        # few very long rows doesn't burn batch_size slots of padding.
        pad_l = tier(int(eff[start]))
        allowed = batch_size
        if max_entries is not None:
            allowed = max(1, min(batch_size, max_entries // pad_l))
        end = start
        while end < n_rows and end - start < allowed and eff[end] <= pad_l:
            end += 1
        n_take = end - start
        # Slot-count tiers (`_slot_tier`, ONE definition — the streaming
        # coalescer re-quantizes merged buckets through the same rule):
        # powers of two up to 1024, then 1024-multiples. Pure pow-2
        # rounding wastes up to 2x SOLVE slots per bucket once batches are
        # wide (measured +20% padded entries at batch_size=8192);
        # 1024-steps bound slot waste at ~12% with a still-small shape count.
        b = _slot_tier(n_take)
        # Never exceed the caller's slot budget (or entry budget): tier
        # rounding quantizes shapes but must not grow the bucket past them.
        b = max(n_take, min(b, allowed))
        cap = pad_l if max_len is None else min(pad_l, max_len)
        plans.append(BucketPlan(rows=order[start:end], shape=(b, pad_l), cap=cap))
        start = end
    return plans


def fill_bucket(
    plan: BucketPlan,
    indptr: np.ndarray,
    indices: np.ndarray,
    vals: np.ndarray,
    out: Bucket | None = None,
) -> Bucket:
    """Execute one plan's scatter fill. ``out`` (zero-initialized arrays,
    ``row_ids`` pre-filled with -1 — possibly views into a preallocated group
    slab) lets the grouped builder fill stacked arrays in place, skipping the
    ``np.stack`` copy the group step used to pay."""
    b, pad_l = plan.shape
    if out is None:
        out = Bucket(
            row_ids=np.full((b,), -1, dtype=np.int32),
            idx=np.zeros((b, pad_l), dtype=np.int32),
            val=np.zeros((b, pad_l), dtype=np.float32),
            mask=np.zeros((b, pad_l), dtype=bool),
        )
    chunk = plan.rows
    n_take = chunk.shape[0]
    # Vectorized slot fill (one scatter per bucket, no per-row Python):
    # rows over cap keep their TAIL = most recent entries in insert order.
    hi = indptr[chunk + 1].astype(np.int64)
    take = np.minimum(hi - indptr[chunk].astype(np.int64), plan.cap)
    pos = segment_positions(take)
    slot_of = np.repeat(np.arange(n_take), take)
    flat = np.repeat(hi - take, take) + pos
    out.row_ids[:n_take] = chunk
    out.idx[slot_of, pos] = indices[flat]
    out.val[slot_of, pos] = vals[flat]
    out.mask[slot_of, pos] = True
    return out


def bucket_rows(
    indptr: np.ndarray,
    indices: np.ndarray,
    vals: np.ndarray,
    batch_size: int = 1024,
    len_multiple: int = 8,
    max_len: int | None = None,
    max_entries: int | None = None,
    workers: int | None = None,
) -> list[Bucket]:
    """Chunk CSR rows into fixed-shape padded batches (plan + fill).

    Rows longer than ``max_len`` are truncated to their most recent
    ``max_len`` entries, mirroring the reference's ``maxStarredReposCount``
    cap (``LogisticRegressionRanker.scala:133``).

    With ``workers`` > 1 the per-bucket scatter fills run on a thread pool
    (they are pure NumPy and release the GIL); the bucket list is returned in
    plan order either way, so the output is byte-identical to the sequential
    path — enforced by the parity test.
    """
    plans = plan_buckets(
        indptr, batch_size=batch_size, len_multiple=len_multiple,
        max_len=max_len, max_entries=max_entries,
    )

    def fill(p: BucketPlan) -> Bucket:
        return fill_bucket(p, indptr, indices, vals)

    if workers and workers > 1 and len(plans) > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(fill, plans))
    return [fill(p) for p in plans]


def grouped_bucket_rows(
    indptr: np.ndarray,
    indices: np.ndarray,
    vals: np.ndarray,
    batch_size: int = 1024,
    len_multiple: int = 8,
    max_len: int | None = None,
    max_entries: int | None = None,
    workers: int | None = None,
    on_group: Callable[[int, Bucket], None] | None = None,
) -> list[Bucket]:
    """Plan, group by shape, and fill straight into the stacked group slabs.

    Byte-identical to ``group_buckets(bucket_rows(...))`` (parity-tested) but
    with one less full copy of the data: each bucket's scatter fill writes
    directly into its ``(N, B, L)`` group slab slice instead of filling a
    standalone bucket that ``np.stack`` then copies.

    ``on_group(i, group)`` fires in shape-sorted group order as soon as group
    ``i``'s fills complete — the hook the cold-path pipeline uses to start the
    (async) host->device upload of a finished group while the thread pool is
    still filling later ones.
    """
    plans = plan_buckets(
        indptr, batch_size=batch_size, len_multiple=len_multiple,
        max_len=max_len, max_entries=max_entries,
    )
    by_shape: dict[tuple[int, int], list[BucketPlan]] = {}
    for p in plans:
        by_shape.setdefault(p.shape, []).append(p)
    ordered = sorted(by_shape.items())

    groups: list[Bucket] = []
    tasks: list[tuple[int, int, BucketPlan]] = []
    for gi, ((b, pad_l), ps) in enumerate(ordered):
        n = len(ps)
        groups.append(
            Bucket(
                row_ids=np.full((n, b), -1, dtype=np.int32),
                idx=np.zeros((n, b, pad_l), dtype=np.int32),
                val=np.zeros((n, b, pad_l), dtype=np.float32),
                mask=np.zeros((n, b, pad_l), dtype=bool),
            )
        )
        tasks.extend((gi, si, p) for si, p in enumerate(ps))

    def fill(task: tuple[int, int, BucketPlan]) -> None:
        gi, si, p = task
        g = groups[gi]
        fill_bucket(
            p, indptr, indices, vals,
            out=Bucket(row_ids=g.row_ids[si], idx=g.idx[si], val=g.val[si], mask=g.mask[si]),
        )

    if workers and workers > 1 and len(tasks) > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures: dict[int, list] = {}
            for task in tasks:
                futures.setdefault(task[0], []).append(pool.submit(fill, task))
            # Groups complete roughly in submission order; notifying in shape
            # order lets the caller upload group 0 while group N still fills.
            for gi in range(len(groups)):
                for f in futures.get(gi, []):
                    f.result()
                if on_group is not None:
                    on_group(gi, groups[gi])
    else:
        done = 0
        for gi in range(len(groups)):
            while done < len(tasks) and tasks[done][0] == gi:
                fill(tasks[done])
                done += 1
            if on_group is not None:
                on_group(gi, groups[gi])
    return groups


def padded_rows(
    indptr: np.ndarray, indices: np.ndarray, rows: np.ndarray, fill: int = -1
) -> np.ndarray:
    """Gather CSR rows into one ``(len(rows), max_len)`` dense array, padded
    with ``fill`` — fully vectorized (no per-row Python loop).

    The seen-item exclusion mask of the retrieval path (the PySpark track's
    ``recommend_items`` exclusion, ``albedo_toolkit/common.py:47-71``) is this
    gather over the requested users.
    """
    rows = np.asarray(rows)
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    width = max(1, int(lens.max())) if rows.size else 1
    out = np.full((rows.size, width), fill, dtype=np.int32)
    pos = segment_positions(lens)
    out_rows = np.repeat(np.arange(rows.size), lens)
    flat = np.repeat(indptr[rows].astype(np.int64), lens) + pos
    out[out_rows, pos] = indices[flat]
    return out


def group_buckets(buckets: list[Bucket]) -> list[Bucket]:
    """Stack same-shape buckets along a new leading axis: ``(B, L)`` buckets
    become ``(N, B, L)`` "groups" (still ``Bucket``s, with ``row_ids`` of shape
    ``(N, B)``).

    A half-sweep over groups launches one kernel per distinct shape instead
    of one per bucket (``ops.als.half_sweep``), where the reference pays a
    Spark shuffle per block per sweep.

    Stacked arrays are preallocated and filled slice-by-slice (no ``np.stack``
    temporaries); ``grouped_bucket_rows`` goes one step further and scatters
    fills directly into the slabs, never materializing per-bucket arrays.
    """
    by_shape: dict[tuple[int, int], list[Bucket]] = {}
    for b in buckets:
        by_shape.setdefault(b.shape, []).append(b)

    def stack(arrays: list[np.ndarray]) -> np.ndarray:
        out = np.empty((len(arrays),) + arrays[0].shape, dtype=arrays[0].dtype)
        for i, a in enumerate(arrays):
            out[i] = a
        return out

    return [
        Bucket(
            row_ids=stack([b.row_ids for b in bs]),
            idx=stack([b.idx for b in bs]),
            val=stack([b.val for b in bs]),
            mask=stack([b.mask for b in bs]),
        )
        for _, bs in sorted(by_shape.items())
    ]


def to_device(b: Bucket, device) -> Bucket:
    """One-time host->device copy of a bucket's arrays as torch tensors
    (``row_ids``/``idx`` int32, ``val`` float32, ``mask`` bool)."""
    return Bucket(
        row_ids=torch.as_tensor(b.row_ids).to(device),
        idx=torch.as_tensor(b.idx).to(device),
        val=torch.as_tensor(b.val).to(device),
        mask=torch.as_tensor(b.mask).to(device),
    )
