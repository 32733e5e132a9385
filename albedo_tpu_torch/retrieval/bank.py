"""The embedding bank on one card: registration, build, query (K7).

Port of ``albedo_tpu/retrieval/bank.py``, single device. Every
embedding-backed candidate source is the same computation: score a query
vector against a row table, keep the top-k. The bank holds every such
source's table on the card and answers a batch of users per source with one
K7 launch (``ops.topk.bank_query``).

**Sources.** A :class:`BankSourceSpec` registers one source:

- ``kind="user_rows"``: the query vector is a row of a user table aligned
  with the serving matrix's dense user indices (ALS user factors; or the
  user table itself scored against the user table — user-to-user
  similarity).
- ``kind="item_mean"``: the query vector is the L2-normalized mean of
  example rows of the source's OWN table (content/tfidf More-Like-This:
  query by the user's recently starred repos; the query rows themselves
  are excluded from the results).

**Build.** ``build()`` uploads the tables, records per-source score
**calibration** (a deterministic host probe: the scale that maps each
source's raw top-1 scores onto ~1.0; queries return RAW scores, which is
what keeps bank-vs-host parity exact) and a content-hash ``version``.
Seen-item exclusion reads the SAME -1-padded exclusion table the serving
micro-batcher uploads; sources whose rows are not the matrix items carry a
remap table.

**Query.** One K7 launch per (source, batch of at most ``max_batch``
users): the kernel builds each query row (a user-table row, or the masked
mean of example rows) and streams the source table with the one-CTA-a-row
top-k body (``csrc/topk_body.cuh``).

**Overlay.** ``publish_user_rows`` lands freshly solved user rows into a
``user_rows`` source's table; the next query reads them.

Not ported yet (each raises ``NotImplementedError``): the mesh layout
(``build(mesh=...)``, ``reshard``, K15), ``save``/``load`` (waits for
``datasets/artifacts.py``) and the capacity admission (``build(budget=...,
generations=...)``, waits for ``utils/capacity.py``).

Fault sites: ``retrieval.build`` (head of the build step) and
``retrieval.query`` (head of every query batch); queries are counted per
source in ``albedo_retrieval_queries_total{source=}``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Callable

import numpy as np
import torch

from albedo_tpu_torch.ops.topk import bank_query
from albedo_tpu_torch.utils import events, faults
from albedo_tpu_torch.utils import pow2_at_least as _pow2
from albedo_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

BUILD_FAULT = faults.site("retrieval.build")
QUERY_FAULT = faults.site("retrieval.query")

KINDS = ("user_rows", "item_mean")


@dataclasses.dataclass
class BankSourceSpec:
    """One embedding source's registration.

    ``vectors`` is the scored table — (N, d) float32 host rows whose raw ids
    are ``item_ids``. ``user_vectors`` (``user_rows`` kind) is the query
    table, row-aligned with the serving matrix's dense user indices.
    ``query_items`` (``item_mean`` kind) maps a raw user id to the raw item
    ids whose rows form the query (e.g. the user's most recent stars).
    ``exclude_seen`` opts the source into the shared seen-item exclusion
    table (meaningful for ``user_rows`` sources whose candidates are
    catalog items).
    """

    name: str
    kind: str
    vectors: np.ndarray
    item_ids: np.ndarray
    user_vectors: np.ndarray | None = None
    query_items: Callable[[int], np.ndarray] | None = None
    exclude_seen: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown bank source kind {self.kind!r} (not in {KINDS})")
        self.vectors = np.asarray(self.vectors, dtype=np.float32)
        self.item_ids = np.asarray(self.item_ids, dtype=np.int64)
        if self.vectors.ndim != 2 or self.vectors.shape[0] != self.item_ids.shape[0]:
            raise ValueError(
                f"source {self.name!r}: vectors {self.vectors.shape} do not "
                f"row-align with item_ids {self.item_ids.shape}"
            )
        if self.kind == "user_rows":
            if self.user_vectors is None:
                raise ValueError(f"user_rows source {self.name!r} needs user_vectors")
            self.user_vectors = np.asarray(self.user_vectors, dtype=np.float32)
            if self.user_vectors.shape[1] != self.vectors.shape[1]:
                raise ValueError(
                    f"source {self.name!r}: user rank {self.user_vectors.shape[1]} "
                    f"!= item rank {self.vectors.shape[1]}"
                )


def _calibration(spec: BankSourceSpec, probe_rows: int = 32) -> dict:
    """Deterministic per-source score calibration, recorded at build time.

    Probes the first ``probe_rows`` query vectors (user rows, or the
    source's own normalized rows for item_mean) against the full table and
    records ``scale`` = 1 / median top-1 score — multiplying a source's raw
    scores by its scale puts every source's best-match at ~1.0, one shared
    scale for cross-source fusion. Row-norm stats ride along. Pure f32 host
    arithmetic on a bounded probe, as in the JAX package.
    """
    vf = spec.vectors
    norms = np.linalg.norm(vf, axis=1)
    if spec.kind == "user_rows":
        q = spec.user_vectors[: min(probe_rows, spec.user_vectors.shape[0])]
    else:
        q = vf[: min(probe_rows, vf.shape[0])]
        qn = np.linalg.norm(q, axis=1, keepdims=True)
        q = np.where(qn > 0, q / np.maximum(qn, 1e-9), 0.0)
    if q.shape[0] == 0 or vf.shape[0] == 0:
        scale = 1.0
    else:
        top1 = np.abs((q @ vf.T).max(axis=1))
        med = float(np.median(top1))
        scale = 1.0 / med if med > 1e-9 else 1.0
    return {
        "scale": round(float(scale), 8),
        "probe_rows": int(q.shape[0]),
        "row_norm_mean": round(float(norms.mean()) if norms.size else 0.0, 8),
        "row_norm_max": round(float(norms.max()) if norms.size else 0.0, 8),
    }


def mean_query_vectors(
    vectors: np.ndarray, q_mat: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side item_mean query assembly: masked mean of the query rows,
    L2-normalized; returns ``(queries (B, d) f32, has_query (B,) bool)``.
    The host twin of the query K7 builds (``ops.topk.mean_query_reference``
    repeats the kernel's order exactly; this numpy form agrees to float32
    round-off)."""
    valid = q_mat >= 0
    rows = vectors[np.clip(q_mat, 0, None)]
    w = valid.astype(np.float32)
    qv = (rows * w[..., None]).sum(axis=1)
    qv /= np.maximum(w.sum(axis=1, keepdims=True), 1.0)
    qv /= np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-9)
    return qv.astype(np.float32), valid.any(axis=1)


def _pad_k(vals: torch.Tensor, idx: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad a source's (B, k_each) answer to (B, k) with (-inf, -1)."""
    pad = k - vals.shape[1]
    if pad <= 0:
        return vals, idx
    return (torch.nn.functional.pad(vals, (0, pad), value=float("-inf")),
            torch.nn.functional.pad(idx, (0, pad), value=-1))


class RetrievalBank:
    """Registered embedding sources, one card-resident bank, one query path.

    Lifecycle: ``register_source()`` (host arrays) -> ``build()`` (upload,
    calibration, version stamp) -> ``query()`` / ``query_similar()`` /
    ``publish_user_rows()``.
    """

    def __init__(self, max_batch: int = 64, device: str | torch.device = "cuda"):
        self.max_batch = max(1, _pow2(int(max_batch)))
        self.device = resolve_device(device)
        self.specs: dict[str, BankSourceSpec] = {}
        self.calibration: dict[str, dict] = {}
        self.version: str | None = None
        self.built_at: float = 0.0
        self.overlay_generation = 0
        self._built = False
        # Card state: per-source tables + exclusion remaps.
        self._vf: dict[str, torch.Tensor] = {}
        self._uf: dict[str, torch.Tensor] = {}
        self._excl_map: dict[str, torch.Tensor] = {}
        self._rowmap: dict[str, dict[int, int]] = {}
        self._excl_dev: torch.Tensor | None = None
        self._overlay_owned: set[str] = set()

    # ------------------------------------------------------------ registration

    @property
    def source_names(self) -> tuple[str, ...]:
        return tuple(self.specs)

    def register(self, spec: BankSourceSpec) -> None:
        if self._built:
            raise RuntimeError(
                "bank already built — register sources first, then build(); "
                "a new source set is a new bank generation"
            )
        if spec.name in self.specs:
            raise ValueError(f"source {spec.name!r} already registered")
        self.specs[spec.name] = spec

    def register_source(self, name: str, **kwargs) -> None:
        self.register(BankSourceSpec(name=name, **kwargs))

    # ------------------------------------------------------------------- build

    def build(
        self,
        matrix=None,
        exclude_table: np.ndarray | None = None,
        mesh=None,
        budget: int | None = None,
        generations: int = 1,
    ) -> "RetrievalBank":
        """The versioned build step: upload -> calibration -> version.

        ``matrix`` (the serving :class:`StarMatrix`) enables seen-item
        exclusion remaps for sources whose row space is not the matrix item
        space; ``exclude_table`` is the micro-batcher's -1-padded seen-item
        table, reused verbatim. ``mesh``, ``budget`` and ``generations``
        (the mesh layout and the capacity admission) are not ported yet.
        """
        if mesh is not None:
            raise NotImplementedError("RetrievalBank.build(mesh=...): the mesh layout is not ported yet")
        if budget is not None or generations != 1:
            raise NotImplementedError("RetrievalBank.build(budget=, generations=): the capacity "
                                      "admission is not ported yet")
        if not self.specs:
            raise ValueError("no sources registered")
        BUILD_FAULT.hit()
        t0 = time.perf_counter()
        matrix_item_ids = None if matrix is None else np.asarray(matrix.item_ids)
        dev = self.device
        for name in sorted(self.specs):
            spec = self.specs[name]
            self._rowmap[name] = {int(i): r for r, i in enumerate(spec.item_ids)}
            self.calibration[name] = _calibration(spec)
            # Seen-item exclusion remap: matrix dense item index -> source
            # row, -1 where the source does not carry the item. Identity
            # (the ALS case: source rows ARE the matrix item space) has none.
            if (
                spec.kind == "user_rows"
                and spec.exclude_seen
                and matrix_item_ids is not None
                and not np.array_equal(spec.item_ids, matrix_item_ids)
            ):
                excl_map = np.array(
                    [self._rowmap[name].get(int(i), -1) for i in matrix_item_ids], dtype=np.int32
                )
                self._excl_map[name] = torch.tensor(excl_map, device=dev)
            # torch.tensor copies: the bank owns its tables (an overlay
            # publish never writes through to the registered arrays).
            self._vf[name] = torch.tensor(spec.vectors, device=dev)
            if spec.user_vectors is not None:
                self._uf[name] = torch.tensor(spec.user_vectors, device=dev)
        if exclude_table is not None:
            self._excl_dev = torch.tensor(np.asarray(exclude_table, dtype=np.int32), device=dev)
        self.version = self._content_hash()
        self.built_at = time.time()
        self._built = True
        log.info("retrieval bank built: %d source(s), version %s, %.2fs",
                 len(self.specs), self.version, time.perf_counter() - t0)
        return self

    def reshard(self, mesh, budget: int | None = None, generations: int = 1) -> "RetrievalBank":
        raise NotImplementedError("RetrievalBank.reshard: the mesh layout is not ported yet")

    def save(self, artifact_name: str, lineage: dict | None = None):
        raise NotImplementedError("RetrievalBank.save: the artifact store is not ported yet")

    @classmethod
    def load(cls, artifact_name: str, verify: bool = True) -> "RetrievalBank":
        raise NotImplementedError("RetrievalBank.load: the artifact store is not ported yet")

    def _content_hash(self) -> str:
        """Deterministic digest of every registered table — the bank's
        ``version`` (the JAX package's digest of the same tables)."""
        h = hashlib.sha256()
        for name in sorted(self.specs):
            spec = self.specs[name]
            h.update(name.encode())
            h.update(spec.kind.encode())
            h.update(spec.vectors.tobytes())
            h.update(spec.item_ids.tobytes())
            if spec.user_vectors is not None:
                h.update(spec.user_vectors.tobytes())
        return h.hexdigest()[:16]

    def manifest(self) -> dict:
        """The build's inspectable record."""
        return {
            "version": self.version,
            "built_at": self.built_at,
            "overlay_generation": self.overlay_generation,
            "sharded": False,
            "sources": {
                name: {
                    "kind": s.kind,
                    "rows": int(s.vectors.shape[0]),
                    "dim": int(s.vectors.shape[1]),
                    "user_rows": (
                        int(s.user_vectors.shape[0])
                        if s.user_vectors is not None else 0
                    ),
                    "exclude_seen": bool(s.exclude_seen),
                    "calibration": self.calibration.get(name, {}),
                }
                for name, s in self.specs.items()
            },
        }

    # ----------------------------------------------------------------- queries

    def _require_built(self) -> None:
        if not self._built:
            raise RuntimeError("bank not built — call build() first")

    def _q_rows(self, name: str, queries: list[np.ndarray]) -> np.ndarray:
        """Raw query item ids -> padded (B, Q) source-row index matrix, Q
        rounded up to a power of two."""
        rowmap = self._rowmap[name]
        rows = [
            np.array(
                [rowmap[int(i)] for i in q if int(i) in rowmap], dtype=np.int32
            )
            for q in queries
        ]
        width = _pow2(max(1, max((r.size for r in rows), default=1)))
        out = np.full((len(queries), width), -1, dtype=np.int32)
        for b, r in enumerate(rows):
            out[b, : r.size] = r
        return out

    def query(
        self,
        user_dense: np.ndarray,
        k: int,
        raw_user_ids: np.ndarray | None = None,
        sources: tuple[str, ...] | None = None,
        exclude_seen: bool = False,
    ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """One candidate pass per source for a batch of users.

        ``user_dense``: dense matrix user indices (``-1`` = unknown: user-row
        sources return no rows, item_mean sources still answer from
        ``query_items``). Returns per source ``(scores (B, k) f32, rows
        (B, k) int32)`` — rows index the source's ``item_ids``; ``-1`` marks
        an empty slot. Scores are RAW (host-path parity); apply
        ``calibration[name]["scale"]`` for cross-source fusion.
        """
        self._require_built()
        QUERY_FAULT.hit()
        names = tuple(sources) if sources is not None else self.source_names
        unknown = set(names) - set(self.specs)
        if unknown:
            raise KeyError(f"unregistered bank source(s): {sorted(unknown)}")
        user_dense = np.asarray(user_dense, dtype=np.int64)
        b = user_dense.shape[0]
        if raw_user_ids is not None and len(raw_user_ids) != b:
            # A short id list would silently serve empty candidates for the
            # tail users.
            raise ValueError(
                f"raw_user_ids ({len(raw_user_ids)}) must align with "
                f"user_dense ({b})"
            )
        if b == 0:
            empty = (
                np.zeros((0, k), dtype=np.float32),
                np.full((0, k), -1, dtype=np.int32),
            )
            return {n: empty for n in names}
        # Per-source example-query rows (host dict lookups; tiny per batch).
        q_raw: dict[str, list[np.ndarray]] = {}
        for n in names:
            spec = self.specs[n]
            if spec.kind != "item_mean":
                continue
            fn = spec.query_items
            if fn is not None and raw_user_ids is None:
                # query_items providers are keyed by RAW user id; feeding them
                # dense indices would answer with another user's candidates.
                raise ValueError(
                    f"source {n!r} needs raw_user_ids (its query_items "
                    f"provider is keyed by raw user id, not dense index)"
                )
            q_raw[n] = [
                (
                    np.asarray(fn(int(u)), dtype=np.int64)
                    if fn is not None
                    else np.zeros(0, dtype=np.int64)
                )
                for u in (raw_user_ids if fn is not None else user_dense)
            ]
        with_excl = bool(exclude_seen) and any(self.specs[n].exclude_seen for n in names)
        if with_excl and self._excl_dev is None:
            # Refuse rather than silently return seen items.
            raise ValueError(
                "exclude_seen=True but the bank was built without an "
                "exclude_table; pass the batcher's exclusion table to build()"
            )
        known = user_dense >= 0
        out = self._query_batches(names, user_dense, q_raw, k, with_excl)
        # Unknown users never answer from user-row sources (the host paths'
        # inner-join-on-userFactors semantics).
        for n in names:
            if self.specs[n].kind == "user_rows" and not known.all():
                vals, idx = out[n]
                vals = np.where(known[:, None], vals, np.float32(-np.inf))
                idx = np.where(known[:, None], idx, np.int32(-1))
                out[n] = (vals.astype(np.float32), idx.astype(np.int32))
            events.retrieval_queries.inc(b, source=n)
        return out

    def _query_batches(self, names, user_dense, q_raw, k, with_excl):
        """Every source over the batch, in launches of at most ``max_batch``
        users."""
        b = user_dense.shape[0]
        parts = []
        for start in range(0, b, self.max_batch):
            stop = min(b, start + self.max_batch)
            parts.append(self._query_launches(
                names, user_dense[start:stop], {n: q[start:stop] for n, q in q_raw.items()},
                k, with_excl,
            ))
        return {n: (np.concatenate([p[n][0] for p in parts]), np.concatenate([p[n][1] for p in parts]))
                for n in names}

    def _query_launches(self, names, user_dense, q_raw, k, with_excl):
        """One K7 launch per source, each padded from its own k (at most its
        row count) to ``k``, then one copy of each result to the host."""
        dev = self.device
        user_idx = torch.as_tensor(np.clip(user_dense, 0, None).astype(np.int32)).to(dev)
        out = {}
        for n in names:
            spec = self.specs[n]
            k_each = min(k, int(spec.vectors.shape[0]))
            if spec.kind == "user_rows":
                use_excl = with_excl and spec.exclude_seen
                vals, idx = bank_query(
                    self._vf[n], k_each, users=self._uf[n], user_idx=user_idx,
                    exclude_table=self._excl_dev if use_excl else None,
                    excl_map=self._excl_map.get(n) if use_excl else None,
                )
            else:
                q_idx = torch.as_tensor(self._q_rows(n, q_raw[n])).to(dev)
                vals, idx = bank_query(self._vf[n], k_each, q_idx=q_idx)
            out[n] = _pad_k(vals, idx, k)
        return {n: (v.cpu().numpy(), i.cpu().numpy()) for n, (v, i) in out.items()}

    def query_similar(
        self, name: str, example_ids: list[np.ndarray] | np.ndarray, k: int
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Similar-by-example over any source ("similar repos": example =
        one repo id against ``als``/``content``/``tfidf``; user-to-user:
        register the user table as its own source). Returns per query
        ``(raw_item_ids, scores)`` with the example rows excluded."""
        self._require_built()
        QUERY_FAULT.hit()
        if isinstance(example_ids, np.ndarray) and example_ids.ndim == 1:
            example_ids = [np.asarray([i]) for i in example_ids]
        queries = [np.asarray(q, dtype=np.int64) for q in example_ids]
        spec = self.specs[name]
        events.retrieval_queries.inc(len(queries), source=name)
        k_each = min(k, int(spec.vectors.shape[0]))
        vals_parts, idx_parts = [], []
        for start in range(0, len(queries), self.max_batch):
            # The item_mean query over the source's own table, user_rows
            # sources included (their table is queried by its own rows).
            q_idx = torch.as_tensor(self._q_rows(name, queries[start:start + self.max_batch])).to(self.device)
            vals, idx = _pad_k(*bank_query(self._vf[name], k_each, q_idx=q_idx), k)
            vals_parts.append(vals.cpu().numpy())
            idx_parts.append(idx.cpu().numpy())
        results = []
        if not queries:
            return results
        vals, idx = np.concatenate(vals_parts), np.concatenate(idx_parts)
        for b in range(len(queries)):
            ok = (idx[b] >= 0) & np.isfinite(vals[b])
            results.append((spec.item_ids[idx[b][ok]], vals[b][ok].astype(np.float64)))
        return results

    # ----------------------------------------------------------------- overlay

    def publish_user_rows(
        self, name: str, dense_rows: np.ndarray, rows: np.ndarray
    ) -> int:
        """Land freshly solved user rows (the fold-in engine's output) into a
        ``user_rows`` source's query table. The card table is replaced, not
        written in place, so a query that already holds the old table reads
        it whole; the next query reads the new rows. Returns the bank's new
        overlay generation."""
        self._require_built()
        spec = self.specs[name]
        if spec.kind != "user_rows":
            raise ValueError(f"source {name!r} has no user-row table to overlay")
        dense_rows = np.asarray(dense_rows, dtype=np.int64)
        rows = np.asarray(rows, dtype=np.float32)
        if rows.shape != (dense_rows.shape[0], spec.user_vectors.shape[1]):
            raise ValueError(
                f"overlay rows {rows.shape} do not match "
                f"({dense_rows.shape[0]}, {spec.user_vectors.shape[1]})"
            )
        if name not in self._overlay_owned:
            # The registered array may BE the model's own factors: the
            # overlay owns its copy from the first publish on.
            spec.user_vectors = spec.user_vectors.copy()
            self._overlay_owned.add(name)
        spec.user_vectors[dense_rows] = rows
        dev = self.device
        self._uf[name] = self._uf[name].index_copy(
            0, torch.as_tensor(dense_rows).to(dev), torch.as_tensor(rows).to(dev)
        )
        self.overlay_generation += 1
        return self.overlay_generation

    def bind_query_items(self, name: str, fn: Callable[[int], np.ndarray]) -> None:
        """Attach a query-item provider to an item_mean source (providers are
        live callables over the serving tables)."""
        self.specs[name].query_items = fn
