"""Online two-stage pipeline: candidate fan-out -> LR re-rank, with deadlines.

Port of ``albedo_tpu/serving/pipeline.py`` (without the retrieval-bank
stage, which is the next slice of the port). The reference fuses ALS +
curation + popularity candidates and re-ranks them with the trained LR model
offline (``LogisticRegressionRanker.scala:368-444``); here the same fusion
answers HTTP requests under a latency budget, so every stage gets a deadline
and a degradation path:

- a candidate source missing its deadline (or raising) is dropped from the
  fusion — the request still answers from the sources that made it;
- a source that keeps failing trips its **circuit breaker**
  (``serving.breaker``): subsequent requests skip it outright
  (``breaker_open_<name>``) instead of re-paying the deadline, until a
  jittered reopen timer admits a half-open trial call;
- the ranker missing its deadline (or raising, or dropping every cold pair)
  degrades to **raw ALS scores**, then to the next stage-1 source — never a
  500, never a hang;
- the ALS source runs through the micro-batcher (:class:`BatchedALSSource`),
  so stage-1 fan-outs from concurrent requests coalesce into shared K6
  launches. The live ALS source is supplied per request via
  ``extra_sources``: the service passes the source of its current
  :class:`~albedo_tpu_torch.serving.service.ModelGeneration` snapshot.

The re-rank is ``builders.ranker.RankerModel.score``: featurization on the
host, then the LR logits through K8 and K8c (``ops.sparse_linear``). Every
degraded answer is tagged in the response (``"degraded": [reasons]``) and
counted in ``albedo_degraded_total{reason=...}``; per-stage wall-clock
accumulates in a ``utils.profiling.Timer`` that the metrics plane exports as
``albedo_stage_seconds``/``albedo_stage_calls``. Besides the JAX module's
``stage1_candidates`` and ``stage2_rank`` sections, the port times each
source's call (``source_<name>``) and the fusion (``fuse``), so the gauges
split a request's host time.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, TimeoutError as FutureTimeout

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.ragged import csr_row
from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.recommenders.base import Recommender, fuse_candidates
from albedo_tpu_torch.serving.batcher import BatcherClosed, MicroBatcher
from albedo_tpu_torch.serving.breaker import STATE_VALUES, BreakerConfig, CircuitBreaker
from albedo_tpu_torch.serving.overload import (
    LEVEL_BANK_ONLY,
    LEVEL_CACHE_POPULARITY,
    LEVEL_SKIP_RERANK,
    tier_name,
)
from albedo_tpu_torch.utils import faults
from albedo_tpu_torch.utils.profiling import Timer

# Chaos hooks (utils.faults): armed faults here surface as the SAME degraded
# responses real source/ranker failures produce — tests drive the degradation
# matrix end-to-end over HTTP instead of hand-stubbing broken recommenders.
_RANK_FAULT = faults.site("serving.rank")

# Fusion priority: duplicates keep the FIRST source's row (reference
# ``reduce(union).distinct`` keeps one arbitrary row; we pin the order so
# the ALS score survives a collision with a curation/popularity row).
SOURCE_ORDER = ("als", "curation", "content", "tfidf", "popularity")


class BatchedALSSource(Recommender):
    """Stage-1 ALS retrieval routed through the micro-batcher.

    Same output contract as ``recommenders.ALSRecommender`` (rows per known
    user, raw ids, ``source="als"``), but each user's top-k is a batcher
    submission — concurrent pipeline requests share device batches instead
    of serializing single-row GEMMs.
    """

    source = "als"

    def __init__(
        self,
        batcher: MicroBatcher,
        matrix: StarMatrix,
        exclude_seen: bool = False,
        timeout_s: float = 5.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.batcher = batcher
        self.matrix = matrix
        self.exclude_seen = exclude_seen
        self.timeout_s = float(timeout_s)
        self._indptr, self._cols, _ = matrix.csr()  # built once, not per call

    def _exclude_row(self, dense_user: int) -> np.ndarray:
        return csr_row(self._indptr, self._cols, dense_user)

    def recommend_for_users(
        self, user_ids: np.ndarray, exclude_seen: bool | None = None
    ) -> pd.DataFrame:
        """``exclude_seen=None`` uses the source's configured default; the
        pipeline threads the request's flag through here."""
        exclude_seen = self.exclude_seen if exclude_seen is None else exclude_seen
        dense = self.matrix.users_of(np.asarray(user_ids, np.int64))
        known = dense >= 0
        users = np.asarray(user_ids, dtype=np.int64)[known]
        rows = dense[known]
        if rows.size == 0:
            return self._frame(np.zeros(0), np.zeros(0), np.zeros(0))
        if not exclude_seen:
            excl = [None] * rows.size
        elif self.batcher.device_exclusion:
            excl = [True] * rows.size
        else:
            excl = [self._exclude_row(int(r)) for r in rows]
        futs = [
            self.batcher.submit(int(r), self.top_k, e)
            for r, e in zip(rows, excl)
        ]
        deadline = time.monotonic() + self.timeout_s
        vals = np.empty((rows.size, self.top_k), dtype=np.float32)
        idx = np.empty((rows.size, self.top_k), dtype=np.int32)
        for i, fut in enumerate(futs):
            v, ix = fut.result(timeout=max(0.0, deadline - time.monotonic()))
            vals[i], idx[i] = v, ix
        return self._topk_frame(users, vals, idx, self.matrix.item_ids)


@dataclasses.dataclass
class StageDeadlines:
    """Per-stage latency budgets (seconds)."""

    candidates_s: float = 2.0
    ranker_s: float = 0.5


class TwoStagePipeline:
    """Fan out stage-1 sources, fuse, re-rank; degrade instead of failing."""

    def __init__(
        self,
        recommenders: dict[str, Recommender],
        ranker=None,  # builders.ranker.RankerModel (score() adds `probability`)
        deadlines: StageDeadlines | None = None,
        metrics=None,
        max_workers: int = 8,
        timer: Timer | None = None,
        breaker_config: BreakerConfig | None = None,
        breakers_enabled: bool = True,
    ):
        self.recommenders = dict(recommenders)
        self.ranker = ranker
        self.deadlines = deadlines or StageDeadlines()
        self.metrics = metrics
        self.timer = timer if timer is not None else Timer()
        # Per-source circuit breakers, created lazily on first use (sources
        # can arrive per-request via extra_sources). One breaker per source
        # NAME: a hot-swapped ALS source inherits the breaker state of the
        # source it replaced — the dependency is "the ALS stage", not one
        # model object.
        self.breaker_config = breaker_config if breakers_enabled else None
        if breakers_enabled and breaker_config is None:
            self.breaker_config = BreakerConfig()
        self.breakers: dict[str, CircuitBreaker] = {}
        self._breaker_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="albedo-pipeline"
        )
        # The ranker runs in its OWN pool: a deadline-exceeded score() keeps
        # its thread until it finishes (threads can't be cancelled), and on
        # the shared pool a consistently-slow ranker would zombie every
        # worker and starve stage-1 fan-out into empty responses — exactly
        # when the degradation path matters most.
        self._rank_pool = ThreadPoolExecutor(
            max_workers=max(2, max_workers // 2),
            thread_name_prefix="albedo-ranker",
        )
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._rank_pool.shutdown(wait=False, cancel_futures=True)

    def _degrade(self, degraded: list[str], reason: str) -> None:
        degraded.append(reason)
        if self.metrics is not None:
            self.metrics.degraded.inc(reason=reason)

    def _on_breaker_transition(self, name: str, state: str) -> None:
        if self.metrics is not None and hasattr(self.metrics, "breaker_state"):
            self.metrics.breaker_state.set(STATE_VALUES[state], source=name)
            self.metrics.breaker_transitions.inc(source=name, to=state)

    def _breaker(self, name: str) -> CircuitBreaker | None:
        if self.breaker_config is None:
            return None
        br = self.breakers.get(name)
        if br is None:
            with self._breaker_lock:
                br = self.breakers.get(name)
                if br is None:
                    br = CircuitBreaker(
                        name, self.breaker_config,
                        on_transition=self._on_breaker_transition,
                    )
                    if self.metrics is not None and hasattr(self.metrics, "breaker_state"):
                        self.metrics.breaker_state.set(STATE_VALUES[br.state], source=name)
                    self.breakers[name] = br
        return br

    def breaker_states(self) -> dict[str, dict]:
        """Every source breaker's snapshot — the readiness probe's view."""
        with self._breaker_lock:
            breakers = dict(self.breakers)
        return {name: br.snapshot() for name, br in sorted(breakers.items())}

    def _source_order(self, names) -> list[str]:
        return sorted(
            names,
            key=lambda n: SOURCE_ORDER.index(n) if n in SOURCE_ORDER else len(SOURCE_ORDER),
        )

    def _sources(self, extra_sources: dict | None) -> dict[str, Recommender]:
        """The fan-out set for one request: the registered sources plus the
        caller's per-request extras (the generation-snapshot ALS source).
        Registered names win — an explicitly configured source is not
        silently replaced."""
        if not extra_sources:
            return self.recommenders
        return {**extra_sources, **self.recommenders}

    def candidates(
        self,
        user_id: int,
        degraded: list[str],
        exclude_seen: bool = True,
        extra_sources: dict | None = None,
        deadline: float | None = None,
        allowed: frozenset | None = None,
    ) -> dict[str, pd.DataFrame]:
        """Stage 1: every registered source in parallel, one shared deadline.
        ``exclude_seen`` reaches the sources that honor it (the ALS source);
        popularity/curation/content don't filter by history, as in the
        reference fusion. Sources whose breaker is open are skipped outright
        (``breaker_open_<name>``) — no thread, no deadline wait. A client
        ``deadline`` (monotonic) caps the stage budget; a source cut short
        by the CLIENT's deadline (not its own stage budget) degrades but
        records no breaker outcome — the dependency wasn't given its full
        chance, so its failure count must not move. ``allowed`` restricts
        the fan-out to the named sources (the brownout ladder's tiers)."""
        users = np.array([int(user_id)], dtype=np.int64)
        timer_section = self.timer.section

        def call_source(name: str, rec: Recommender) -> pd.DataFrame:
            # Both chaos hooks live inside the breaker-guarded call:
            # serving.source.<name> models the source itself failing,
            # serving.breaker.<name> lets tests trip/recover the breaker
            # without touching the source (e.g. `:error@1*5` to trip it).
            with timer_section(f"source_{name}"):
                faults.hit(f"serving.breaker.{name}")
                faults.hit(f"serving.source.{name}")
                if isinstance(rec, BatchedALSSource):
                    return rec.recommend_for_users(users, exclude_seen)
                return rec.recommend_for_users(users)

        all_sources = self._sources(extra_sources)
        if allowed is not None:
            all_sources = {
                n: rec for n, rec in all_sources.items() if n in allowed
            }
        futs: dict[str, Future] = {}
        for name, rec in all_sources.items():
            br = self._breaker(name)
            if br is not None and not br.allow():
                self._degrade(degraded, f"breaker_open_{name}")
                continue
            futs[name] = self._pool.submit(call_source, name, rec)
        stage_deadline = time.monotonic() + self.deadlines.candidates_s
        eff_deadline = (
            stage_deadline if deadline is None else min(stage_deadline, deadline)
        )

        frames: dict[str, pd.DataFrame] = {}
        for name, fut in futs.items():
            br = self._breaker(name)
            try:
                frames[name] = fut.result(
                    timeout=max(0.0, eff_deadline - time.monotonic())
                )
                if br is not None:
                    br.record_success()
            except FutureTimeout:
                fut.cancel()
                self._degrade(degraded, f"candidate_timeout_{name}")
                if br is not None:
                    if time.monotonic() >= stage_deadline:
                        br.record_failure()
                    else:
                        br.abandon_trial()
            except BatcherClosed:
                # The request's generation snapshot lost a race with a
                # retirement. Not a source failure (the breaker must not trip
                # on a healthy swap) — propagate so the service retries the
                # whole request against the live generation. Sources whose
                # results we now abandon get no outcome recorded; release any
                # half-open trial slots they hold or their breakers would deny
                # later callers.
                for other in futs:
                    ob = self._breaker(other)
                    if ob is not None:
                        ob.abandon_trial()
                raise
            except Exception:  # noqa: BLE001 — a broken source degrades, never 500s
                self._degrade(degraded, f"candidate_error_{name}")
                if br is not None:
                    br.record_failure()
        return frames

    def _rank(self, candidates: pd.DataFrame) -> pd.DataFrame:
        _RANK_FAULT.hit()
        return self.ranker.score(candidates)

    def recommend(
        self,
        user_id: int,
        k: int,
        exclude_seen: bool = True,
        extra_sources: dict | None = None,
        deadline: float | None = None,
        brownout_level: int = 0,
    ) -> dict:
        """One online request: returns ``{stage, degraded, items}`` where each
        item is ``{repo_id, score, source}`` (score = LR probability on the
        full two-stage path, raw stage-1 score on degraded paths).
        ``extra_sources`` joins the fan-out for THIS request only — the
        service threads its generation-snapshot ALS source through here.
        ``deadline`` (client, monotonic) caps every stage budget so the
        response lands inside it, degrading per the matrix instead of
        arriving late. ``brownout_level`` (serving.overload ladder) degrades
        the plan under sustained overload: >=1 skips the LR re-rank (raw
        MIPS scores), >=2 halves k and restricts to the ALS and popularity sources (the
        JAX pipeline's bank-only tier, without a bank stage),
        >=3 answers from popularity only (the cache already short-circuits
        hot users upstream). Every browned-out response is tagged."""
        degraded: list[str] = []
        allowed: frozenset | None = None
        skip_rank = False
        if brownout_level >= LEVEL_SKIP_RERANK:
            # Tag the ACTIVE tier (one tag, not one per implied level) and
            # count it like any other degradation.
            self._degrade(degraded, f"brownout_{tier_name(brownout_level)}")
            skip_rank = self.ranker is not None
            if brownout_level >= LEVEL_BANK_ONLY:
                # Without a bank stage, the bank-only tier keeps the device
                # source and the cheapest host one.
                k = max(1, int(k) // 2)
                allowed = frozenset({"als", "popularity"})
            if brownout_level >= LEVEL_CACHE_POPULARITY:
                allowed = frozenset({"popularity"})
        timer_section = self.timer.section
        with timer_section("stage1_candidates"):
            frames = self.candidates(
                user_id, degraded, exclude_seen=exclude_seen,
                extra_sources=extra_sources, deadline=deadline,
                allowed=allowed,
            )

        out_tags = {}
        if brownout_level >= LEVEL_SKIP_RERANK:
            out_tags = {
                "brownout_level": int(brownout_level),
                "brownout_tier": tier_name(brownout_level),
            }
        order = [n for n in self._source_order(frames) if len(frames[n])]
        if not order:
            return {"stage": "empty", "degraded": degraded, "items": [], **out_tags}
        with timer_section("fuse"):
            fused = fuse_candidates([frames[n] for n in order])

        ranked = None
        if self.ranker is not None and not skip_rank:
            rank_timeout = self.deadlines.ranker_s
            if deadline is not None:
                rank_timeout = max(0.0, min(rank_timeout, deadline - time.monotonic()))
            fut = self._rank_pool.submit(self._rank, fused)
            try:
                with timer_section("stage2_rank"):
                    ranked = fut.result(timeout=rank_timeout)
            except FutureTimeout:
                fut.cancel()
                ranked = None
                self._degrade(degraded, "ranker_timeout")
            except Exception:  # noqa: BLE001
                ranked = None
                self._degrade(degraded, "ranker_error")
            if ranked is not None and not len(ranked):
                # coldStartStrategy="drop" can drop EVERY candidate pair for
                # a user the factorization never saw — raw scores still serve.
                ranked = None
                self._degrade(degraded, "ranker_empty")

        if ranked is not None:
            out = ranked.sort_values("probability", ascending=False, kind="stable").head(k)
            items = [
                {
                    "repo_id": int(r.repo_id),
                    "score": float(r.probability),
                    "source": str(getattr(r, "source", "")),
                }
                for r in out.itertuples()
            ]
            stage = "two_stage"
        else:
            # Degraded ordering: raw ALS scores first, then the remaining
            # sources in priority order (curation -> content -> popularity).
            # Dedup DURING accumulation, so overlap with an earlier source
            # never leaves the response short while later sources go unused.
            items = []
            seen: set[int] = set()
            for name in order:
                if len(items) >= k:
                    break
                f = frames[name].sort_values("score", ascending=False, kind="stable")
                for r in f.itertuples():
                    repo_id = int(r.repo_id)
                    if repo_id in seen:
                        continue
                    seen.add(repo_id)
                    items.append(
                        {"repo_id": repo_id, "score": float(r.score), "source": name}
                    )
                    if len(items) >= k:
                        break
            stage = f"stage1_{order[0]}"

        # Stage gauges are refreshed from self.timer at /metrics scrape time
        # (http.py) — no per-request mirroring on the hot path.
        return {"stage": stage, "degraded": degraded, "items": items, **out_tags}
