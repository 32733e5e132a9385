"""Artifact-backed serving engine: micro-batcher + result cache + metrics.

Port of ``albedo_tpu/serving/service.py``. :class:`RecommendationService`
answers id-mapped top-k and admin search from a trained model:

1. **TTL result cache** (``serving.cache``) — hot users skip the card.
2. **Two-stage pipeline** (``serving.pipeline``) when candidate sources are
   registered (``recommenders=``): fan-out -> fusion -> LR re-rank
   (``ranker=``), with per-stage deadlines (``deadlines=``) and per-source
   circuit breakers (``breaker_config=``).
3. **Micro-batcher** (``serving.batcher``) — all ALS scoring, the plain
   ``/recommend`` path's and the pipeline's ALS source's, coalesces into K6
   launches over power-of-two user buckets. ``batching=False`` keeps the
   direct single-request path (one K5 launch per request, the parity
   baseline).
4. **Overload control** (``serving.overload``) — AIMD admission, CoDel shed
   and the brownout ladder, on by default; the controller starts at its
   ``max_limit`` (the queue bound), so an unstressed service behaves exactly
   as the static bounded queue.
5. **Metrics** (``serving.metrics``) — every outcome is counted; the HTTP
   layer renders the registry at ``/metrics``.

Degradation contract: ranker deadline exceeded -> raw ALS scores;
missing/cold ALS artifacts (``model=None``) -> the popularity fallback; a
failing source -> dropped from the fusion, its breaker opens after repeated
failures. The model state a request reads is an immutable
:class:`ModelGeneration` snapshot (model + batcher + the pipeline's ALS
source), captured once at request entry; ``promote`` swaps it atomically.
Every response carries ``"generation"``.

Not ported yet: the retrieval-bank stage (``bank_stage=`` raises
``NotImplementedError``; it comes with ``retrieval/stage.py`` and
``serve --bank``) and the hot-swap manager (``serving/reload.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.ragged import csr_row, padded_rows
from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.models.als import ALSModel
from albedo_tpu_torch.serving.batcher import (
    BatcherClosed,
    DeadlineExceeded,
    MicroBatcher,
    QueueOverflow,
)
from albedo_tpu_torch.serving.cache import TTLCache
from albedo_tpu_torch.serving.metrics import MetricsRegistry
from albedo_tpu_torch.serving.overload import (
    LEVEL_SHED,
    OverloadConfig,
    OverloadController,
    tier_name,
)
from albedo_tpu_torch.serving.pipeline import (
    BatchedALSSource,
    StageDeadlines,
    TwoStagePipeline,
)


@dataclasses.dataclass(frozen=True)
class ModelGeneration:
    """One immutable serving state: everything a request needs that a swap
    replaces. Requests snapshot the CURRENT generation once at entry and use
    only its members — items, scores, and the ``"generation"`` tag in a
    response always come from the same model.
    """

    number: int
    model: ALSModel | None
    batcher: MicroBatcher | None
    als_source: object | None  # BatchedALSSource/ALSRecommender for the pipeline
    origin: str                # "boot" or where the model came from
    validated: bool
    promoted_at: float = 0.0


class RecommendationService:
    """Read-only online engine over trained artifacts.

    ``RecommendationService(model, matrix, repo_info, user_info)`` serves the
    ALS path; the engine features are opt-in keywords. ``model=None``
    declares the ALS artifacts missing: the service stays up and answers
    from the registered ``popularity`` source (the cold-artifact
    degradation path). ``bank_stage`` (the retrieval-bank candidate stage)
    is not ported yet and raises ``NotImplementedError``.
    """

    def __init__(
        self,
        model: ALSModel | None,
        matrix: StarMatrix | None,
        repo_info: pd.DataFrame | None = None,
        user_info: pd.DataFrame | None = None,
        *,
        recommenders: dict | None = None,
        ranker=None,
        metrics: MetricsRegistry | None = None,
        batching: bool = True,
        batch_window_ms: float = 2.0,
        max_batch: int = 64,
        max_queue: int = 256,
        cache_ttl: float = 0.0,
        cache_size: int = 4096,
        deadlines: StageDeadlines | None = None,
        default_k: int = 30,
        max_k: int = 500,
        item_block: int = 4096,
        warm: bool = False,
        breaker_config=None,
        breakers_enabled: bool = True,
        bank_stage=None,
        overload_enabled: bool = True,
        overload_config: OverloadConfig | None = None,
    ):
        if bank_stage is not None:
            raise NotImplementedError(
                "RecommendationService(bank_stage=...): the retrieval-bank candidate stage "
                "(retrieval/stage.py, serve --bank) is not ported yet; it is the next slice"
            )
        self.matrix = matrix
        self.repo_info = repo_info if repo_info is not None else pd.DataFrame()
        self.user_info = user_info if user_info is not None else pd.DataFrame()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.default_k = int(default_k)
        self.max_k = int(max_k)
        self.item_block = int(item_block)
        self._closed = False
        self._close_lock = threading.Lock()
        # Batcher construction parameters, kept so a new generation's
        # batcher is configured as the incumbent's.
        self._batching = bool(batching)
        self._max_batch = int(max_batch)
        self._max_queue = int(max_queue)
        self._batch_window_ms = float(batch_window_ms)
        self._warm = bool(warm)
        # Overload-resilience layer: ONE controller for the whole service,
        # shared by every generation's batcher. The default AIMD ceiling is
        # the queue bound — an unstressed service behaves exactly like the
        # static bounded queue.
        self.overload: OverloadController | None = None
        if overload_enabled:
            self.overload = OverloadController(
                overload_config or OverloadConfig(max_limit=int(max_queue)),
                metrics=self.metrics,
            )

        if matrix is not None:
            self._indptr, self._cols, _ = matrix.csr()
            max_hist = int((self._indptr[1:] - self._indptr[:-1]).max()) if matrix.n_users else 0
        else:
            self._indptr = self._cols = None
            max_hist = 0
        self._max_hist = max_hist
        self._repo_names = (
            self.repo_info.set_index("repo_id")["repo_full_name"].to_dict()
            if "repo_full_name" in self.repo_info.columns
            else {}
        )

        # Device-side exclusion table: the users' seen-item rows, -1-padded,
        # computed once on the host and uploaded by each generation's
        # batcher. Skewed datasets (one power user -> huge padded width) use
        # host rows instead; the cap is entries, i.e. 4 bytes each.
        self._exclude_table: np.ndarray | None = None
        if batching and matrix is not None and max_hist:
            cap = int(os.environ.get("ALBEDO_SERVE_EXCL_TABLE_MAX", str(32 << 20)))
            if matrix.n_users * max_hist <= cap:
                self._exclude_table = padded_rows(
                    self._indptr, self._cols, np.arange(matrix.n_users)
                )

        self.cache: TTLCache | None = (
            TTLCache(maxsize=cache_size, ttl=cache_ttl) if cache_ttl > 0 else None
        )

        self.pipeline: TwoStagePipeline | None = None
        self._pipeline_owns_als = False
        if recommenders:
            sources = dict(recommenders)
            # The live ALS source rides each ModelGeneration and joins the
            # fan-out per request (pipeline extra_sources) — unless the
            # caller registered an "als" source explicitly, which then wins.
            self._pipeline_owns_als = "als" in sources
            self.pipeline = TwoStagePipeline(
                sources, ranker=ranker, deadlines=deadlines, metrics=self.metrics,
                breaker_config=breaker_config, breakers_enabled=breakers_enabled,
            )

        # Displaced generations' batchers not stopped yet: close() sweeps them.
        self._zombie_batchers: list[MicroBatcher] = []
        self._gen_lock = threading.Lock()
        self._generation = self.build_generation(
            model,
            number=1 if model is not None else 0,
            origin="boot",
            validated=model is not None,
            warm=warm,
        )
        self.metrics.model_generation.set(self._generation.number)

    # ------------------------------------------------- generation plumbing

    @property
    def exclude_table(self) -> np.ndarray | None:
        """The device-exclusion source table (host copy) — shared with the
        retrieval bank so seen-item exclusion has ONE definition."""
        return self._exclude_table

    @property
    def generation(self) -> ModelGeneration:
        return self._generation

    @property
    def model(self) -> ALSModel | None:
        return self._generation.model

    @property
    def batcher(self) -> MicroBatcher | None:
        return self._generation.batcher

    def build_generation(
        self,
        model: ALSModel | None,
        number: int,
        origin: str,
        validated: bool,
        warm: bool = False,
    ) -> ModelGeneration:
        """Assemble a serving state for ``model`` WITHOUT promoting it: the
        batcher, configured as the incumbent's and warmed (kernels built,
        every shape launched once) off the request path when ``warm``, and
        the pipeline's ALS source (through that batcher, or the direct
        ``ALSRecommender`` without batching)."""
        batcher = None
        if self._batching and model is not None:
            batcher = MicroBatcher(
                model,
                exclude_table=self._exclude_table,
                excl_width=self._max_hist,
                max_batch=self._max_batch,
                max_queue=self._max_queue,
                window_ms=self._batch_window_ms,
                metrics=self.metrics,
                overload=self.overload,
            )
            if warm:
                batcher.warm(ks=(self.default_k,))
        als_source = None
        if (
            self.pipeline is not None
            and not self._pipeline_owns_als
            and model is not None
            and self.matrix is not None
        ):
            if batcher is not None:
                als_source = BatchedALSSource(
                    batcher, self.matrix, exclude_seen=True, top_k=self.default_k
                )
            else:
                from albedo_tpu_torch.recommenders import ALSRecommender

                als_source = ALSRecommender(
                    model, self.matrix, exclude_seen=True, top_k=self.default_k
                )
        return ModelGeneration(
            number=int(number),
            model=model,
            batcher=batcher,
            als_source=als_source,
            origin=origin,
            validated=validated,
            promoted_at=time.time(),
        )

    def promote(self, gen: ModelGeneration) -> ModelGeneration:
        """Atomically make ``gen`` the serving generation; returns the
        displaced incumbent (left alive: in-flight requests may still hold
        its snapshot; ``close`` stops its batcher). The result cache is
        flushed: cached bodies carry the old generation tag."""
        with self._gen_lock:
            old = self._generation
            self._generation = gen
            if gen.batcher is not None and gen.batcher in self._zombie_batchers:
                self._zombie_batchers.remove(gen.batcher)
            if old.batcher is not None and old.batcher is not gen.batcher:
                self._zombie_batchers.append(old.batcher)
        self.metrics.model_generation.set(gen.number)
        if self.cache is not None:
            self.cache.invalidate_all()
        return old

    def readiness(self) -> tuple[bool, dict]:
        """(ready?, report) for ``/healthz/ready``: ready once a validated
        model generation is promoted. The report carries the generation,
        the batcher's warmth and queue, the cache and the overload state."""
        gen = self._generation
        ready = gen.model is not None and gen.validated
        batcher = gen.batcher
        report = {
            "ready": ready,
            "generation": gen.number,
            "model_loaded": gen.model is not None,
            "validated": gen.validated,
            "origin": gen.origin,
            "batcher": (
                {
                    "active": True,
                    "warm": bool(batcher.warmed),
                    "queue_depth": batcher.queue_depth(),
                    "mean_batch_size": round(batcher.mean_batch_size, 3),
                }
                if batcher is not None
                else {"active": False}
            ),
            "breakers": (
                self.pipeline.breaker_states() if self.pipeline is not None else {}
            ),
        }
        if self.cache is not None:
            report["cache"] = self.cache.stats()
        if self.overload is not None:
            report["overload"] = self.overload.snapshot()
        return ready, report

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Stop the batchers (draining in-flight work) and the pipeline's
        pools. Idempotent; the HTTP layer calls it from
        ``ServerHandle.shutdown``."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        gen = self._generation
        if gen.batcher is not None:
            gen.batcher.stop(drain=True)
        with self._gen_lock:
            zombies, self._zombie_batchers = self._zombie_batchers, []
        for batcher in zombies:
            batcher.stop(drain=True)
        if self.pipeline is not None:
            self.pipeline.close()

    def __enter__(self) -> "RecommendationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- helpers

    def clamp_k(self, k) -> int:
        """Harden ``k``: junk/absurd values become sane bounds, never an
        index error deep inside the model."""
        try:
            k = int(k)
        except (TypeError, ValueError):
            return self.default_k
        return max(1, min(k, self.max_k))

    def _named_items(self, repo_ids, scores) -> list[dict]:
        return [
            {
                "repo_id": int(repo_id),
                "repo_full_name": self._repo_names.get(int(repo_id)),
                "score": float(score),
            }
            for repo_id, score in zip(repo_ids, scores)
        ]

    def _exclude_row(self, dense_user: int) -> np.ndarray:
        return csr_row(self._indptr, self._cols, dense_user)

    def invalidate(self, user_id: int | None = None) -> int:
        """Explicit cache invalidation (e.g. after a star ingest)."""
        if self.cache is None:
            return 0
        if user_id is None:
            return self.cache.invalidate_all()
        return self.cache.invalidate_user(int(user_id))

    # ------------------------------------------------------- request paths

    def recommend(self, user_id: int, k: int = 30, exclude_seen: bool = True) -> dict:
        """The direct single-request path: one K5 launch per request. The
        parity baseline of the micro-batcher, and the ``batching=False``
        serving mode."""
        gen = self._generation
        dense = self.matrix.users_of(np.array([user_id], dtype=np.int64))
        if dense[0] < 0:
            return {"user_id": user_id, "error": "unknown user", "items": []}
        excl = padded_rows(self._indptr, self._cols, dense) if exclude_seen else None
        vals, idx = gen.model.recommend(
            dense, k=k, exclude_idx=excl, item_block=self.item_block
        )
        ok = (idx[0] >= 0) & np.isfinite(vals[0])
        repo_ids = self.matrix.item_ids[idx[0][ok]]
        return {
            "user_id": user_id,
            "k": k,
            "generation": gen.number,
            "items": self._named_items(repo_ids, vals[0][ok]),
        }

    def _recommend_batched(
        self,
        gen: ModelGeneration,
        user_id: int,
        k: int,
        exclude_seen: bool,
        deadline: float | None = None,
    ) -> dict:
        dense = self.matrix.users_of(np.array([user_id], dtype=np.int64))
        if dense[0] < 0:
            return {"user_id": user_id, "error": "unknown user", "items": []}
        exclude = None
        if exclude_seen:
            exclude = (
                True if gen.batcher.device_exclusion
                else self._exclude_row(int(dense[0]))
            )
        fut = gen.batcher.submit(int(dense[0]), k, exclude, deadline=deadline)
        timeout = 30.0
        if deadline is not None:
            timeout = max(0.05, deadline - time.monotonic())
        try:
            vals, idx = fut.result(timeout=timeout)
        except FutureTimeout:
            if deadline is None:
                raise
            # The client's deadline lapsed while the request queued: a
            # successful cancel keeps the worker from computing it and means
            # this side owns the accounting.
            if fut.cancel():
                self.metrics.shed.inc()
                self.metrics.deadline_shed.inc()
            raise DeadlineExceeded(
                "request deadline expired while queued",
                retry_after_s=gen.batcher.retry_after_s(),
            ) from None
        ok = (idx >= 0) & np.isfinite(vals)
        repo_ids = self.matrix.item_ids[idx[ok]]
        return {
            "user_id": user_id,
            "k": k,
            "generation": gen.number,
            "items": self._named_items(repo_ids, vals[ok]),
        }

    def handle_recommend(
        self,
        user_id: int,
        k=None,
        exclude_seen: bool = True,
        deadline: float | None = None,
    ) -> tuple[int, dict]:
        """Full engine path: cache -> (two-stage | batched ALS | the direct
        path | the popularity fallback).

        Returns ``(http_status, body)``; raises
        :class:`~albedo_tpu_torch.serving.batcher.QueueOverflow` for the HTTP
        layer's 429. ``deadline`` (monotonic timestamp) opts the batched path
        into admission control.
        """
        user_id = int(user_id)
        k = self.clamp_k(k if k is not None else self.default_k)
        if self.pipeline is not None:
            # Two-stage k is bounded by the stage-1 candidate budget (each
            # source generates default_k candidates): clamp and say so.
            k = min(k, self.default_k)
        gen = self._generation

        def cache_key(g):
            # The generation tag is part of the key: a promoted swap never
            # answers from the displaced model's cached bodies.
            return ("rec", user_id, k, bool(exclude_seen),
                    self.pipeline is not None, g.number)

        key = cache_key(gen)
        if self.cache is not None:
            hit = self.cache.get(key)
            if hit is not None:
                self.metrics.cache_hits.inc()
                return hit
            self.metrics.cache_misses.inc()

        try:
            status, body = self._compute(gen, user_id, k, exclude_seen, deadline)
        except BatcherClosed:
            # The snapshot lost a race with a retirement: the CURRENT
            # generation is alive by construction — retry once against it,
            # and key the cache write to the generation that answered.
            gen = self._generation
            key = cache_key(gen)
            status, body = self._compute(gen, user_id, k, exclude_seen, deadline)
        self.metrics.generation_requests.inc(generation=str(gen.number))
        if (
            self.cache is not None and status == 200
            and not body.get("degraded") and not body.get("brownout")
        ):
            # Degraded or brownout-tagged bodies never enter the cache: a
            # reduced answer must not outlive the incident.
            self.cache.put(key, (status, body), user_id=user_id)
        return status, body

    def _compute(
        self,
        gen: ModelGeneration,
        user_id: int,
        k: int,
        exclude_seen: bool,
        deadline: float | None = None,
    ) -> tuple[int, dict]:
        # Admission control: a request whose deadline lapsed before compute
        # started is shed here rather than computed-then-late.
        if deadline is not None and time.monotonic() >= deadline:
            self.metrics.shed.inc()
            self.metrics.deadline_shed.inc()
            raise DeadlineExceeded(
                "request deadline expired while queued",
                retry_after_s=(
                    gen.batcher.retry_after_s() if gen.batcher is not None else None
                ),
            )
        # Brownout ladder: at the shed tier nothing is computed — a 429 with
        # Retry-After pricing, tagged with the tier, never a 5xx.
        blevel = 0
        if self.overload is not None:
            blevel = self.overload.brownout_level
            if blevel >= LEVEL_SHED:
                self.overload.count_shed()
                self.metrics.shed.inc()
                raise QueueOverflow(
                    "brownout shed tier active",
                    retry_after_s=(
                        gen.batcher.retry_after_s()
                        if gen.batcher is not None
                        else self.overload.price_retry_after(1.0, 0)
                    ),
                    tier=tier_name(blevel),
                    level=blevel,
                )
        # Cold/missing ALS artifacts: the registered sources (popularity and
        # friends) live in the pipeline, which is the fallback plane. The
        # degraded counter counts answered requests only; the no-source 503
        # is an error, not a degradation.
        if gen.model is None:
            if self.pipeline is None:
                return 503, {
                    "user_id": user_id,
                    "error": "no model loaded and no fallback source",
                    "items": [],
                }
            self.metrics.degraded.inc(reason="cold_artifacts")
            out = self.pipeline.recommend(
                user_id, k, exclude_seen=exclude_seen, deadline=deadline,
                brownout_level=blevel,
            )
            out.setdefault("degraded", []).insert(0, "cold_artifacts")
            return 200, self._pipeline_body(gen, user_id, k, out)

        if self.pipeline is not None:
            extra = {"als": gen.als_source} if gen.als_source is not None else None
            out = self.pipeline.recommend(
                user_id, k, exclude_seen=exclude_seen, extra_sources=extra,
                deadline=deadline, brownout_level=blevel,
            )
            return 200, self._pipeline_body(gen, user_id, k, out)

        if gen.batcher is not None:
            body = self._recommend_batched(gen, user_id, k, exclude_seen, deadline)
        else:
            body = self.recommend(user_id, k=k, exclude_seen=exclude_seen)
        if blevel > 0 and self.overload is not None and not body.get("error"):
            # The plain path answers at full quality until the shed tier, but
            # the response still carries the tier tag.
            body["brownout"] = {"level": blevel, "tier": tier_name(blevel)}
        return (404 if body.get("error") else 200), body

    def _pipeline_body(self, gen: ModelGeneration, user_id: int, k: int, out: dict) -> dict:
        """The two-stage response: ``stage``, ``degraded`` and ``items`` of
        ``{repo_id, score, source, repo_full_name}``, as the JAX server's."""
        body = {
            "user_id": user_id,
            "k": k,
            "generation": gen.number,
            "stage": out.get("stage"),
            "degraded": out.get("degraded", []),
            "items": [
                {**item, "repo_full_name": self._repo_names.get(item["repo_id"])}
                for item in out.get("items", [])
            ],
        }
        if out.get("brownout_level"):
            body["brownout"] = {
                "level": out["brownout_level"],
                "tier": out.get("brownout_tier"),
            }
        return body

    # -------------------------------------------------------- admin search

    def search_repos(self, q: str = "", limit: int = 20) -> list[dict]:
        """RepoInfoAdmin parity: search full_name/description, list language +
        stars + description (``app/admin.py:19-21``)."""
        df = self.repo_info
        if df.empty:
            return []
        if q:
            mask = df["repo_full_name"].fillna("").str.contains(q, case=False, regex=False)
            if "repo_description" in df.columns:
                mask |= df["repo_description"].fillna("").str.contains(q, case=False, regex=False)
            df = df[mask]
        cols = [
            c for c in ("repo_id", "repo_full_name", "repo_language",
                        "repo_stargazers_count", "repo_description")
            if c in df.columns
        ]
        return json.loads(df[cols].head(limit).to_json(orient="records"))

    def search_users(self, q: str = "", limit: int = 20) -> list[dict]:
        """UserInfoAdmin parity: search login/name/company, list name/company/
        location/bio (``app/admin.py:11-13``)."""
        df = self.user_info
        if df.empty:
            return []
        if q:
            mask = pd.Series(False, index=df.index)
            for col in ("user_login", "user_name", "user_company"):
                if col in df.columns:
                    mask |= df[col].fillna("").str.contains(q, case=False, regex=False)
            df = df[mask]
        cols = [
            c for c in ("user_id", "user_login", "user_name", "user_company",
                        "user_location", "user_bio")
            if c in df.columns
        ]
        return json.loads(df[cols].head(limit).to_json(orient="records"))
