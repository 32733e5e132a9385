"""Online inference engine: micro-batched ALS and two-stage serving over HTTP.

Port of ``albedo_tpu/serving``:

- ``service``  — :class:`RecommendationService`, the engine over a model
- ``pipeline`` — :class:`TwoStagePipeline`, candidate fan-out -> fusion ->
  LR re-rank with deadlines and degradation; :class:`BatchedALSSource`
- ``breaker``  — :class:`CircuitBreaker`, per-source circuit breakers
- ``batcher``  — :class:`MicroBatcher`, request coalescing into K6 launches
- ``cache``    — :class:`TTLCache`, hot-user result cache
- ``metrics``  — :class:`MetricsRegistry`, Prometheus ``/metrics`` plane
- ``overload`` — :class:`OverloadController`, AIMD admission, CoDel shed and
  the brownout ladder
- ``http``     — routes, hardening, load shedding, :func:`serve`

Not ported yet: ``reload`` (the hot-swap manager) and the retrieval-bank
candidate stage.
"""

from albedo_tpu_torch.serving.batcher import (
    BatcherClosed,
    DeadlineExceeded,
    MicroBatcher,
    QueueOverflow,
)
from albedo_tpu_torch.serving.breaker import BreakerConfig, CircuitBreaker
from albedo_tpu_torch.serving.cache import TTLCache
from albedo_tpu_torch.serving.http import ServerHandle, serve
from albedo_tpu_torch.serving.metrics import MetricsRegistry
from albedo_tpu_torch.serving.overload import OverloadConfig, OverloadController
from albedo_tpu_torch.serving.pipeline import BatchedALSSource, StageDeadlines, TwoStagePipeline
from albedo_tpu_torch.serving.service import ModelGeneration, RecommendationService

__all__ = [
    "BatchedALSSource",
    "BatcherClosed",
    "BreakerConfig",
    "CircuitBreaker",
    "DeadlineExceeded",
    "MetricsRegistry",
    "MicroBatcher",
    "ModelGeneration",
    "OverloadConfig",
    "OverloadController",
    "QueueOverflow",
    "RecommendationService",
    "ServerHandle",
    "StageDeadlines",
    "TTLCache",
    "TwoStagePipeline",
    "serve",
]
