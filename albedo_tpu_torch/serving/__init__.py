"""Online inference engine: micro-batched ALS serving over HTTP.

Port of ``albedo_tpu/serving`` for its ALS path:

- ``service``  — :class:`RecommendationService`, the engine over a model
- ``batcher``  — :class:`MicroBatcher`, request coalescing into K6 launches
- ``cache``    — :class:`TTLCache`, hot-user result cache
- ``metrics``  — :class:`MetricsRegistry`, Prometheus ``/metrics`` plane
- ``overload`` — :class:`OverloadController`, AIMD admission, CoDel shed and
  the brownout ladder
- ``http``     — routes, hardening, load shedding, :func:`serve`

Not ported yet: ``pipeline`` (the two-stage fan-out and re-rank),
``breaker`` and ``reload`` (the hot-swap manager).
"""

from albedo_tpu_torch.serving.batcher import (
    BatcherClosed,
    DeadlineExceeded,
    MicroBatcher,
    QueueOverflow,
)
from albedo_tpu_torch.serving.cache import TTLCache
from albedo_tpu_torch.serving.http import ServerHandle, serve
from albedo_tpu_torch.serving.metrics import MetricsRegistry
from albedo_tpu_torch.serving.overload import OverloadConfig, OverloadController
from albedo_tpu_torch.serving.service import ModelGeneration, RecommendationService

__all__ = [
    "BatcherClosed",
    "DeadlineExceeded",
    "MetricsRegistry",
    "MicroBatcher",
    "ModelGeneration",
    "OverloadConfig",
    "OverloadController",
    "QueueOverflow",
    "RecommendationService",
    "ServerHandle",
    "TTLCache",
    "serve",
]
