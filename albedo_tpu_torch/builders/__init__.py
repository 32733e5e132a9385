"""Entry-point builders: the profile builders, the ranker and the CLI jobs."""

from albedo_tpu_torch.builders.profiles import (
    FeatureColumns,
    build_repo_profile,
    build_user_profile,
)
from albedo_tpu_torch.builders.ranker import (
    ALSScorer,
    RankerConfig,
    RankerModel,
    RankerResult,
    build_feature_pipeline,
    reduce_starring,
    train_ranker,
)

__all__ = [
    "ALSScorer",
    "FeatureColumns",
    "RankerConfig",
    "RankerModel",
    "RankerResult",
    "build_feature_pipeline",
    "build_repo_profile",
    "build_user_profile",
    "reduce_starring",
    "train_ranker",
]
