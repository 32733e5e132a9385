"""Candidate recommenders: the ALS, curation and popularity sources the
ranker fuses (``LogisticRegressionRanker.scala:368-404``)."""

from albedo_tpu_torch.recommenders.als import ALSRecommender
from albedo_tpu_torch.recommenders.base import Recommender, fuse_candidates
from albedo_tpu_torch.recommenders.curation import CURATOR_IDS, CurationRecommender
from albedo_tpu_torch.recommenders.popularity import PopularityRecommender

__all__ = [
    "ALSRecommender",
    "CURATOR_IDS",
    "CurationRecommender",
    "PopularityRecommender",
    "Recommender",
    "fuse_candidates",
]
