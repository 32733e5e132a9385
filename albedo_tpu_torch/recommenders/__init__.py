"""Candidate recommenders (the ALS source of this port)."""

from albedo_tpu_torch.recommenders.als import ALSRecommender
from albedo_tpu_torch.recommenders.base import Recommender

__all__ = ["ALSRecommender", "Recommender"]
