"""Candidate recommenders: the ALS, curation and popularity sources the
ranker fuses (``LogisticRegressionRanker.scala:368-404``), and the other
candidate generators (content, tf-idf, item-CF and user-CF)."""

from albedo_tpu_torch.recommenders.als import ALSRecommender
from albedo_tpu_torch.recommenders.base import Recommender, fuse_candidates, recent_starred_provider
from albedo_tpu_torch.recommenders.cf import ItemCFRecommender, UserCFRecommender
from albedo_tpu_torch.recommenders.content import ContentRecommender, EmbeddingSearchBackend, SearchBackend
from albedo_tpu_torch.recommenders.curation import CURATOR_IDS, CurationRecommender
from albedo_tpu_torch.recommenders.popularity import PopularityRecommender
from albedo_tpu_torch.recommenders.tfidf import TfidfRecommender, TfidfSimilaritySearch

__all__ = [
    "ALSRecommender",
    "CURATOR_IDS",
    "ContentRecommender",
    "CurationRecommender",
    "EmbeddingSearchBackend",
    "ItemCFRecommender",
    "PopularityRecommender",
    "Recommender",
    "SearchBackend",
    "TfidfRecommender",
    "TfidfSimilaritySearch",
    "UserCFRecommender",
    "fuse_candidates",
    "recent_starred_provider",
]
