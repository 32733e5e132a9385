"""Trained models: implicit ALS, Word2Vec, the weighted logistic regression
and the BPR ranking factorization."""

from albedo_tpu_torch.models.als import ALSModel, ImplicitALS
from albedo_tpu_torch.models.logistic_regression import LogisticRegression, LogisticRegressionModel
from albedo_tpu_torch.models.ranking_factorization import RankingFactorization, RankingFactorizationModel
from albedo_tpu_torch.models.word2vec import Word2Vec, Word2VecModel

__all__ = [
    "ALSModel",
    "ImplicitALS",
    "LogisticRegression",
    "LogisticRegressionModel",
    "RankingFactorization",
    "RankingFactorizationModel",
    "Word2Vec",
    "Word2VecModel",
]
