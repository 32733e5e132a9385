"""Trained models: implicit ALS, Word2Vec and the weighted logistic regression."""

from albedo_tpu_torch.models.als import ALSModel, ImplicitALS
from albedo_tpu_torch.models.logistic_regression import LogisticRegression, LogisticRegressionModel
from albedo_tpu_torch.models.word2vec import Word2Vec, Word2VecModel

__all__ = [
    "ALSModel",
    "ImplicitALS",
    "LogisticRegression",
    "LogisticRegressionModel",
    "Word2Vec",
    "Word2VecModel",
]
