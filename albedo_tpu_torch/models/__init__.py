"""Trained models: implicit ALS."""

from albedo_tpu_torch.models.als import ALSModel, ImplicitALS

__all__ = ["ALSModel", "ImplicitALS"]
