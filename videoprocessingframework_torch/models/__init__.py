"""Bundled models and weight conversion."""

from .resnet import ResNet, resnet18_like, resnet50
from .weights import from_jax_variables

__all__ = ["ResNet", "from_jax_variables", "resnet18_like", "resnet50"]
