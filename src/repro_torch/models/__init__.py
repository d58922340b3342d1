"""LM substrate: composable decoder stacks for the assigned architectures."""

from .config import ArchConfig, LayerSpec
from .model import Model

__all__ = ["ArchConfig", "LayerSpec", "Model"]
