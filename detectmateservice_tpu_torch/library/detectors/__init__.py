"""Detectors of the port."""
from .torch_scorer import TorchScorerDetector, TorchScorerDetectorConfig

__all__ = ["TorchScorerDetector", "TorchScorerDetectorConfig"]
