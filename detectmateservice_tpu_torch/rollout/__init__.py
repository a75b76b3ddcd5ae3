"""Online learning and zero-downtime model rollout on the port.

The port's copy of ``detectmateservice_tpu/rollout/``: ``TrafficSampler``
taps the drain path, ``RolloutManager`` fine-tunes candidates off the live
weights, the ``CheckpointStore`` rotates crash-atomic versioned checkpoints,
the ``ShadowEvaluator`` gates promotion on shadow-scoring divergence, and
the detector copies a promoted candidate into its live weights in place,
so every captured CUDA graph stays valid. See docs/model_lifecycle.md.
"""
from .manager import RolloutError, RolloutManager
from .sampler import TrafficSampler
from .shadow import ShadowEvaluator
from .store import CheckpointStore, StoreError

__all__ = [
    "CheckpointStore",
    "RolloutError",
    "RolloutManager",
    "ShadowEvaluator",
    "StoreError",
    "TrafficSampler",
]
