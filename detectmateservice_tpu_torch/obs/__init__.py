"""Continuous drift and capacity observability on the port.

The port's copy of ``detectmateservice_tpu/obs/``:

* :mod:`.drift` — streaming score-distribution drift against a baseline
  pinned at promote time (KS + PSI over the rollout reservoir's paired
  rows and scores, per-feature PSI on the token columns), with
  hysteresis-gated ``drift_detected``/``drift_cleared`` events and an early
  ``RolloutManager.run_cycle(reason="drift")``;
* :mod:`.capacity` — a calibrated per-replica capacity model
  (``replica_capacity_lines_per_s``) from the drain path's batch tap while
  traffic flows and a bounded idle probe otherwise, plus
  ``capacity_headroom_ratio``, and the threadless
  :class:`~.capacity.SloTracker` behind ``GET /admin/slo``.
"""
from .capacity import CapacityMonitor, SloTracker
from .drift import DriftBaseline, DriftMonitor, ks_statistic, psi

__all__ = ["CapacityMonitor", "DriftBaseline", "DriftMonitor",
           "SloTracker", "ks_statistic", "psi"]
