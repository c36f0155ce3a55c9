"""Consistency Controller (paper §4.3, Fig. 3).

Pure decision logic: given a policy and the relevant worker/server state,
decide whether an access may proceed or must block, and what condition wakes
it.  The controller is deliberately side-effect free so it can be unit- and
property-tested in isolation; the event-driven simulator
(:mod:`repro_torch.core.server`) and the threaded runtime
(:mod:`repro_torch.runtime`) both consult it.

Semantics implemented (paper §2):

* **Clock bound** (BSP/SSP/CAP/CVAP): a worker whose clock is ``c`` must see
  every update timestamped ``≤ c - s - 1`` from every other worker, else it
  blocks (fast workers wait for slow ones).

* **Value bound** (VAP/CVAP): applying an update that would push the
  element-wise accumulated *unsynchronized* sum beyond ``v_thr`` blocks the
  worker — unless the accumulator is zero at the violating elements, which
  admits a single update of magnitude ``> v_thr`` (hence the paper's
  ``max(u, v_thr)`` bound, Fig. 1).

* **Strong-VAP delivery gate**: an update may begin *partial* delivery only
  while the total magnitude of half-synchronized updates for its parameter
  stays within ``max(u, v_thr)``; otherwise it queues behind them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.policies import Policy


def clock_gate(policy: Policy, my_clock: int,
               delivered_frontier: np.ndarray) -> bool:
    """May a worker at clock ``my_clock`` begin its next computation?

    ``delivered_frontier[q]`` is the highest timestamp T such that ALL
    updates from peer q with timestamp ≤ T have been delivered to this
    worker (-1 if none needed yet).
    """
    if not policy.clock_bounded:
        return True
    need = my_clock - policy.staleness - 1
    if need < 0:
        return True
    return bool(np.all(delivered_frontier >= need))


def observed_staleness(my_clock: int, delivered_frontier: np.ndarray) -> int:
    """Worst-case staleness this read experiences (for invariant checks)."""
    if len(delivered_frontier) == 0:
        return 0
    return int(my_clock - delivered_frontier.min() - 1)


def value_gate(policy: Policy, unsynced: np.ndarray,
               delta: np.ndarray) -> Tuple[bool, np.ndarray]:
    """May this update be applied under the value bound?

    Returns ``(ok, violating_mask)``.  Element-wise: blocked where the new
    accumulated magnitude would exceed v_thr AND the current accumulator is
    non-zero (a lone oversized update is admitted — paper Fig. 1 semantics,
    yielding the max(u, v_thr) bound).
    """
    if not policy.value_bounded:
        return True, np.zeros_like(delta, dtype=bool)
    new_acc = np.abs(unsynced + delta)
    # the 1e-12 tolerance absorbs float residue left by add/subtract cycles
    violating = (new_acc > policy.value_bound) & (np.abs(unsynced) > 1e-12)
    return not bool(violating.any()), violating


def strong_delivery_gate(policy: Policy, halfsync_mag: np.ndarray,
                         delta: np.ndarray) -> bool:
    """May this update begin partial delivery (strong VAP only)?"""
    if not (policy.value_bounded and policy.strong):
        return True
    mag = np.abs(delta)
    budget = np.maximum(policy.value_bound, mag)   # max(u, v_thr), element-wise
    # admit if nothing is currently half-synchronized at the violating spots
    # (1e-12 tolerance absorbs float residue left by add/subtract cycles)
    total = halfsync_mag + mag
    violating = (total > budget) & (halfsync_mag > 1e-12)
    return not bool(violating.any())


def vap_unsynced_bound(policy: Policy, max_update_mag: float) -> float:
    """The guaranteed bound on any worker's unsynchronized accumulator."""
    return max(max_update_mag, policy.value_bound)


def elastic_gate(policy: Policy, acc_norm: float, new_norm: float) -> bool:
    """May this update be applied under the elastic norm bound?

    ``acc_norm`` is the L2 norm of the worker's *whole* unsynchronized
    accumulator (all keys stacked) before the update, ``new_norm`` the norm
    it would have after.  Blocked when the new norm would exceed B AND the
    accumulator is non-empty — a lone oversized update is admitted, mirroring
    VAP's Fig. 1 semantics and yielding the ``max(‖u‖₂, B)`` bound.
    """
    if not policy.norm_bounded:
        return True
    if new_norm <= policy.value_bound + 1e-9:
        return True
    # the 1e-12 tolerance absorbs float residue left by add/subtract cycles
    return acc_norm <= 1e-12


def elastic_unsynced_bound(policy: Policy, max_update_norm: float) -> float:
    """The guaranteed bound on ‖any worker's unsynced sum‖₂ (elastic)."""
    return max(max_update_norm, policy.value_bound)
