"""Versioned immutable parameter publication.

Port of ``r2d2_tpu/utils/store.py``.  Replaces the reference's shared-memory
model mutation (``train.py:23``, ``worker.py:306-307``), which tolerates
torn reads across tensors while the learner writes.  The learner publishes
a snapshot under a lock and actors pull by version.

The snapshot must be a copy: the port's optimizer updates the learner's
parameters in place, so a published dict that aliased them would change
under the actors mid-act.  ``Learner._publish`` hands over a detached
clone; the store never copies what it is given.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


class ParamStore:
    def __init__(self, params: Optional[Params] = None):
        self._lock = threading.Lock()
        self._version = 0 if params is None else 1
        self._params = params
        self._placed: dict = {}  # device -> (version, placed params)

    def publish(self, params: Params) -> int:
        """Swap in a new snapshot; returns its version (monotonic from 1)."""
        with self._lock:
            self._params = params
            self._version += 1
            # drop the previous generation's placements: entries for
            # devices whose consumers have exited would otherwise pin a
            # full placed param copy each, forever
            self._placed.clear()
            return self._version

    def get(self) -> Tuple[int, Optional[Params]]:
        """Latest ``(version, params)``; params is None until first publish."""
        with self._lock:
            return self._version, self._params

    def get_placed(self, device: Any) -> Tuple[int, Optional[Params]]:
        """Latest ``(version, params on device)``: the ``.to(device)`` copy
        is made once per (version, device) and shared by every consumer on
        that device.  The copy runs outside the lock, so a slow transfer
        never blocks ``publish``/``get``; concurrent same-version callers
        may both copy (last one cached) rather than serialise on it."""
        device = torch.device(device)
        with self._lock:
            version, params = self._version, self._params
            cached = self._placed.get(device)
            if cached is not None and cached[0] == version:
                return cached
        if params is not None:
            params = {k: v.to(device) for k, v in params.items()}
        entry = (version, params)
        with self._lock:
            if self._version == version:  # don't cache a stale snapshot
                self._placed[device] = entry
        return entry
