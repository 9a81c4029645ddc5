"""Checkpoint / resume, torch-native.

Port of ``r2d2_tpu/checkpoint.py`` (``Checkpointer`` save/restore/steps/GC
and the architecture guard).  The reference saves ``(state_dict,
num_updates, env_steps, minutes)`` and has no resume path; here each
checkpoint holds the full :class:`~r2d2_tpu_torch.learner.step.TrainState`
(params, target params, Adam moments and count, step) with bit-exact
resume:

- step N is a ``step_N/`` directory holding ``state.pt``, written with
  ``torch.save`` (CPU tensors, plain dicts and ints, so it loads with
  ``weights_only=True``);
- a ``step_N.meta.json`` sidecar (env_steps, wall minutes, game, the
  architecture fields) is written LAST and atomically, so a crash mid-save
  leaves a directory without a sidecar, which ``steps``/``latest_step``
  never select;
- ``keep`` > 0 garbage-collects all but the newest ``keep`` complete
  checkpoints.

The replay and session snapshots wait for the ``train()`` slice.  A JAX
(orbax) checkpoint carries across through ``models/convert.py``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from r2d2_tpu_torch.learner.step import AdamState, TrainState

_STEP_RE = re.compile(r"^step_(\d+)$")
_STATE_FILE = "state.pt"


def state_to_dict(state: TrainState) -> Dict[str, Any]:
    """The checkpoint payload: CPU copies of every tensor, plain types."""
    def cpu(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    return dict(step=int(state.step), params=cpu(state.params),
                target_params=cpu(state.target_params),
                opt_state=dict(count=int(state.opt_state.count),
                               mu=cpu(state.opt_state.mu),
                               nu=cpu(state.opt_state.nu)))


def state_from_dict(d: Dict[str, Any]) -> TrainState:
    opt = d["opt_state"]
    return TrainState(step=int(d["step"]), params=dict(d["params"]),
                      target_params=dict(d["target_params"]),
                      opt_state=AdamState(count=int(opt["count"]),
                                          mu=dict(opt["mu"]),
                                          nu=dict(opt["nu"])))


class Checkpointer:
    """Saves/restores TrainStates under ``directory/step_N``, with the
    metadata in a JSON sidecar ``step_N.meta.json`` so the evaluator can
    sweep checkpoints without loading a state."""

    def __init__(self, directory: str, keep: int = 0):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.meta.json")

    def save(self, step: int, state: TrainState,
             meta: Optional[Dict[str, Any]] = None) -> None:
        path = self._path(step)
        meta_path = self._meta_path(step)
        # overwriting a step (a fresh run in an old directory): the sidecar
        # goes first, so the step is never selectable with a payload
        # being rewritten under it
        if os.path.exists(meta_path):
            os.remove(meta_path)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{_STATE_FILE}.tmp{os.getpid()}")
        torch.save(state_to_dict(state), tmp)
        os.replace(tmp, os.path.join(path, _STATE_FILE))
        # the sidecar commits last, atomically: the follow-mode evaluator
        # gates on its existence and reads it at once
        mtmp = f"{meta_path}.tmp{os.getpid()}"
        with open(mtmp, "w") as f:
            json.dump(dict(meta or {}, step=step), f)
        os.replace(mtmp, meta_path)
        self._gc()

    def steps(self, complete: bool = True) -> list:
        """Checkpointed steps, ascending.  ``complete=True`` (default)
        lists only steps whose meta sidecar exists."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                step = int(m.group(1))
                if complete and not self.has_meta(step):
                    continue
                out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """Newest COMPLETE step (sidecar present), or None."""
        steps = self.steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        """Retention: drop all but the newest ``keep`` complete
        checkpoints; a directory without a sidecar (a save in progress) is
        never collected."""
        if self.keep <= 0:
            return
        for step in self.steps()[:-self.keep]:
            # sidecar FIRST: once it is gone the step cannot be selected,
            # so a crash mid-GC leaves no selectable half-deleted step
            try:
                os.remove(self._meta_path(step))
            except FileNotFoundError:
                pass
            shutil.rmtree(self._path(step), ignore_errors=True)

    def has_meta(self, step: int) -> bool:
        """Whether ``step``'s sidecar exists: it marks a finished save."""
        return os.path.exists(self._meta_path(step))

    def peek_meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """A checkpoint's sidecar, without loading the state (for
        pre-restore validation); {} when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.exists(self._meta_path(step)):
            return {}
        with open(self._meta_path(step)) as f:
            return json.load(f)

    def restore(self, step: Optional[int] = None
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Restore ``step`` (default: the latest complete one) as a
        TrainState of CPU tensors, with its sidecar."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = torch.load(os.path.join(self._path(step), _STATE_FILE),
                             map_location="cpu", weights_only=True)
        return state_from_dict(payload), self.peek_meta(step)


# config fields that change parameter shapes; recorded in the checkpoint
# metadata sidecar and validated before restore so a mismatch fails with an
# actionable message instead of a shape error deep in the load
ARCH_FIELDS = ("obs_space_to_depth", "obs_shape", "torso", "hidden_dim",
               "lstm_layers")


def arch_meta(cfg: Any) -> Dict[str, Any]:
    return {f: getattr(cfg, f) for f in ARCH_FIELDS}


def check_arch_compat(cfg: Any, meta: Dict[str, Any]) -> None:
    """Raise if the checkpoint was written under a different network
    architecture than ``cfg`` describes.  Metas without the recorded
    fields pass through."""
    mismatches = []
    for f in ARCH_FIELDS:
        if f in meta:
            want, have = meta[f], getattr(cfg, f)
            if isinstance(have, tuple):
                have = list(have)
            if want != have:
                mismatches.append(f"{f}: checkpoint={want!r} config={have!r}")
    if mismatches:
        raise ValueError(
            "checkpoint/config architecture mismatch — restore would fail "
            "or load garbage. Align the config or use a fresh checkpoint "
            "dir:\n  " + "\n  ".join(mismatches))
