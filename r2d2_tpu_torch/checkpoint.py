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
  checkpoints (their replay snapshots with them).

Snapshots, as the reference writes them: ``save_replay``/``restore_replay``
persist the full replay plane — ring bytes, sum-tree leaves, counters,
actor snapshots — atomically (tmp dir + rename, ``meta.json`` committed
last, the newest ``max(1, keep)`` kept by commit time), and
``save_sessions``/``restore_sessions`` the session tier's live episodes
(with the ``.old`` fallback).  The ``ring.bin``/``meta.json`` layout is the
JAX package's, so a replay snapshot written by either restores in the
other.  A ``chaos`` hook lets drills truncate a save mid-write
(``truncate_ckpt``) to prove the skip path.  A JAX (orbax) checkpoint
carries across through ``models/convert.py``.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import shutil
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from r2d2_tpu_torch.learner.step import AdamState, TrainState

_STEP_RE = re.compile(r"^step_(\d+)$")
_REPLAY_RE = re.compile(r"^step_(\d+)\.replay$")
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
        # optional utils.chaos.ChaosInjector: "truncate_ckpt" truncates a
        # save's payload and skips its sidecar (a crash mid-save)
        self.chaos = None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.meta.json")

    def _replay_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.replay")

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
        if self.chaos is not None and self.chaos.fire("truncate_ckpt"):
            # injected crash mid-save: chop the payload and skip the
            # sidecar — restore must never select this step
            truncate_checkpoint_dir(path)
            return
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
            shutil.rmtree(self._replay_path(step), ignore_errors=True)

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

    # ------------------------------------------------------ replay snapshot
    def save_replay(self, step: int, writer: Callable[[str], Dict[str, Any]],
                    actors: Optional[Any] = None) -> None:
        """Write the full replay snapshot for ``step`` atomically.

        ``writer(ring_path)`` serialises the payload (ReplayBuffer
        .write_state) and returns its JSON-able meta; ``actors`` is the
        per-fleet actor snapshot list (pickled alongside).  Everything
        lands in a tmp dir with ``meta.json`` committed last INSIDE it,
        then one rename publishes the dir — a crash at any point leaves
        either the old snapshot or an ignorable ``*.tmp*`` dir, never a
        torn snapshot (restore_replay only considers dirs whose meta.json
        exists)."""
        final = self._replay_path(step)
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            meta = dict(writer(os.path.join(tmp, "ring.bin")), step=step,
                        has_actors=actors is not None)
            if actors is not None:
                with open(os.path.join(tmp, "actors.pkl"), "wb") as f:
                    pickle.dump(actors, f)
            if self.chaos is not None and self.chaos.fire("truncate_ckpt"):
                return  # injected crash: the partial tmp dir IS the drill
            mtmp = os.path.join(tmp, "meta.json.tmp")
            with open(mtmp, "w") as f:
                json.dump(meta, f)
            os.replace(mtmp, os.path.join(tmp, "meta.json"))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            # replay snapshots are ring-sized: keep only the newest
            # ``max(1, keep)``, ordered by COMMIT TIME, not step — step
            # counters regress across runs sharing a dir, and a
            # step-ordered prune would delete the snapshot it just wrote
            for _, _, path in self._replay_entries()[:-max(1, self.keep)]:
                shutil.rmtree(path, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _replay_entries(self) -> list:
        """COMPLETE replay snapshots as ``(commit mtime, step, path)``,
        oldest first.  meta.json commits last, so its mtime is the
        snapshot's publication time."""
        out = []
        for name in os.listdir(self.directory):
            m = _REPLAY_RE.match(name)
            if not m:
                continue
            meta = os.path.join(self.directory, name, "meta.json")
            try:
                mtime = os.path.getmtime(meta)
            except OSError:  # partial snapshot: no meta.json
                continue
            out.append((mtime, int(m.group(1)),
                        os.path.join(self.directory, name)))
        return sorted(out)

    def replay_steps(self) -> list:
        """Steps with a COMPLETE replay snapshot (meta.json present),
        ascending."""
        return sorted(s for _, s, _ in self._replay_entries())

    def restore_replay(self, step: Optional[int] = None
                       ) -> Optional[Tuple[Dict[str, Any], str, Any]]:
        """Latest (or ``step``'s) complete replay snapshot as
        ``(meta, ring_path, actor_snapshots_or_None)``, or None when no
        complete snapshot exists.  "Latest" means most recently COMMITTED
        (meta.json mtime).  Partial snapshots (no meta.json — a crash
        mid-write) are never selected."""
        entries = self._replay_entries()
        if step is None:
            if not entries:
                return None
            step = entries[-1][1]
        elif step not in [s for _, s, _ in entries]:
            return None
        path = self._replay_path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        actors = None
        if meta.get("has_actors"):
            with open(os.path.join(path, "actors.pkl"), "rb") as f:
                actors = pickle.load(f)
        return meta, os.path.join(path, "ring.bin"), actors

    # ---------------------------------------------------- session snapshot
    def _sessions_path(self) -> str:
        return os.path.join(self.directory, "sessions.snap")

    def save_sessions(self, writer: Callable[[str], Dict[str, Any]]
                      ) -> Optional[Dict[str, Any]]:
        """Persist the session tier's live-episode store atomically:
        ``writer(payload_path)`` serialises the hidden pool + per-session
        meta and returns its JSON-able meta; everything lands in a tmp dir
        with ``meta.json`` committed last, then one rename publishes it.
        One snapshot, latest-wins."""
        final = self._sessions_path()
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            meta = dict(writer(os.path.join(tmp, "sessions.bin")))
            if self.chaos is not None and self.chaos.fire("truncate_ckpt"):
                return None  # injected crash: the partial tmp dir
            mtmp = os.path.join(tmp, "meta.json.tmp")
            with open(mtmp, "w") as f:
                json.dump(meta, f)
            os.replace(mtmp, os.path.join(tmp, "meta.json"))
            # two renames, never a window with NO committed snapshot: the
            # predecessor steps aside to ``.old`` (restore's fallback),
            # the new one lands, the fallback is collected
            old = f"{final}.old"
            shutil.rmtree(old, ignore_errors=True)
            if os.path.isdir(final):
                os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
            return meta
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def restore_sessions(self) -> Optional[Tuple[Dict[str, Any], str]]:
        """``(meta, payload_path)`` of the committed session snapshot, or
        None (no snapshot, or a torn one whose meta.json never landed).
        Falls back to the ``.old`` snapshot a crash mid-publish may have
        left as the only committed state."""
        for path in (self._sessions_path(), f"{self._sessions_path()}.old"):
            meta_path = os.path.join(path, "meta.json")
            if not os.path.exists(meta_path):
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            return meta, os.path.join(path, "sessions.bin")
        return None


def truncate_checkpoint_dir(path: str) -> None:
    """Simulate a crash mid-save: truncate the largest file under ``path``
    to half its size.  Chaos drills only — the restore path must skip such
    a step because its sidecar never landed."""
    largest, size = None, -1
    for root, _, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            try:
                s = os.path.getsize(p)
            except OSError:
                continue
            if s > size:
                largest, size = p, s
    if largest is not None:
        with open(largest, "r+b") as f:
            f.truncate(max(0, size // 2))


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
