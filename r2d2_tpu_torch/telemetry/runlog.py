"""Persistent JSONL run log: the durable record of a training run.

Port of ``r2d2_tpu/telemetry/runlog.py``, copied whole; the file format
is the same, so either package's readers read either package's logs.

``train()``'s stats entries previously lived only in an unbounded
in-process ``logs`` list — nothing survived the process, and a
SIGTERM→resume soak produced no continuous curve anywhere.  The
:class:`RunLog` is the source of truth instead:

- One JSON object per line, appended (NEVER truncated) to
  ``<ckpt_dir>/telemetry/run.jsonl`` — a resumed run reopens the same
  file in append mode, so a preempt/resume cycle yields ONE file whose
  ``training_steps`` curve continues monotonically across the restart.
- **Size-capped rotation**: when the active file would exceed
  ``max_bytes``, it is renamed to ``run.jsonl.1`` (older segments shift
  up, the oldest beyond ``keep`` is deleted) and a fresh file starts.
  Rotation preserves every byte ever written (up to the keep budget);
  the cap bounds any single file, not the history.
- Writes are line-atomic under the instance lock and flushed per entry,
  so a ``kill -9`` loses at most the entry being written and a tail
  (tools/r2d2_top.py) sees entries promptly.

:func:`read_entries` is the reader used by tests and tooling: it streams
the rotated segments oldest-first, skipping any torn final line.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional


class RunLog:
    """Append-only, size-rotated JSONL sink (see module docstring)."""

    def __init__(self, directory: str, filename: str = "run.jsonl",
                 max_bytes: int = 64_000_000, keep: int = 3):
        if max_bytes < 1024:
            raise ValueError("max_bytes must be >= 1024")
        self.directory = directory
        self.filename = filename
        self.max_bytes = max_bytes
        self.keep = max(1, keep)
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        # append mode IS the resume semantics: a restarted run continues
        # the same file, never truncates it
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def append(self, entry: Dict[str, Any]) -> None:
        """Write one entry as a single JSON line (flushed)."""
        line = json.dumps(entry, separators=(",", ":"), default=str) + "\n"
        with self._lock:
            if self._fh is None:
                return
            if self._size + len(line) > self.max_bytes and self._size > 0:
                self._rotate_locked()
            self._fh.write(line)
            self._fh.flush()
            self._size += len(line)

    def _rotate_locked(self) -> None:
        self._fh.close()
        # drop the segment past the keep budget, then shift .(k) → .(k+1)
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for k in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{k}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{k + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def artifact_log(out: Optional[str], default: str) -> "RunLog":
    """A RunLog placed next to a tool's ``--out`` summary artifact
    (``OUT.json`` → ``OUT.telemetry.jsonl``; no --out → ``default`` in
    the cwd) — the shared path convention of tools/soak.py and
    tools/chaos_soak.py."""
    if out:
        base = out[:-5] if out.endswith(".json") else out
        directory, name = os.path.split(base + ".telemetry.jsonl")
        return RunLog(directory or ".", filename=name)
    return RunLog(".", filename=default)


def segment_paths(path: str) -> List[str]:
    """Every on-disk segment of a run log, oldest first: highest-numbered
    rotation down to the active file."""
    out: List[str] = []
    k = 1
    while os.path.exists(f"{path}.{k}"):
        k += 1
    for i in range(k - 1, 0, -1):
        out.append(f"{path}.{i}")
    if os.path.exists(path):
        out.append(path)
    return out


def read_entries(path: str, include_rotated: bool = True
                 ) -> Iterator[Dict[str, Any]]:
    """Stream entries oldest-first across the rotated segments; a torn
    final line (kill -9 mid-write) is skipped, not fatal."""
    paths = segment_paths(path) if include_rotated else (
        [path] if os.path.exists(path) else [])
    for p in paths:
        with open(p, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue


def tail_entry(path: str) -> Optional[Dict[str, Any]]:
    """The newest complete entry of the ACTIVE file (cheap seek-from-end
    read — what the live terminal view polls)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        fh.seek(max(0, size - 65536))
        chunk = fh.read().decode("utf-8", errors="replace")
    for line in reversed(chunk.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None
