"""Cross-process stats slab: fleet subprocesses → trainer registry.

Port of ``r2d2_tpu/telemetry/slab.py``, whole; the segment's byte layout
is the reference's, so a JAX fleet and a torch trainer (or the other way
round) read each other's slots.

- **Preallocated shared memory, no pickling**: one small
  ``multiprocessing.shared_memory`` segment holds ``num_slots`` fixed
  slots (one per fleet), each laid out by
  :func:`~r2d2_tpu_torch.replay.block.slot_layout` as ``(seq, values[K],
  crc32)``.  A fleet publishes by writing its whole float64 value vector
  plus a monotonically increasing sequence number, CRC32 last (the block
  channel's torn-write discipline, :func:`~r2d2_tpu_torch.replay.block.
  payload_crc32` over the ``(slot, seq)`` header + values).  The trainer
  polls each scrape; a CRC mismatch (producer SIGKILLed mid-publish,
  garbled slab) just keeps the previous good reading.
- **Counter monotonicity across respawns**: a respawned fleet's process
  restarts every counter (and its publish sequence) at zero.
  :class:`CounterMerger` detects the new incarnation by the published
  ``incarnation`` field changing (the watchdog bumps it per respawn) and
  folds the dead incarnation's last reading into a per-slot base, so the
  merged series ``base + current`` stays monotone through any number of
  respawns.  A seq regression without an incarnation bump folds too.
  Gauge fields skip the fold: latest reading wins.

The field schema is fixed at construction on both ends
(:data:`FLEET_STAT_FIELDS` for the actor plane) — no names travel on the
wire, only the value vector.
"""
from __future__ import annotations

from multiprocessing import shared_memory
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from r2d2_tpu_torch.replay.block import payload_crc32, slot_layout, slot_views

# (name, kind) schema of the actor-fleet stats slab; kind is "counter"
# (merged monotone across respawns) or "gauge" (latest reading wins)
FLEET_STAT_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("env_steps", "counter"),
    ("blocks_produced", "counter"),
    ("episodes", "counter"),
    ("episode_reward_sum", "counter"),
    ("param_version", "gauge"),
    ("incarnation", "gauge"),   # respawn generation — the merger's fold
                                # trigger (module docstring)
    # degraded-mode resilience counters (utils/resilience.py — the serve
    # fleets' act-RPC failover state, exported as resilience.*)
    ("act_retries", "counter"),
    ("circuit_opens", "counter"),
    ("local_acts", "counter"),
    ("circuit_state", "gauge"),  # 0 closed / 1 open / 2 half-open
)


def _slot_spec(num_fields: int):
    return (("seq", (1,), np.int64),
            ("values", (num_fields,), np.float64),
            ("crc32", (1,), np.uint32))


class StatsSlab:
    """Trainer-side owner of the stats shared-memory segment."""

    def __init__(self, num_slots: int,
                 fields: Sequence[Tuple[str, str]] = FLEET_STAT_FIELDS):
        self.fields = tuple(fields)
        self.num_slots = num_slots
        self.spec = _slot_spec(len(self.fields))
        self.slot_nbytes, self.offsets = slot_layout(self.spec)
        self.shm = shared_memory.SharedMemory(
            create=True, size=max(1, num_slots) * self.slot_nbytes)
        self._closed = False

    def writer_info(self, slot: int) -> Tuple[str, int]:
        """Picklable handle for a fleet child: (segment name, slot)."""
        return (self.shm.name, slot)

    def read(self, slot: int) -> Optional[Tuple[int, np.ndarray]]:
        """One consistent ``(seq, values)`` reading of ``slot``, or None
        when the slot was never published / the CRC fails (torn write —
        the caller keeps its previous good reading) / the slab is
        already closed (a late health scrape after shutdown)."""
        if self._closed:
            return None
        try:
            v = slot_views(self.shm.buf, self.spec, self.offsets,
                           self.slot_nbytes, slot)
            seq = int(v["seq"][0])
            if seq <= 0:
                return None
            values = np.array(v["values"])    # copy before the CRC check
            if int(v["crc32"][0]) != payload_crc32((slot, seq), [values]):
                return None
        except (ValueError, TypeError):       # closed under a late reader
            return None
        return seq, values

    def close(self) -> None:
        self._closed = True
        try:
            self.shm.close()
        except BufferError:
            # a late reader still holds slot views; the mapping dies
            # with the process — unlinking below still frees the name
            pass
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class StatsSlabWriter:
    """Fleet-side publisher (lives in the subprocess)."""

    def __init__(self, info: Tuple[str, int],
                 fields: Sequence[Tuple[str, str]] = FLEET_STAT_FIELDS):
        name, self.slot = info
        self.fields = tuple(fields)
        self.spec = _slot_spec(len(self.fields))
        self.slot_nbytes, self.offsets = slot_layout(self.spec)
        self.shm = shared_memory.SharedMemory(name=name)
        self._views = slot_views(self.shm.buf, self.spec, self.offsets,
                                 self.slot_nbytes, self.slot)
        self._order = [n for n, _ in self.fields]
        self._seq = 0
        self._buf = np.zeros(len(self.fields), np.float64)

    def publish(self, stats: Dict[str, float]) -> None:
        """Write the full value vector + seq, CRC32 last (torn-write
        discipline shared with the block channel)."""
        for i, field in enumerate(self._order):
            self._buf[i] = float(stats.get(field, 0.0))
        self._seq += 1
        v = self._views
        v["seq"][0] = self._seq
        v["values"][:] = self._buf
        v["crc32"][0] = payload_crc32((self.slot, self._seq), [self._buf])

    def close(self) -> None:
        try:
            self._views = None
            self.shm.close()
        except Exception:
            pass


class CounterMerger:
    """Fold per-slot publications into one monotone cross-fleet view.

    ``update(slot, seq, values)`` ingests a slab reading; ``totals()``
    returns ``{name: sum over slots}`` for counter fields (each slot
    contributing ``base + last`` — base absorbs dead incarnations, folded
    on *seq* regression, so the sum is monotone across respawns) and the
    latest per-slot reading for gauge fields under ``per_slot()``.
    """

    INCARNATION_FIELD = "incarnation"

    def __init__(self, num_slots: int,
                 fields: Sequence[Tuple[str, str]] = FLEET_STAT_FIELDS):
        self.fields = tuple(fields)
        self.num_slots = num_slots
        K = len(self.fields)
        self._counter_idx = [i for i, (_, kind) in enumerate(self.fields)
                             if kind == "counter"]
        names = [n for n, _ in self.fields]
        self._inc_idx = (names.index(self.INCARNATION_FIELD)
                         if self.INCARNATION_FIELD in names else None)
        self._base = np.zeros((num_slots, K), np.float64)
        self._last = np.zeros((num_slots, K), np.float64)
        self._seq = np.zeros(num_slots, np.int64)
        self._incarnation = np.full(num_slots, -1, np.int64)
        self._folds = np.zeros(num_slots, np.int64)

    def update(self, slot: int, seq: int, values: np.ndarray) -> bool:
        """Returns True when the reading advanced this slot's view."""
        inc = (int(values[self._inc_idx]) if self._inc_idx is not None
               else self._incarnation[slot])
        # a new stream is an incarnation bump (watchdog respawn) OR a
        # seq regression without one (producer restarted outside the
        # watchdog) — either way the old stream's counters must fold, or
        # totals() would regress when the fresh small values land
        new_stream = (inc != self._incarnation[slot]
                      and self._inc_idx is not None
                      ) or seq < self._seq[slot]
        if not new_stream and seq <= self._seq[slot]:
            return False          # a reading we already merged
        if new_stream:
            # fold the dead stream's final counters into the base (the
            # very first reading folds zeros — harmless)
            if self._incarnation[slot] >= 0:
                self._folds[slot] += 1
            for i in self._counter_idx:
                self._base[slot, i] += self._last[slot, i]
            self._incarnation[slot] = inc
        self._seq[slot] = seq
        self._last[slot] = values
        return True

    def totals(self) -> Dict[str, float]:
        """Counter fields summed across slots (monotone through
        respawns)."""
        merged = self._base + self._last
        return {self.fields[i][0]: float(merged[:, i].sum())
                for i in self._counter_idx}

    def per_slot(self) -> List[Dict[str, float]]:
        """Every field's current per-slot view: counters as
        ``base + last``, gauges as the latest reading."""
        out: List[Dict[str, float]] = []
        counter_set = set(self._counter_idx)
        for s in range(self.num_slots):
            row = {}
            for i, (name, _) in enumerate(self.fields):
                row[name] = float(self._base[s, i] + self._last[s, i]
                                  if i in counter_set else self._last[s, i])
            out.append(row)
        return out

    def incarnations(self) -> List[int]:
        """Respawn folds observed per slot (a telemetry-visible respawn
        count independent of the watchdog's own accounting)."""
        return [int(x) for x in self._folds]
