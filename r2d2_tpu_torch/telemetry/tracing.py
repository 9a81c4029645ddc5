"""Cross-process structured event tracing.  Port of
``r2d2_tpu/telemetry/tracing.py``.

The metrics plane reports *rates*; this module answers *where a
microsecond went*: a preallocated, ring-buffered event tracer usable
from every process of the fabric — trainer, fleet subprocesses, replay
shard owners — whose rings merge into ONE Chrome-trace-event JSON
viewable in Perfetto, one process track per ring, with correct relative
timestamps.

- **Preallocated ring, near-zero disarmed cost.**  Each process owns one
  fixed-capacity ring of fixed-size records (:data:`EVENT_DTYPE`); the
  fast path is one attribute check (``self.armed``) when disarmed, and
  one locked structured-row write when armed.
- **Shared-memory slots.**  Subprocess rings live in a
  :class:`TraceSlab` — one shm segment, one slot per process, laid out by
  :func:`~r2d2_tpu_torch.replay.block.slot_layout` with a ``(seq, count,
  crc32)`` publish header, CRC written last: a torn or garbled slot fails
  its CRC at harvest and is dropped and counted, never mis-merged.  The
  layout is the JAX package's byte for byte, so either package's
  harvester reads the other's slab.
- **Clock model.**  Each writer records against its own
  ``time.perf_counter()`` and publishes the pair ``(t0_perf, t0_wall)``;
  the merger maps events to the shared wall clock as ``t0_wall + (ts -
  t0_perf)``.
- **Capture windows.**  The slab header carries ``(capture_id, armed)``
  control words the trainer writes and every writer polls at its
  publish cadence; a bumped ``capture_id`` resets the writer's ring.
- **Flow (block-lineage) events.**  A record may carry a ``flow`` id and
  a flow phase (``s``/``t``/``f``); the merger emits the matching Chrome
  flow events, so one block's life renders as one arrow chain across the
  process tracks.  Trace ids are incarnation-tagged
  (:meth:`EventTracer.next_trace_id`).

Numpy and the standard library only at import (the shard children import
neither torch nor JAX); :class:`ProfileController` imports
``torch.profiler`` when it records.  The process-wide :data:`EVENTS` is
what instrumented code records against; ``train()`` attaches it to slot
0 of the run's slab and each subprocess worker to the slot its plane
assigned.
"""
from __future__ import annotations

import json
import os
import threading
import time
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.replay.block import payload_crc32, slot_layout, slot_views

# One trace record.  ``name`` is a fixed-size byte string (no pickling,
# no string table to keep coherent across processes); ``ph`` is the
# Chrome phase (X complete / i instant); ``fph`` an optional flow phase
# (s start / t step / f end) bound to ``flow``; ``ts`` is the writer's
# LOCAL perf_counter seconds, ``dur`` seconds.
EVENT_DTYPE = np.dtype([
    ("name", "S48"), ("ph", "S1"), ("fph", "S1"),
    ("ts", np.float64), ("dur", np.float64),
    ("flow", np.int64), ("arg", np.int64),
], align=True)

# control words at the head of the slab, written by the trainer and
# polled by every writer (at publish cadence — never per event)
_CTRL_SPEC = (("capture_id", (1,), np.int64),
              ("armed", (1,), np.int64))


def _slot_spec(capacity: int):
    """One writer slot: publish header + clock pair + identity + the
    event ring + CRC (written LAST — the stats-slab discipline)."""
    return (("seq", (1,), np.int64),
            ("count", (1,), np.int64),        # total events ever written
            ("clock", (2,), np.float64),      # (t0_perf, t0_wall)
            ("incarnation", (1,), np.int64),
            ("name", (1,), "S32"),            # track name, e.g. b"fleet0"
            ("events", (capacity,), EVENT_DTYPE),
            ("crc32", (1,), np.uint32))


def _slot_crc(v: dict) -> int:
    """CRC over the publish header + clock + the WHOLE event region
    (unused slots are deterministic bytes, so covering them is free of
    used-length bookkeeping)."""
    return payload_crc32(
        (int(v["seq"][0]), int(v["count"][0]), int(v["incarnation"][0])),
        [v["clock"], v["events"].view(np.uint8)])


class TraceSlab:
    """Trainer-side owner of the shared-memory trace segment: the two
    control words plus ``num_slots`` writer slots."""

    def __init__(self, num_slots: int, capacity: int):
        self.num_slots = num_slots
        self.capacity = capacity
        self.ctrl_nbytes, self.ctrl_offsets = slot_layout(_CTRL_SPEC)
        self.spec = _slot_spec(capacity)
        self.slot_nbytes, self.offsets = slot_layout(self.spec)
        self.shm = shared_memory.SharedMemory(
            create=True,
            size=self.ctrl_nbytes + num_slots * self.slot_nbytes)
        self._ctrl = slot_views(self.shm.buf, _CTRL_SPEC,
                                self.ctrl_offsets, self.ctrl_nbytes, 0)
        self._closed = False

    # ------------------------------------------------------------- control
    def set_armed(self, armed: bool, capture_id: Optional[int] = None
                  ) -> None:
        if capture_id is not None:
            self._ctrl["capture_id"][0] = capture_id
        self._ctrl["armed"][0] = 1 if armed else 0

    def writer_info(self, slot: int, incarnation: int, name: str
                    ) -> Tuple[str, int, int, int, str]:
        """Picklable attach handle for a subprocess writer."""
        return (self.shm.name, slot, self.capacity, incarnation, name)

    # ------------------------------------------------------------- harvest
    def _slot_views(self, slot: int) -> dict:
        return slot_views(self.shm.buf[self.ctrl_nbytes:], self.spec,
                          self.offsets, self.slot_nbytes, slot)

    def harvest(self) -> Tuple[List[Dict[str, Any]], int]:
        """Read every published slot.  Returns ``(tracks, dropped)`` —
        a torn/garbled slot (CRC mismatch: writer SIGKILLed mid-publish
        or corrupted slab) is dropped and counted, never mis-merged;
        never-published slots (seq == 0) are skipped silently."""
        tracks: List[Dict[str, Any]] = []
        dropped = 0
        for s in range(self.num_slots):
            v = self._slot_views(s)
            seq = int(v["seq"][0])
            if seq <= 0:
                continue
            # raw-byte copy before the CRC check: a field-wise structured
            # copy would leave the dtype's alignment padding
            # uninitialised and the CRC could never match
            events = np.array(v["events"].view(np.uint8)).view(EVENT_DTYPE)
            snap = dict(seq=v["seq"].copy(), count=v["count"].copy(),
                        clock=v["clock"].copy(),
                        incarnation=v["incarnation"].copy(),
                        name=v["name"].copy(), events=events)
            if int(v["crc32"][0]) != _slot_crc(snap):
                dropped += 1
                continue
            count = int(snap["count"][0])
            used = min(count, self.capacity)
            # ring order: oldest surviving event first
            order = (np.arange(count - used, count) % self.capacity
                     if count > self.capacity else np.arange(used))
            tracks.append(dict(
                slot=s,
                name=snap["name"][0].decode("utf-8", "replace"),
                incarnation=int(snap["incarnation"][0]),
                t0_perf=float(snap["clock"][0]),
                t0_wall=float(snap["clock"][1]),
                overflow=max(0, count - self.capacity),
                events=events[order]))
        return tracks, dropped

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._ctrl = None
        try:
            self.shm.close()
        except BufferError:
            pass          # a late view holds the mapping; unlink frees it
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class EventTracer:
    """One process's event recorder (module docstring).

    Constructed local (private ring, disarmed) so the process-wide
    :data:`EVENTS` singleton is always safe to record against;
    :meth:`attach` re-backs the SAME object with a shm slab slot so
    every module-level reference picks up the run's slab without
    rebinding.
    """

    def __init__(self, capacity: int = 1024, name: str = "local"):
        self._lock = threading.Lock()
        self.armed = False
        self._capacity = int(capacity)
        self._events = np.zeros(self._capacity, EVENT_DTYPE)
        self._n = 0
        self._flushed = -1
        self._seq = 0
        self._capture_seen = -1
        self._trace_counter = 0
        self._slot = 0
        self._incarnation = 0
        self._name = name
        self._shm: Optional[shared_memory.SharedMemory] = None
        self._views: Optional[dict] = None
        self._ctrl: Optional[dict] = None
        self.t0_perf = time.perf_counter()
        self.t0_wall = time.time()

    # ------------------------------------------------------------ backing
    def attach(self, info: Tuple[str, int, int, int, str]) -> None:
        """Back this tracer with slab slot ``info`` (writer side of
        :meth:`TraceSlab.writer_info`); stamps the clock handshake."""
        shm_name, slot, capacity, incarnation, name = info
        self.detach()
        with self._lock:
            self._shm = shared_memory.SharedMemory(name=shm_name)
            spec = _slot_spec(capacity)
            slot_nbytes, offsets = slot_layout(spec)
            ctrl_nbytes, ctrl_offsets = slot_layout(_CTRL_SPEC)
            self._views = slot_views(self._shm.buf[ctrl_nbytes:], spec,
                                     offsets, slot_nbytes, slot)
            self._ctrl = slot_views(self._shm.buf, _CTRL_SPEC,
                                    ctrl_offsets, ctrl_nbytes, 0)
            self._capacity = int(capacity)
            self._events = self._views["events"]
            self._n = 0
            self._flushed = -1
            self._seq = 0
            self._capture_seen = -1
            self._slot = int(slot)
            self._incarnation = int(incarnation)
            self._name = name
            self.t0_perf = time.perf_counter()
            self.t0_wall = time.time()
            self._views["clock"][0] = self.t0_perf
            self._views["clock"][1] = self.t0_wall
            self._views["incarnation"][0] = self._incarnation
            self._views["name"][0] = name.encode("utf-8")[:32]
        self.poll()

    def detach(self) -> None:
        with self._lock:
            self.armed = False
            self._views = None
            self._ctrl = None
            self._events = np.zeros(0, EVENT_DTYPE)
            self._capacity = 0
            if self._shm is not None:
                try:
                    self._shm.close()
                except Exception:
                    pass
                self._shm = None

    # ------------------------------------------------------------ control
    def poll(self) -> None:
        """Refresh ``armed`` from the slab control words (called at the
        owning loop's publish cadence — never per event).  A bumped
        capture id resets the ring so each capture is self-contained."""
        ctrl = self._ctrl
        if ctrl is None:
            return
        try:
            capture = int(ctrl["capture_id"][0])
            armed = bool(ctrl["armed"][0])
        except (ValueError, TypeError):     # slab closed under us
            return
        with self._lock:
            if capture != self._capture_seen:
                self._capture_seen = capture
                self._n = 0
                self._flushed = -1
            self.armed = armed

    def arm_local(self, capture_id: int) -> None:
        """Direct arming for the in-process (trainer) tracer — the slab
        control words cover subprocess writers; the trainer's own ring
        arms synchronously so no events at the window edges are lost."""
        with self._lock:
            if capture_id != self._capture_seen:
                self._capture_seen = capture_id
                self._n = 0
                self._flushed = -1
            self.armed = True

    def disarm_local(self) -> None:
        self.armed = False

    # ------------------------------------------------------------- record
    def instant(self, name: str, flow: int = 0, fph: str = "",
                arg: int = 0) -> None:
        """One instant event ``now`` (armed fast path: a single attribute
        check when disarmed)."""
        if not self.armed:
            return
        self._record(name, b"i", time.perf_counter(), 0.0, flow, fph, arg)

    def complete(self, name: str, ts: float, dur: float, flow: int = 0,
                 fph: str = "", arg: int = 0) -> None:
        """One complete (``X``) event: ``ts`` is the span start from
        ``time.perf_counter()``, ``dur`` seconds."""
        if not self.armed:
            return
        self._record(name, b"X", ts, dur, flow, fph, arg)

    def _record(self, name, ph, ts, dur, flow, fph, arg) -> None:
        with self._lock:
            if not self.armed or self._capacity <= 0:
                return
            i = self._n % self._capacity
            ev = self._events[i]
            ev["name"] = name.encode("utf-8")[:48]
            ev["ph"] = ph
            ev["fph"] = fph.encode("ascii")[:1] if fph else b""
            ev["ts"] = ts
            ev["dur"] = dur
            ev["flow"] = flow
            ev["arg"] = arg
            self._n += 1

    def next_trace_id(self) -> int:
        """A fabric-unique flow id: slot- and incarnation-tagged so a
        respawned fleet's ids can never alias its dead predecessor's
        (the merger would otherwise stitch two different blocks' hops
        into one arrow chain)."""
        with self._lock:
            self._trace_counter += 1
            return (((self._slot + 1) & 0x7FFF) << 48
                    | (self._incarnation & 0xFFFF) << 32
                    | (self._trace_counter & ((1 << 32) - 1)))

    # -------------------------------------------------------------- flush
    def flush(self) -> None:
        """Publish the ring header (count, seq, CRC last) so the trainer
        can harvest a consistent snapshot.  Cheap no-op when nothing new
        was recorded; shm-backed writers call it at their loop's publish
        cadence."""
        if self._views is None:
            return
        with self._lock:
            if self._n == self._flushed:
                return
            v = self._views
            self._seq += 1
            v["seq"][0] = self._seq
            v["count"][0] = self._n
            v["crc32"][0] = _slot_crc(v)
            self._flushed = self._n

    def local_events(self) -> np.ndarray:
        """The used ring contents in order (oldest first) — the harvest
        path for a local (non-shm) tracer, e.g. unit tests."""
        with self._lock:
            used = min(self._n, self._capacity)
            if self._n > self._capacity:
                order = (np.arange(self._n - used, self._n)
                         % self._capacity)
                return np.array(self._events[order])
            return np.array(self._events[:used])


# the process-wide recorder every instrumented call site uses; train()
# attaches it to the run's slab (slot 0), subprocess workers attach to
# the slot their plane assigned — always safe to record against
EVENTS = EventTracer(capacity=0, name="detached")


# --------------------------------------------------------------------------
# merge: rings -> Chrome trace event JSON (Perfetto-loadable)
# --------------------------------------------------------------------------

def merge_tracks(tracks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge harvested rings into one Chrome-trace-event object.

    Per-track mapping to the shared wall clock is affine and increasing
    (``t0_wall + (ts - t0_perf)``), so each track's events stay monotone;
    timestamps are microseconds relative to the earliest event.  Each
    ring becomes a process track (``pid`` = slot, ``tid`` =
    incarnation) with ``process_name`` metadata; records carrying a
    flow id additionally emit the matching Chrome flow event
    (``s``/``t``/``f``) so block lineage renders as one arrow chain."""
    walls: List[float] = []
    for t in tracks:
        ev = t["events"]
        if len(ev):
            walls.append(t["t0_wall"]
                         + float(ev["ts"].min()) - t["t0_perf"])
    base = min(walls) if walls else 0.0
    out: List[Dict[str, Any]] = []
    for t in tracks:
        pid, tid = int(t["slot"]), int(t["incarnation"])
        out.append(dict(ph="M", name="process_name", pid=pid, tid=tid,
                        args=dict(name=t["name"])))
        out.append(dict(ph="M", name="thread_name", pid=pid, tid=tid,
                        args=dict(name=f"inc{tid}")))
        offset = t["t0_wall"] - t["t0_perf"] - base
        for ev in t["events"]:
            ts_us = (float(ev["ts"]) + offset) * 1e6
            name = ev["name"].decode("utf-8", "replace")
            ph = ev["ph"].decode("ascii", "replace") or "i"
            rec: Dict[str, Any] = dict(name=name, cat="r2d2", ph=ph,
                                       ts=ts_us, pid=pid, tid=tid)
            if ph == "X":
                rec["dur"] = float(ev["dur"]) * 1e6
            if ph == "i":
                rec["s"] = "t"
            args = {}
            if int(ev["flow"]):
                args["trace_id"] = int(ev["flow"])
            if int(ev["arg"]):
                args["arg"] = int(ev["arg"])
            if args:
                rec["args"] = args
            out.append(rec)
            fph = ev["fph"].decode("ascii", "replace")
            if fph in ("s", "t", "f") and int(ev["flow"]):
                flow: Dict[str, Any] = dict(
                    name="block", cat="block", ph=fph,
                    id=int(ev["flow"]), pid=pid, tid=tid,
                    # just inside the slice so the arrow binds to it
                    ts=ts_us + min(1.0, float(ev["dur"]) * 1e6 / 2))
                if fph == "f":
                    flow["bp"] = "e"
                out.append(flow)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# --------------------------------------------------------------------------
# capture controllers (the /tracez and /profilez machinery)
# --------------------------------------------------------------------------

class TraceController:
    """Arms bounded fabric-wide capture windows and dumps the merged
    trace (``/tracez`` and ``--trace-steps``).

    ``step_fn`` reads the run's train-step counter; a capture armed for
    N steps disarms once the counter advances by N (or after a
    wall-clock backstop, so a stalled learner cannot pin a window open
    forever).  :meth:`poll` drives the state machine from a supervised
    fabric loop."""

    GRACE_SECONDS = 0.6       # post-disarm window for writers to notice
                              # the control word and flush their final CRC
    # a subprocess writer polls the control word once a burst of its loop
    # (a fleet: 256 actor steps), which on a loaded host outlasts the
    # grace and the reference's four re-reads 0.3 s apart; a slot still
    # torn is re-read until it settles, for at most this long
    # (ROADMAP.md C 18)
    SETTLE_SECONDS = 10.0
    MAX_CAPTURE_SECONDS = 120.0

    def __init__(self, slab: TraceSlab, step_fn: Callable[[], int],
                 out_dir: str, tracer: Optional[EventTracer] = None):
        self.slab = slab
        self.step_fn = step_fn
        self.out_dir = out_dir
        self.tracer = tracer if tracer is not None else EVENTS
        self._lock = threading.Lock()
        self._capture_id = 0
        self._armed = False
        self._closing = False     # a window past its target, mid-harvest
        self._target_step = 0
        self._deadline = 0.0
        # dumps number on from whatever already exists in out_dir: a
        # resumed run reusing the checkpoint dir must not overwrite
        # earlier captures, nor may a check read a stale trace_1.json
        self._dump_n = 0
        try:
            for f in os.listdir(out_dir):
                if f.startswith("trace_") and f.endswith(".json"):
                    try:
                        self._dump_n = max(self._dump_n,
                                           int(f[len("trace_"):-5]))
                    except ValueError:
                        pass
        except OSError:
            pass
        self.last: Dict[str, Any] = {}

    def arm(self, steps: int) -> Dict[str, Any]:
        """Open a capture window of ``steps`` train steps.  Returns the
        armed status, or an error dict when a window is already open —
        including one in its close/harvest phase: arming there would
        bump the capture id and make every writer reset its ring while
        the previous capture is still being read out."""
        steps = max(1, int(steps))
        with self._lock:
            if self._armed or self._closing:
                return dict(error="capture already in progress",
                            capture_id=self._capture_id)
            self._capture_id += 1
            self._armed = True
            self._target_step = self.step_fn() + steps
            self._deadline = time.monotonic() + self.MAX_CAPTURE_SECONDS
            self.slab.set_armed(True, capture_id=self._capture_id)
            self.tracer.arm_local(self._capture_id)
            return dict(armed=True, steps=steps,
                        capture_id=self._capture_id)

    def poll(self, force: bool = False) -> Optional[str]:
        """Close the window once the step target (or the wall-clock
        backstop) is reached: disarm fabric-wide, give writers a flush
        grace, harvest, merge, dump.  Returns the dump path when a
        capture completed this poll.  ``force`` closes an open window
        regardless of progress — the shutdown path, so a capture armed
        near the end of a short run still dumps."""
        with self._lock:
            if not self._armed:
                return None
            if (not force and self.step_fn() < self._target_step
                    and time.monotonic() < self._deadline):
                return None
            self._armed = False
            self._closing = True   # arm() refuses until the harvest
            capture_id = self._capture_id       # below has read the slab
        self.slab.set_armed(False)
        self.tracer.disarm_local()
        self.tracer.flush()
        time.sleep(self.GRACE_SECONDS)
        try:
            # a CRC failure here is usually a LIVE writer mid-flush (it
            # has not polled the disarm word yet), not corruption —
            # re-read until the slab settles; only a slot that stays
            # torn is dropped
            settle = time.monotonic() + self.SETTLE_SECONDS
            while True:
                tracks, dropped = self.slab.harvest()
                if dropped == 0 or time.monotonic() >= settle:
                    break
                time.sleep(0.3)
            trace = merge_tracks(tracks)
            os.makedirs(self.out_dir, exist_ok=True)
            self._dump_n += 1
            path = os.path.join(self.out_dir,
                                f"trace_{self._dump_n}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(trace, f)
            os.replace(tmp, path)  # a reader never sees a torn dump
            self.last = dict(
                path=path, capture_id=capture_id,
                events=sum(len(t["events"]) for t in tracks),
                tracks=len(tracks), dropped_slabs=dropped,
                overflow=sum(t["overflow"] for t in tracks))
        finally:
            with self._lock:
                self._closing = False
        return path

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return dict(armed=self._armed or self._closing,
                        capture_id=self._capture_id,
                        target_step=self._target_step, last=dict(self.last))

    def close(self) -> None:
        self.slab.close()


class ProfileController:
    """On-demand ``torch.profiler`` capture (``/profilez``): a Chrome trace
    of the CPU ops and, on a CUDA device, the card's kernels and copies,
    of every thread of this process for ``seconds``.  The capture loop's
    :meth:`poll` runs the bounded window synchronously (profiles are
    short and rare; the trace poll pauses for the duration).

    ``device`` is the learner's device.  On a CUDA device a profile that
    cannot record the card's activity is an error, never a CPU-only trace
    in silence: :meth:`poll` records the error in :attr:`last` and
    raises.  A caller that trains on the CPU gets a CPU profile."""

    MAX_SECONDS = 60.0

    def __init__(self, out_dir: str, device: Any = "cuda"):
        self.out_dir = out_dir
        self.cuda = str(device).startswith("cuda")
        self._lock = threading.Lock()
        self._want: Optional[float] = None
        self._n = 0
        self.last: Dict[str, Any] = {}

    def arm(self, seconds: float) -> Dict[str, Any]:
        seconds = min(max(0.1, float(seconds)), self.MAX_SECONDS)
        with self._lock:
            if self._want is not None:
                return dict(error="profile already in progress")
            self._want = seconds
            return dict(armed=True, seconds=seconds)

    def _record(self, seconds: float, path: str) -> Dict[str, Any]:
        import torch

        from r2d2_tpu_torch.utils.trace import device_profile

        with device_profile(path, require_cuda=self.cuda) as prof:
            time.sleep(seconds)
        device_events = sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        if self.cuda and device_events == 0:
            raise RuntimeError(
                f"/profilez: the {seconds:.1f} s profile recorded no CUDA "
                "activity")
        return dict(path=os.path.join(path, "trace.json"), seconds=seconds,
                    device_events=device_events)

    def poll(self) -> Optional[str]:
        with self._lock:
            seconds = self._want
            if seconds is None:
                return None
            self._n += 1
            n = self._n
        path = os.path.join(self.out_dir, f"profile_{n}")
        try:
            self.last = self._record(seconds, path)
        except Exception as e:
            self.last = dict(error=str(e))
            raise
        finally:
            with self._lock:
                self._want = None
        return self.last["path"]

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return dict(armed=self._want is not None, last=dict(self.last))
