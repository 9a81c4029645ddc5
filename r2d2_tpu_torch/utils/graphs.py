"""CUDA-graph captures: the port's counterpart of a compiled program.

JAX compiles each entry point into one program per input signature and
dispatches it in microseconds; the port issues the same work from Python,
op by op, and on a card the host's issue is the time (PERF.md §5).  A
captured CUDA graph is the counterpart: the entry's kernels recorded once
against tensors at fixed addresses, then replayed with one launch.
:class:`Graphs` holds the graphs of one entry-point instance and counts
each capture as one trace of it in the retrace guard (utils/trace.py).
Off a card (and under :func:`eager`, the twin a check holds a replay
to) it runs the entry eagerly, and a trace is the first call with a new
key, what ``jax.jit`` retraces on.  Its users: the learner's steps, meshless and meshed, and
both anakin entries, meshless and meshed (learner/graphs.py), and the
acts (actor.py:make_act_fn, which the thread fleets, the evaluator, the
session batcher and the inference service act through).  A meshed
entry's graph holds its NCCL collectives; its state is DTensors, keyed
by the addresses of their local shards (:func:`address`).

A capture first runs ``warm`` once on copies of the inputs on a side
stream (the library handles, cuDNN's algorithm choices, the kernels'
builds and shared-memory settings), or, for an entry whose state is too
large to copy (``eager_first``: anakin's ring), runs the call itself
eagerly there as its warm-up; then it records ``record`` on that stream
in ``thread_local`` mode, so other threads keep launching their kernels
and copies meanwhile; both run under ``TRANSFER_GUARD.allow()``.
A replay copies the inputs into the graph's own input tensors and runs on
the caller's stream; it returns the graph's own output tensors, which the
graph's next replay overwrites.  Every tensor a graph reads beside its
inputs must stay at its address for the graph's lifetime.  All graphs of
one instance share one memory pool, and their outputs stay allocated, so
they may replay in any order on one stream.

The hand-written kernels count their launches where their wrappers launch
them (``KERNEL_LAUNCHES``, ops/lstm.py), and a replay runs no wrapper.
So the warm-up and the capture count nothing: the capture records how
many launches of each counter its graph holds, and each replay adds
those.  A path's exact "launches = layers × acts" checks hold as they did
when every act ran eagerly.  The host counters of the collectives a
graph issues (``CROSS_RANK_CALLS``, ``COLLECTIVE_CALLS``, ticked through
:func:`tick`) are kept the same way, per thread: the warm-up on copies
and the capture add nothing, the capture records what its own thread
ticked, and each replay adds it, so a run's exact per-step collective
counts hold while other threads tick the same counters.  A
collective that syncs with the host (an agreement that reads its result
back, a broadcast's first layout exchange) runs at the warm-up or
outside every graph, never inside a capture.

Captures are serialised in the process, and no automatic garbage
collection runs during one (``_no_gc``): a graph that went out of use,
destroyed by a collection on the capturing thread, invalidated a
learner capture on the card.  A capture and a replay enter
``utils/trace.PROFILER_LOCK`` shared, and ``device_profile`` enters it
exclusive to start and stop ``torch.profiler``: on the card a profiler
stopped on one thread while another launched a graph hung both.  So a
graph waits only on a profiler's start or stop, never on another
entry's launch or capture (an IMPALA-deep update's launch takes ≈16 ms,
its capture ≈1 s).  A capture that fails raises: nothing runs the entry
eagerly on a card in its place.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import threading
from typing import (Any, Callable, Dict, Hashable, Iterator, Optional,
                    Sequence, Tuple)

import torch
from torch.distributed.tensor import DTensor

from r2d2_tpu_torch.utils.trace import (
    KERNEL_LAUNCHES,
    PROFILER_LOCK,
    TRANSFER_GUARD,
)

# record(inputs) -> the entry's output tensors
Record = Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]

# one capture at a time in the process: ``torch.cuda.graph`` opens with a
# device-wide synchronize and frees the allocator's cached blocks, which
# must not fall inside another thread's capture
_CAPTURE_LOCK = threading.Lock()

_LOCAL = threading.local()


def tick(counter: collections.Counter, key: str, n: int = 1) -> None:
    """``counter[key] += n`` (a module's count of the collectives it
    issues), or, inside this thread's capture or warm-up, into the
    capture's record: each replay of its graph adds the record."""
    rec = getattr(_LOCAL, "counts", None)
    if rec is None:
        counter[key] += n
    else:
        rec.setdefault(id(counter), (counter, collections.Counter()))[1][
            key] += n


def address(t: torch.Tensor) -> int:
    """Where ``t``'s data lives: a DTensor (a wrapper with no storage of
    its own) at its local shard's."""
    return (t.to_local() if isinstance(t, DTensor) else t).data_ptr()


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Every entry this thread calls inside runs op by op, also on a card:
    the eager twin that a replay is held to in a check."""
    prev = getattr(_LOCAL, "eager", False)
    _LOCAL.eager = True
    try:
        yield
    finally:
        _LOCAL.eager = prev


@contextlib.contextmanager
def _recorded_ticks() -> Iterator[Dict[int, tuple]]:
    """This thread's :func:`tick` calls inside go to the yielded record,
    ``{id(counter): (counter, Counter)}``, and not to the counters."""
    prev = getattr(_LOCAL, "counts", None)
    rec = _LOCAL.counts = {}
    try:
        yield rec
    finally:
        _LOCAL.counts = prev


@contextlib.contextmanager
def _no_gc() -> Iterator[None]:
    """No automatic garbage collection while a graph is captured: a
    collection on the capturing thread may destroy another graph that
    went out of use (an act of an earlier run), and destroying a graph
    during a capture invalidates the capture.  ``torch.cuda.graph``
    collects once itself before the capture begins."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@dataclasses.dataclass
class _Graph:
    graph: Any
    inputs: Dict[str, torch.Tensor]
    outputs: Tuple[torch.Tensor, ...]
    launches: Dict[str, int]
    counts: Dict[int, tuple]


class Graphs:
    """The programs of one entry-point instance, keyed by the caller: on a
    card one CUDA graph per key, elsewhere (or under :func:`eager`) the
    eager call.  ``entry`` is its retrace-guard entry
    (``RetraceGuard.register``): each capture, or each eager call with a
    new key, adds one to ``entry.traces``."""

    def __init__(self, entry):
        self.entry = entry
        self._graphs: Dict[Hashable, _Graph] = {}
        self._eager: set = set()
        self._pool = None
        self._stream = None

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, record: Record,
            inputs: Dict[str, torch.Tensor], device: torch.device,
            warm: Optional[Callable[[Dict[str, torch.Tensor]], Any]] = None,
            reads: Sequence[torch.Tensor] = (), branch: Hashable = None,
            eager_first: bool = False) -> Tuple[torch.Tensor, ...]:
        """``record(inputs)``'s outputs.  On a CUDA ``device``, from a replay of the graph of ``key``, ``branch``
        and the addresses of ``reads`` (the tensors the graph reads
        beside its inputs), captured at its first call after ``warm``
        (default ``record``) on copies of the inputs; the returned tensors
        are the graph's own, which the next replay of this instance
        overwrites.  With ``eager_first`` the warm-up is that first call
        itself: ``record`` runs once eagerly on the real tensors, its
        outputs are the call's, and the capture follows it (for an entry
        whose state is too large to copy, anakin's ring).  Otherwise
        ``record`` runs eagerly, and a new ``key`` is a trace: a
        ``branch`` (what JAX's ``lax.cond`` selects inside one program)
        is a graph of its own on the card and no new trace eagerly."""
        if device.type != "cuda" or getattr(_LOCAL, "eager", False):
            if key not in self._eager:
                self._eager.add(key)
                self.entry.traces += 1
            return tuple(record(inputs))
        key = (key, branch, tuple(address(t) for t in reads))
        g = self._graphs.get(key)
        if g is None:
            g, first = self._capture(record, inputs, warm or record,
                                     eager_first)
            self._graphs[key] = g
            if eager_first:
                return first
        for k, v in inputs.items():
            g.inputs[k].copy_(v)
        with PROFILER_LOCK.shared():
            g.graph.replay()
        for name, n in g.launches.items():
            KERNEL_LAUNCHES.count(name, n)
        for counter, delta in g.counts.values():
            counter.update(delta)
        return g.outputs

    def _capture(self, record: Record, inputs: Dict[str, torch.Tensor],
                 warm, eager_first: bool = False) -> Tuple[_Graph, Any]:
        first = None
        with TRANSFER_GUARD.allow():
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            side = self._stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                if eager_first:
                    first = tuple(record(inputs))
                else:
                    with KERNEL_LAUNCHES.recording(), _recorded_ticks():
                        warm({k: v.clone() for k, v in inputs.items()})
            torch.cuda.current_stream().wait_stream(side)
            static = {k: torch.empty_like(v) for k, v in inputs.items()}
            graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK, _no_gc(), KERNEL_LAUNCHES.recording() as \
                    launches, _recorded_ticks() as counts, \
                    PROFILER_LOCK.shared(), torch.cuda.graph(
                        graph, pool=self._pool, stream=side,
                        capture_error_mode="thread_local"):
                outputs = tuple(record(static))
            if self._pool is None:
                self._pool = graph.pool()
            self.entry.traces += 1
        return _Graph(graph, static, outputs, launches, counts), first
