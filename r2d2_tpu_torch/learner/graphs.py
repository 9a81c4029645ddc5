"""CUDA-graph captures of the learner's steps (ROADMAP.md A item 10) and
of the anakin entries (ROADMAP.md A's second host-bound cut, and its
third for the meshed plane).

JAX compiles each learner entry point into one program and dispatches it
in microseconds; the port issues the same step from Python, op by op, and
on a card the host's issue is the time (PERF.md §5).  The counterpart of
JAX's compiled program is a captured CUDA graph: the step's kernels
recorded once against tensors at fixed addresses, then replayed with one
launch.  :class:`StepGraphs` holds the graphs of one entry point and
counts each capture as one trace of it in the retrace guard
(utils/trace.py): ``learner.train_step`` (:func:`make_learner_step`,
and on the mesh ``parallel/sharding.py:mesh_train_step``),
``learner.super_step`` and ``learner.in_graph_per_super_step``
(learner/step.py), meshless and meshed alike.

A graph runs one train step (with the super-steps' gather, or their
sample, gather and priority scatter) and reads:

- the train state, written in place: params, target params, Adam's
  moments and the two device counters (learner/step.py);
- ``fixed`` tensors it only reads (the replay ring, the PER metadata) and
  ``scratch`` tensors it writes in place (the PER leaves);
- ``inputs``, copied into the graph's own input tensors before each
  replay (a staged batch, a super-step's index row and weights, a row of
  uniforms).

Every tensor of the first three must stay at its address for the graph's
lifetime: a graph is keyed by those addresses, so a state or ring that
moved is captured anew and counted, and the guard's budget catches it.
The learnhealth arming is a host decision (the step's host mirror knows
each step's number): an armed and a disarmed step are two graphs of the
entry, within its budget of 2, so the diagnostic rows come out as JAX's
``lax.cond`` gives them.

A capture (utils/graphs.py, shared with the acts) warms the step up once
on copies of the state and scratch (the step writes them in place; the
warm-up makes the library handles and workspaces of the side stream),
then records it on that side stream in ``thread_local`` mode, so the
acting threads keep launching their kernels and copies meanwhile; both
run under ``TRANSFER_GUARD.allow()``, as JAX arms its guard after the
first compile.  A replay runs on the caller's stream and returns copies
of the graph's outputs, which the next replay overwrites.  A capture and
a launch enter ``utils/trace.PROFILER_LOCK`` shared.  A capture that fails
raises: nothing runs the step eagerly on a card in its place.  Off a card
the step runs eagerly, and a trace is the first call with a new input
signature, what ``jax.jit`` retraces on.

On the mesh the state is DTensors, written in place through their local
shards (the addresses a graph is keyed by, ``utils/graphs.address``), and
the graph holds the step's collectives: the gradient and loss reductions
DTensor inserts, and in the meshed in-graph super-step the cross-rank
draw's gathers and row exchanges, the feedback's gather and the dp
group's broadcast (parallel/cross_rank.py).  The warm-up runs each of
them once before the capture, so that NCCL makes every communicator and
``group_broadcast`` agrees its layout (a host read) outside the capture;
the host agreements (the gate, the min densities) stay outside every
graph.

The anakin plane's two entries, ``learner.anakin_rollout`` and
``learner.anakin_super_step`` (:func:`graphed_rollout`,
:func:`graphed_super_step`), replay one graph of a whole dispatch: its
k·E actor steps with their block emits, and for the super-step the k
samples, gathers, train steps and priority scatters, and the eval lane
on its cadence.  Their graphs read the carry, the train state, the ring,
the leaves, ``seq_meta`` and ``first`` where they are; the dispatch index
is their one input.  On the mesh a graph also holds the routed emit's
gathers and block exchanges, the lane counters' sum and the cross-rank
draw, all of shapes fixed by the configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from r2d2_tpu_torch.utils.graphs import Graphs
from r2d2_tpu_torch.utils.trace import RETRACES, signature

# body(state, fixed, scratch, inputs) -> the step's output tensors
Body = Callable[[Any, Any, Sequence[Any], Dict[str, torch.Tensor]],
                Tuple[torch.Tensor, ...]]


def _state_tensors(state) -> list:
    opt = state.opt_state
    return ([state.step_t, opt.count_t] + list(state.params.values())
            + list(state.target_params.values()) + list(opt.mu.values())
            + list(opt.nu.values()))


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _clone_state(state):
    """A state of copies of ``state``'s tensors (the warm-up's)."""
    def c(d):
        return {k: v.clone() for k, v in d.items()}

    opt = state.opt_state
    return dataclasses.replace(
        state, params=c(state.params), target_params=c(state.target_params),
        step_t=state.step_t.clone(),
        opt_state=dataclasses.replace(opt, mu=c(opt.mu), nu=c(opt.nu),
                                      count_t=opt.count_t.clone()))


def _mirror_copy(state):
    """``state``'s tensors under host mirrors of their own: the step a
    capture records advances these, not the caller's."""
    return dataclasses.replace(
        state, opt_state=dataclasses.replace(state.opt_state))


class StepGraphs:
    """The programs of one learner entry point: CUDA graphs of one train
    step on a card (``cuda_graphs``), keyed by the learnhealth arming and
    the addresses and shapes of what they read; the eager step elsewhere.
    ``guard`` (default :data:`RETRACES`) counts each capture, or each new
    eager signature, under ``name``."""

    def __init__(self, name: str, guard=None):
        self.entry = (guard or RETRACES).register(name)
        self.cuda_graphs = Graphs(self.entry)

    @property
    def captures(self) -> int:
        return self.cuda_graphs.captures

    def run(self, body: Body, state, fixed=(), scratch: Sequence = (),
            inputs: Optional[Dict[str, torch.Tensor]] = None,
            armed: bool = False) -> Tuple[torch.Tensor, ...]:
        """One step: ``body(state, fixed, scratch, inputs)``'s outputs,
        from a replay of its graph on a card, else from the eager call.
        Either way the step's host mirrors advance by one."""
        from r2d2_tpu_torch.learner.step import place_counters

        inputs = inputs or {}
        device = next(iter(state.params.values())).device
        place_counters(state, device)

        def warm(x):
            body(_clone_state(state), fixed,
                 [None if t is None else t.clone() for t in scratch], x)

        outputs = self.cuda_graphs.run(
            (armed, signature((state, fixed, scratch, inputs))),
            lambda x: body(_mirror_copy(state), fixed, scratch, x),
            inputs, device, warm,
            reads=_state_tensors(state) + _leaves(fixed) + _leaves(scratch))
        state.step += 1
        state.opt_state.count += 1
        return tuple(o.clone() for o in outputs)


def make_learner_step(cfg, net, learnhealth: bool = False, guard=None):
    """The learner's train step, ``learner.train_step``: the plain step
    (:func:`~r2d2_tpu_torch.learner.step.make_train_step`, same signature
    and results) replayed as a CUDA graph on a card, with the staged batch
    copied into the graph's inputs; eager elsewhere.  ``graphs`` is its
    :class:`StepGraphs`."""
    from r2d2_tpu_torch.learner.step import make_train_step

    step = make_train_step(cfg, net, learnhealth=learnhealth)
    interval = (cfg.learnhealth_interval
                if learnhealth and cfg.learnhealth_interval > 0 else 0)
    graphs = StepGraphs("learner.train_step", guard=guard)

    def body(state, fixed, scratch, batch):
        return step(state, batch)[1:]

    def train_step(state, batch):
        armed = interval > 0 and (state.step + 1) % interval == 0
        return (state,) + graphs.run(body, state, inputs=batch, armed=armed)

    train_step.graphs = graphs
    return train_step


# --------------------------------------------------------------------------
# the anakin entries (learner/anakin.py)
# --------------------------------------------------------------------------

def _settle(ast: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
            ) -> None:
    """The carry a dispatch returned, copied into ``ast``'s own tensors:
    the carry keeps its addresses, which a graph reads."""
    if new.keys() != ast.keys():
        raise ValueError(f"the anakin carry changed its keys: "
                         f"{sorted(set(new) ^ set(ast))}")
    for k, v in new.items():
        if v is not ast[k]:
            ast[k].copy_(v)


def _anakin_reads(ast, arrays, prios, seq_meta, first) -> list:
    return (list(ast.values()) + list(arrays.values())
            + [prios, seq_meta, first])


def graphed_super_step(cfg, body):
    """``learner.anakin_super_step`` of a plane, meshless or meshed: ``body``
    (:func:`~r2d2_tpu_torch.learner.anakin.make_anakin_super_step`), one
    whole dispatch replayed as a CUDA graph on a card, eager elsewhere.
    Signature::

        super_step(train_state, ast, arrays, prios, seq_meta, first,
                   dispatch_idx: int)
          -> (train_state, ast, arrays, prios, seq_meta, first, flat)

    The carry ``ast``, the train state, the ring arrays, the PER leaves,
    ``seq_meta`` and ``first`` are written in place and returned (the
    carry a dispatch computes is copied back into ``ast``'s tensors), so
    every address the graph reads stays put; ``flat`` is a copy of the
    graph's result vector.  The dispatch index is the graph's one input,
    a 0-d int64 tensor filled on the device (no host copy), from which
    the PER uniforms and the eval episodes' root derive
    (envs/anakin.py:derive); the python index picks the eval cadence.

    A graph is keyed by the eval cadence and by which of the k inner
    steps the learnhealth diagnostic arms (both host decisions, JAX's
    ``lax.cond`` inside its one program), and by the addresses it reads:
    with the eval lane on, two graphs, and as many again for each arming
    pattern (one when the interval divides k).  Each capture is a trace
    of the entry.  The first dispatch of a key runs eagerly as the
    capture's warm-up (its outputs are the dispatch's) and the capture
    follows it, so the ring is never copied.  The host mirrors of the
    step advance by k a dispatch, as the eager steps advance them."""
    from r2d2_tpu_torch.learner.step import place_counters
    from r2d2_tpu_torch.telemetry.learnhealth import diag_enabled

    graphs = Graphs(RETRACES.register("learner.anakin_super_step"))
    k, interval = cfg.superstep_k, cfg.anakin_eval_interval
    lh = cfg.learnhealth_interval if diag_enabled(cfg) else 0

    def super_step(train_state, ast, arrays, prios, seq_meta, first,
                   dispatch_idx: int):
        device = prios.device
        place_counters(train_state, device)
        armed = tuple(lh > 0 and (train_state.step + j + 1) % lh == 0
                      for j in range(k))
        branch = (interval > 0 and dispatch_idx % interval == 0, armed)

        def record(x):
            out = body(_mirror_copy(train_state), ast, arrays, prios,
                       seq_meta, first, dispatch_idx, index=x["index"])
            _settle(ast, out[1])
            return out[-1:]

        (flat,) = graphs.run(
            signature((train_state, ast, arrays, prios, seq_meta, first)),
            record, {"index": torch.full((), dispatch_idx,
                                         dtype=torch.int64, device=device)},
            device, reads=_state_tensors(train_state)
            + _anakin_reads(ast, arrays, prios, seq_meta, first),
            branch=branch, eager_first=True)
        train_state.step += k
        train_state.opt_state.count += k
        return (train_state, ast, arrays, prios, seq_meta, first,
                flat.clone())

    super_step.graphs = graphs
    return super_step


def graphed_rollout(body):
    """``learner.anakin_rollout`` of a plane, meshless or meshed: ``body``
    (:func:`~r2d2_tpu_torch.learner.anakin.make_anakin_rollout`) replayed
    as one CUDA graph on a card, eager elsewhere; the carry, the ring and
    the PER state written in place as :func:`graphed_super_step` writes
    them, the stats vector a copy.  Its graph is keyed by the addresses it
    reads (the params among them); the first rollout runs eagerly as the
    capture's warm-up."""
    graphs = Graphs(RETRACES.register("learner.anakin_rollout"))

    def rollout(params, ast, arrays, prios, seq_meta, first):
        def record(x):
            out = body(params, ast, arrays, prios, seq_meta, first)
            _settle(ast, out[0])
            return out[-1:]

        (stats,) = graphs.run(
            signature((params, ast, arrays, prios, seq_meta, first)),
            record, {}, prios.device,
            reads=list(params.values())
            + _anakin_reads(ast, arrays, prios, seq_meta, first),
            eager_first=True)
        return ast, arrays, prios, seq_meta, first, stats.clone()

    rollout.graphs = graphs
    return rollout
