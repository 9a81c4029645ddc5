"""Declarative per-parameter sharding for the meshed learner.

Port of ``r2d2_tpu/parallel/sharding.py``.  The table maps **param-path
patterns** to per-dim mesh axes over the 3-axis ``dp × fsdp × tp`` mesh
(:mod:`r2d2_tpu_torch.parallel.mesh`); each resolved entry becomes one
DTensor placement per mesh axis (``Shard(dim)`` on the axis a tensor dim
names, ``Replicate()`` elsewhere).

It is keyed on the port's own parameter paths and torch's layouts, not
flax's:

- ``nn.Linear.weight`` is ``(out, in)`` where flax's ``Dense.kernel`` is
  ``(in, out)``, so JAX's ``("fsdp", "tp")`` on a dense kernel is tp on
  dim 0 and fsdp on dim 1 here;
- conv weights are ``(out, in, kh, kw)`` where flax's are
  ``(kh, kw, in, out)``, so JAX's fsdp on the output channels is dim 0;
- ``lstm_layers.*.wi`` / ``wh`` keep flax's ``(in, 4H)``.

Patterns match the *trailing* tokens of a leaf's path, so ``params``,
``target_params`` and Adam's ``mu``/``nu`` resolve through one entry
(moments share their param's layout, or every update would reshard);
integer layer indices are wildcarded (``lstm_layers.0`` →
``lstm_layers.*``); the longest pattern wins; a per-dim divisibility guard
replicates a dim its axis does not divide; scalars replicate; and a leaf
no pattern matches is an error, so a new model family extends the table
instead of silently replicating.  ``cfg.sharding_table`` overrides
entries through the same grammar as the JAX package (``parse_table``).

Resolving a spec needs only the axis sizes (``ShardingTable(sizes=...)``),
so the table is testable with no process group; :meth:`place_state`
(``distribute_tensor`` per leaf) needs a live mesh.

The step builders :func:`mesh_train_step` and :func:`mesh_super_step` are
the counterparts of JAX's ``pjit_train_step`` and ``pjit_super_step``: the
same train step (learner/step.py) run on a DTensor ``TrainState`` whose
batch is sharded over dp.  DTensor inserts the reductions XLA inserts
there — the gradient sums over dp, the gathers over fsdp and tp, the
global-norm sum over every shard.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import implicit_replication

from r2d2_tpu_torch.config import MESH_AXES, normalize_token, parse_table

# device-batch fields (the rest of a sampled batch is host bookkeeping);
# learner/learner.py and replay/device_ring.gather_batch use exactly these
DEVICE_BATCH_KEYS = (
    "obs", "last_action", "last_reward", "hidden", "action",
    "n_step_reward", "n_step_gamma", "burn_in", "learning", "forward",
    "is_weights",
)
# device-ring data arrays and in-graph PER leaves (replay/device_ring.py)
RING_DATA_KEYS = ("obs", "last_action", "last_reward", "action",
                  "n_step_reward", "n_step_gamma", "hidden")
PER_KEYS = ("prios", "seq_meta", "first")

Spec = Tuple[Optional[str], ...]


class UnresolvedShardingError(ValueError):
    """A state leaf matched no sharding-table pattern (silent replication
    would hide a missing entry until a new model family runs out of memory
    on a large mesh)."""


# pattern → per-dim axis names (None = replicated dim; missing trailing
# dims replicate).  Keys are dot-joined normalized path suffixes, "*"
# matching any one token.
DEFAULT_TABLE: Dict[str, Spec] = {
    # conv torsos: dp shards the batch-dominated compute; fsdp takes the
    # output-channel dim (dim 0 of (out, in, kh, kw)) purely for memory
    **{f"torso.conv{i}.weight": ("fsdp",) for i in (1, 2, 3)},
    **{f"torso.conv{i}.bias": () for i in (1, 2, 3)},
    "torso.convs.*.weight": ("fsdp",),
    "torso.convs.*.bias": (),
    # torso FC (out, in): tp on the output dim, fsdp on the large input
    "torso.dense.weight": ("tp", "fsdp"),
    "torso.dense.bias": ("tp",),
    # LSTM (in, 4H): the gate columns split over tp, fsdp on the input dim
    "lstm_layers.*.wi": ("fsdp", "tp"),
    "lstm_layers.*.wh": ("fsdp", "tp"),
    "lstm_layers.*.b": ("tp",),
    # dueling head (out, in) like the torso FC; the tiny output dims
    # (action_dim, 1) replicate wherever tp does not divide them
    "head.*.weight": ("tp", "fsdp"),
    "head.*.bias": ("tp",),
    # device-replay plane: ring slots and PER leaves shard over dp under
    # the "dp" ring layout (each rank holds its slab)
    "ring.*": ("dp",),
    "per.*": ("dp",),
    # anakin fused loop (learner/anakin.py): the per-lane carry — env
    # state and streams, agent obs and LSTM carry, local stream buffers —
    # splits its lane axis over dp (each rank steps its lanes)
    "anakin.lane.*": ("dp",),
}


def normalize_path(tokens: Sequence[str]) -> Tuple[str, ...]:
    return tuple(normalize_token(t) for t in tokens)


def leaf_tokens(*parts: str) -> Tuple[str, ...]:
    """Path tokens of a state leaf: ``leaf_tokens("opt_state", "mu",
    "lstm_layers.0.wi")`` → ``("opt_state", "mu", "lstm_layers", "0",
    "wi")``."""
    return tuple(t for p in parts for t in p.split("."))


class ShardingTable:
    """The resolved sharding rules over one mesh (or over axis ``sizes``
    alone, for resolution without a process group).  One instance per
    trainer bring-up (``train._build``) serves the meshed step, the
    learner's batch staging, the ring layout and checkpoint re-placement.
    """

    def __init__(self, mesh: Any = None, cfg: Any = None,
                 rules: Optional[Dict[str, Spec]] = None,
                 sizes: Optional[Dict[str, int]] = None):
        if isinstance(cfg, dict):
            raise TypeError("ShardingTable's second positional arg is cfg; "
                            "pass extra pattern rules via rules=")
        self.mesh = mesh
        if mesh is not None:
            from r2d2_tpu_torch.parallel.mesh import axis_sizes

            sizes = axis_sizes(mesh)
        self.sizes = {a: int((sizes or {}).get(a, 1)) for a in MESH_AXES}
        self.rules = dict(DEFAULT_TABLE)
        if rules:
            self.rules.update(rules)
        if cfg is not None and getattr(cfg, "sharding_table", ""):
            self.rules.update(parse_table(cfg.sharding_table))
        # longest pattern first; at equal length fewer "*" first (a fully
        # specified override beats a wildcard default); then lexicographic
        self._patterns = sorted(
            ((tuple(p.split(".")), spec) for p, spec in self.rules.items()),
            key=lambda kv: (-len(kv[0]), sum(t == "*" for t in kv[0]),
                            kv[0]))

    # ------------------------------------------------------------ resolve
    def lookup(self, tokens: Sequence[str]) -> Optional[Spec]:
        """The first (longest) pattern matching the normalized path's
        trailing tokens, or None."""
        norm = normalize_path(tokens)
        for pat, spec in self._patterns:
            n = len(pat)
            if n <= len(norm) and all(
                    p == "*" or p == t for p, t in zip(pat, norm[-n:])):
                return spec
        return None

    def spec(self, tokens: Sequence[str],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """Per-dim axis names for one leaf (None = replicated): 0-d leaves
        replicate, otherwise the table entry with the divisibility guard.
        Raises :class:`UnresolvedShardingError` when no pattern matches."""
        if shape is not None and len(shape) == 0:
            return ()
        entry = self.lookup(tokens)
        if entry is None:
            raise UnresolvedShardingError(
                f"no sharding-table entry matches the leaf path "
                f"{'.'.join(tokens)!r} (normalized "
                f"{'.'.join(normalize_path(tokens))!r}); extend the table "
                "— cfg.sharding_table or parallel/sharding.DEFAULT_TABLE")
        if shape is None:
            return tuple(entry)
        if len(entry) > len(shape):
            raise ValueError(
                f"sharding-table entry {entry} for {'.'.join(tokens)!r} "
                f"names more dims than the leaf's shape {tuple(shape)}")
        dims = []
        for i, size in enumerate(shape):
            axis = entry[i] if i < len(entry) else None
            # an indivisible dim replicates: the layout is a memory and
            # speed choice, the values are the same
            if axis is not None and size % self.sizes[axis] != 0:
                axis = None
            dims.append(axis)
        return tuple(dims)

    @staticmethod
    def placements(spec: Spec) -> Tuple[Any, ...]:
        """One DTensor placement per mesh axis (in ``MESH_AXES`` order)
        for a per-dim ``spec``."""
        out = []
        for axis in MESH_AXES:
            dims = [d for d, a in enumerate(spec) if a == axis]
            if len(dims) > 1:
                raise ValueError(f"spec {spec} shards two dims over {axis!r}")
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def leaf_placements(self, tokens: Sequence[str],
                        shape: Sequence[int]) -> Tuple[Any, ...]:
        return self.placements(self.spec(tokens, tuple(shape)))

    # --------------------------------------------------------- shardings
    def replicated(self) -> Tuple[Any, ...]:
        return (Replicate(),) * len(MESH_AXES)

    def state_shardings(self, state) -> Any:
        """A TrainState-shaped tree of placements: ``params``,
        ``target_params`` and Adam's ``mu``/``nu`` resolve through the
        same trailing tokens, so moments inherit their param's layout;
        the step and Adam's count are host integers (replicated)."""
        from r2d2_tpu_torch.learner.step import AdamState, TrainState

        def tree(prefix, d):
            return {k: self.leaf_placements(leaf_tokens(*prefix, k),
                                            tuple(v.shape))
                    for k, v in d.items()}

        opt = state.opt_state
        return TrainState(
            step=self.replicated(),
            params=tree(("params",), state.params),
            target_params=tree(("target_params",), state.target_params),
            opt_state=AdamState(count=self.replicated(),
                                mu=tree(("opt_state", "mu"), opt.mu),
                                nu=tree(("opt_state", "nu"), opt.nu)))

    def batch_shardings(self) -> Dict[str, Tuple[Any, ...]]:
        """Leading-axis ``dp`` for every device-batch field."""
        pl = self.placements(("dp",))
        return {k: pl for k in DEVICE_BATCH_KEYS}

    def ring_shardings(self, layout: str = "replicated"
                       ) -> Dict[str, Tuple[Any, ...]]:
        """Device-ring placements: ``"replicated"`` keeps the whole ring
        on every rank; ``"dp"`` resolves the slot axis through the
        ``ring.*`` entries (each rank holds its slab)."""
        if layout not in ("replicated", "dp"):
            raise ValueError(f"unknown device-ring layout {layout!r} "
                             "(expected 'replicated' or 'dp')")
        if layout == "replicated":
            return {k: self.replicated() for k in RING_DATA_KEYS}
        return {k: self.placements(self.spec(("ring", k)))
                for k in RING_DATA_KEYS}

    def per_shardings(self, layout: str = "replicated"
                      ) -> Dict[str, Tuple[Any, ...]]:
        """In-graph PER placements, aligned with the ring slabs."""
        if layout == "replicated":
            return {k: self.replicated() for k in PER_KEYS}
        return {k: self.placements(self.spec(("per", k))) for k in PER_KEYS}

    def anakin_state_shardings(self, ast: Dict[str, Any]
                               ) -> Dict[str, Tuple[Any, ...]]:
        """Placements of the anakin loop's carry (``learner/anakin.py:
        make_anakin_state``; JAX's ``anakin_state_shardings``): every
        lane-batched leaf resolves through ``anakin.lane.*`` (the lane
        axis over dp, replicated where dp does not divide it), and the
        scalars — ring pointer, fill, the per-dispatch deltas — replicate.
        ``block_learning_total`` replicates too (JAX shards it with the
        ring slabs): every rank keeps the whole (num_blocks,) vector, so
        each computes the fill of a cut from the gathered cut vector with
        no further collective."""
        out = {}
        for k, v in ast.items():
            shape = tuple(v.shape)
            if k == "block_learning_total" or not shape:
                out[k] = self.replicated()
            else:
                out[k] = self.placements(self.spec(("anakin", "lane", k),
                                                   shape))
        return out

    # ---------------------------------------------------------- placement
    def _need_mesh(self) -> None:
        if self.mesh is None:
            raise RuntimeError("this ShardingTable resolves specs from axis "
                               "sizes only; placing tensors needs a mesh")

    def place_state(self, state):
        """``state`` (plain tensors, the same values on every rank: a
        same-seed init or a restored checkpoint) as DTensors in the table
        layout — bring-up, and the re-placing half of a checkpoint
        restore.  Collective: every rank calls it."""
        self._need_mesh()
        sh = self.state_shardings(state)
        mesh = self.mesh

        def put(d, pls):
            return {k: distribute_tensor(v.detach(), mesh, list(pls[k]))
                    for k, v in d.items()}

        state.params = put(state.params, sh.params)
        state.target_params = put(state.target_params, sh.target_params)
        state.opt_state.mu = put(state.opt_state.mu, sh.opt_state.mu)
        state.opt_state.nu = put(state.opt_state.nu, sh.opt_state.nu)
        return state


def full(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor holding all of ``t`` (a DTensor's shards gathered —
    collective —; any other tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def gather_state(state):
    """A TrainState of plain full tensors from a DTensor one (collective:
    every rank calls it; each gets the whole state).  The checkpoint's
    byte layout is this one, with or without a mesh."""
    from r2d2_tpu_torch.learner.step import AdamState, TrainState

    def gather(d):
        return {k: full(v).detach() for k, v in d.items()}

    return TrainState(step=state.step, params=gather(state.params),
                      target_params=gather(state.target_params),
                      opt_state=AdamState(count=state.opt_state.count,
                                          mu=gather(state.opt_state.mu),
                                          nu=gather(state.opt_state.nu)))


def shard_batch(table: ShardingTable,
                batch: Dict[str, Any]) -> Dict[str, DTensor]:
    """The WHOLE batch (the same on every rank) → DTensors sharded over
    dp: host-only fields dropped, each rank keeping its rows.  A rank that
    holds only its rows builds the same through
    ``distributed.host_local_batch``."""
    table._need_mesh()
    device = _mesh_device(table.mesh)
    out = {}
    for k, pl in table.batch_shardings().items():
        v = batch[k]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = distribute_tensor(t.to(device), table.mesh, list(pl))
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_batch(cfg, table: ShardingTable) -> None:
    if cfg.batch_size % table.sizes["dp"] != 0:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"dp={table.sizes['dp']}")


def mesh_train_step(cfg, net, table: ShardingTable, state_template=None):
    """THE meshed train step (JAX's ``pjit_train_step``): returns
    ``train_step(state, batch) -> (state, loss, priorities)`` for a DTensor
    ``state`` in the table layout, plus the diagnostic vector (whole and
    the same on every rank) when ``cfg.learnhealth_interval > 0``.

    ``batch`` fields are DTensors sharded over dp, or plain tensors that
    hold this rank's rows (wrapped without communication).  The loss comes
    back as a plain 0-d tensor (the same on every rank) and the priorities
    as this rank's rows, a plain tensor, so feedback never crosses ranks.
    Plain tensors the step makes itself (window index ramps, the device
    counters) act as replicated.  ``state_template`` resolves every leaf
    against the table up front, so an unresolved leaf fails here, not
    mid-step.  The step runs eagerly (its CUDA graph is ROADMAP.md A's
    third host-bound cut), guarded as ``learner.train_step`` by input
    signature and learnhealth arming; ``__wrapped__`` is the unguarded
    step, which the meshed super-steps call."""
    from r2d2_tpu_torch.utils.trace import RETRACES

    from r2d2_tpu_torch.learner.step import make_train_step
    from r2d2_tpu_torch.parallel.distributed import local_rows

    if state_template is None:
        raise ValueError("mesh_train_step needs a state_template (a "
                         "TrainState) to resolve per-leaf placements from "
                         "the table")
    table._need_mesh()
    _check_batch(cfg, table)
    table.state_shardings(state_template)
    lh = cfg.learnhealth_interval > 0
    step = make_train_step(cfg, net, learnhealth=lh)
    mesh = table.mesh
    batch_pl = table.batch_shardings()

    def train_step(state, batch):
        batch = {k: v if isinstance(v, DTensor) else DTensor.from_local(
            v, mesh, list(batch_pl[k])) for k, v in batch.items()}
        with implicit_replication():
            out = step(state, batch)
        state, loss, priorities = out[:3]
        if lh:
            # the diag vector is whole on every rank: its norms reduce
            # over every shard, its histograms over the global batch
            return (state, full(loss), local_rows(priorities),
                    full(out[3]))
        return state, full(loss), local_rows(priorities)

    def armed(state, batch):
        return lh and (state.step + 1) % cfg.learnhealth_interval == 0

    return RETRACES.wrap("learner.train_step", train_step, key=armed)


def mesh_super_step(cfg, net, table: ShardingTable, k: int,
                    state_template=None):
    """The host-sampled super-step on the mesh (JAX's ``pjit_super_step``):
    k meshed train steps on batches each rank gathers from its own ring
    (its dp slab, or the whole ring in a world of one) with this rank's
    rows of the (k, B, 6) bundles.  Returns a :class:`~r2d2_tpu_torch.
    learner.step.SuperStep`."""
    from r2d2_tpu_torch.learner.step import SuperStep

    return SuperStep(cfg, net, k, train_step=mesh_train_step(
        cfg, net, table, state_template=state_template).__wrapped__,
        learnhealth=cfg.learnhealth_interval > 0)
