"""Device-resident replay ring: replay data lives in device memory, not host RAM.

Port of ``r2d2_tpu/replay/device_ring.py``; one ring per rank.  The host-staged
learner moves every training batch across PCIe (38.4 MB of observations per
batch at the flagship width); here the flow is inverted:

- Each experience block crosses H2D **once**, when the actor produces it
  (~3.2 MB per 400 transitions at the flagship width).
- The ring arrays (the host ring's layout, replay_buffer.py) live on the
  device; batch assembly is a gather on the device (:func:`gather_batch`).
- The host keeps the sum-tree, ring accounting and stale-index masking;
  only a (k, B, 6) index bundle and its weights cross per dispatch, and
  nothing at all under in-graph PER (the priorities live here too).

Writes are in-place slot copies (``arrays[k][ptr].copy_(slot[k])``); the
ring is never reallocated.  Without the learner mesh the rank holds the
whole ring (``"replicated"``).  Under it (``train(cfg, use_mesh=True)``)
the ``"dp"`` layout shards the slot axis over the mesh's dp axis: each
rank holds its dp group's slab, a ring of ``num_blocks / dp`` blocks
built from :func:`ring_slice_config`, with its own ``ReplayBuffer`` over
the same slice (:func:`resolve_layout`).

CONCURRENCY CONTRACT: a ring write and the dispatch that reads the ring
must be serialised by the caller (the ReplayBuffer's lock: ``add`` commits
under it, the learner samples indices and enqueues its gathers under it).
An index bundle computed from the host accounting must be enqueued before
any later write, or the gather could read a slot newer than the indices
describe.  Every thread's device work — an actor's staging copy and
commit, the learner's gathers, steps and priority scatters — goes to
PyTorch's one legacy default stream, so the device runs it in the order
the host enqueued it: a gather enqueued before a commit reads the
pre-commit slot.  That single fact gives the port the ordering JAX gets
from dispatch order and donation.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import Block

_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
                np.dtype(np.float32): torch.float32}


def _slot_shapes(cfg: Config, action_dim: int) -> Dict[str, tuple]:
    """(shape, numpy dtype) of one ring slot per data array mirrored on the
    device; the count arrays (burn_in/learning/forward, first_burn_in) stay
    on the host, since index computation is host work."""
    MS, BL = cfg.max_block_steps, cfg.block_length
    K, layers, H = cfg.seqs_per_block, cfg.lstm_layers, cfg.hidden_dim
    return dict(
        obs=((MS, *cfg.stored_obs_shape), np.uint8),
        last_action=((MS, action_dim), np.bool_),
        last_reward=((MS,), np.float32),
        action=((BL,), np.uint8),
        n_step_reward=((BL,), np.float32),
        n_step_gamma=((BL,), np.float32),
        hidden=((K, 2, layers, H), np.float32),
    )


def gather_batch(cfg: Config, arrays: Dict[str, torch.Tensor],
                 ints: torch.Tensor, is_weights: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Batch assembly on the device — the twin of
    ``ReplayBuffer._gather_rows``, with the same index arithmetic and the
    same clamp invariant (stale or padded bytes only occupy positions the
    loss masks out; see the INVARIANT note there).

    ``ints`` is (B, 6) int32: [block_idx, t0, seq_idx, burn_in, learning,
    forward], computed on the host under the buffer lock or by the
    in-graph sampler.  ``action`` comes out int64 (``torch.gather``'s index
    type), ``last_action`` float32.
    """
    L, T = cfg.learning_steps, cfg.seq_len
    idx = ints.long()
    block_idx, t0, seq_idx = idx[:, 0], idx[:, 1], idx[:, 2]
    dev = ints.device
    time_idx = torch.clamp(t0[:, None] + torch.arange(T, device=dev),
                           max=cfg.max_block_steps - 1)          # (B, T)
    bcol = block_idx[:, None]
    widx = torch.clamp(seq_idx[:, None] * L + torch.arange(L, device=dev),
                       max=cfg.block_length - 1)                 # (B, L)
    return dict(
        obs=arrays["obs"][bcol, time_idx],
        last_action=arrays["last_action"][bcol, time_idx].float(),
        last_reward=arrays["last_reward"][bcol, time_idx],
        hidden=arrays["hidden"][block_idx, seq_idx],
        action=arrays["action"][bcol, widx].long(),
        n_step_reward=arrays["n_step_reward"][bcol, widx],
        n_step_gamma=arrays["n_step_gamma"][bcol, widx],
        burn_in=ints[:, 3],
        learning=ints[:, 4],
        forward=ints[:, 5],
        is_weights=is_weights,
    )


def _dp_size(mesh) -> int:
    if isinstance(mesh, dict):
        return int(mesh.get("dp", 1))
    return mesh.size(mesh.mesh_dim_names.index("dp"))


def resolve_layout(cfg: Config, mesh=None, need_bytes: int = 0,
                   cap_bytes: Optional[int] = None) -> str:
    """``cfg.device_ring_layout`` resolved to ``"replicated"`` or
    ``"dp"`` (``mesh``: the learner's ``DeviceMesh``, or its axis sizes as
    a dict; ``need_bytes`` the whole ring; ``cap_bytes`` one device's
    memory, None when unknown).

    The JAX package's rules: ``"auto"`` shards over dp exactly when the
    whole ring would not fit 80% of one device and the shapes allow it
    (``num_blocks`` and ``batch_size`` divisible by dp); an explicit
    ``"dp"`` raises when they do not, or when there is no mesh.  One
    difference: the JAX package refuses ``"dp"`` on a mesh whose dp axis
    is 1, while in the port a rank always holds its own slab, and at
    dp = 1 that slab is the whole ring."""
    requested = cfg.device_ring_layout
    if mesh is None:
        if requested == "dp":
            raise ValueError(
                "device_ring_layout='dp' shards the ring over the learner "
                "mesh's dp axis: it needs a mesh, train(cfg, use_mesh=True) "
                "(ROADMAP.md A item 7a)")
        return "replicated"
    dp = _dp_size(mesh)
    can_dp = cfg.num_blocks % dp == 0 and cfg.batch_size % dp == 0
    if requested == "dp":
        if not can_dp:
            raise ValueError(
                f"device_ring_layout='dp' needs num_blocks "
                f"({cfg.num_blocks}) and batch_size ({cfg.batch_size}) "
                f"divisible by dp={dp}")
        return "dp"
    if requested == "replicated":
        return "replicated"
    if (dp > 1 and can_dp and cap_bytes is not None
            and need_bytes > 0.8 * cap_bytes):
        return "dp"
    return "replicated"


def ring_slice_config(cfg: Config, dp: int) -> Config:
    """The config of one rank's slab of a ring split over ``dp`` ranks:
    ``buffer_capacity / dp`` (so ``num_blocks / dp`` blocks) and
    ``learning_starts / dp`` rounded up, so the ranks together start
    learning at the whole ring's fill.  The identity at dp = 1."""
    if dp == 1:
        return cfg
    if cfg.num_blocks % dp:
        raise ValueError(f"num_blocks ({cfg.num_blocks}) must divide over "
                         f"the mesh's dp={dp} ranks, each holding a slab")
    return cfg.replace(buffer_capacity=cfg.buffer_capacity // dp,
                       learning_starts=-(-cfg.learning_starts // dp))


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: on a CUDA device through a pinned host copy and
    a non-blocking H2D copy on the current stream (the caching host
    allocator keeps the pinned block until the copy has run); on the CPU
    a copy."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


class DeviceRing:
    """Owns the device-resident ring arrays and their write path, and under
    ``cfg.in_graph_per`` the PER leaves and sampling metadata.

    ``layout`` records what the ring is: the whole ring
    (``"replicated"``) or this rank's dp slab (``"dp"``, built from
    :func:`ring_slice_config`).  Either way one process holds one group:
    ``num_groups`` is 1, and the ReplayBuffer's slot-group mapping is the
    identity."""

    def __init__(self, cfg: Config, action_dim: int, device="cuda",
                 layout: str = "replicated"):
        if layout not in ("replicated", "dp"):
            raise ValueError(f"unknown device-ring layout {layout!r}")
        self.cfg = cfg
        self.action_dim = action_dim
        self.device = torch.device(device)
        self.layout = layout
        self.num_groups = 1
        NB = cfg.num_blocks
        self._slot_shapes = _slot_shapes(cfg, action_dim)
        self.arrays = {
            k: torch.zeros((NB, *shape), dtype=_TORCH_DTYPE[np.dtype(dt)],
                           device=self.device)
            for k, (shape, dt) in self._slot_shapes.items()}

        # --- in-graph PER state (cfg.in_graph_per) ---------------------
        # Leaf priorities (td**alpha; 0 = never sampleable) and the
        # per-sequence window metadata the in-graph sampler builds index
        # bundles from (learner/step.py:_in_graph_sample).  The learner's
        # super-step scatters into the leaves in place and actor commits
        # write them; both only under the coordinating lock.
        self._per_prios = self._per_seq_meta = self._per_first = None
        if cfg.in_graph_per:
            K = cfg.seqs_per_block
            self._per_prios = torch.zeros(NB * K, dtype=torch.float32,
                                          device=self.device)
            self._per_seq_meta = torch.zeros((NB, K, 3), dtype=torch.int32,
                                             device=self.device)
            self._per_first = torch.zeros(NB, dtype=torch.int32,
                                          device=self.device)

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def stage(self, block: Block) -> Dict[str, torch.Tensor]:
        """Host half of a ring write: zero-pad the block to the fixed slot
        shape in pinned memory and start its H2D copies.  Needs NO lock —
        staging touches no ring state, so callers do it outside the
        coordinating lock.

        Short blocks are zero-padded; the padding occupies exactly the
        positions the host ring would leave stale, which the sampling
        clamp invariant already keeps loss-masked."""
        cuda = self.device.type == "cuda"
        slot = {}
        for k, (shape, dt) in self._slot_shapes.items():
            host = torch.zeros(shape, dtype=_TORCH_DTYPE[np.dtype(dt)],
                               pin_memory=cuda)
            src = torch.from_numpy(np.ascontiguousarray(getattr(block, k)))
            n = block.num_sequences if k == "hidden" else src.shape[0]
            host[:n].copy_(src[:n])
            slot[k] = host.to(self.device, non_blocking=cuda)
        return slot

    def commit(self, slot: Dict[str, torch.Tensor], ptr: int) -> None:
        """Device half of a ring write: in-place copies into (physical)
        slot ``ptr``.  The caller holds the coordinating lock (see the
        module contract); it only enqueues device copies."""
        for k, a in self.arrays.items():
            a[ptr].copy_(slot[k])

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """The ring arrays, for a gather (caller holds the coordinating
        lock — see the module contract)."""
        return self.arrays

    # ------------------------------------------------- in-graph PER state
    def commit_per(self, slot: int, prios_alpha: np.ndarray,
                   meta: np.ndarray, first_burn: int) -> None:
        """Write one block's PER leaves (td**alpha, (K,) f32, zero past
        num_sequences = unsampleable) and its sampling metadata ((K, 3) i32
        [burn, learn, fwd]; first_burn a scalar).  The caller holds the
        coordinating lock: these copies are enqueued behind every priority
        scatter a super-step already enqueued."""
        K = self.cfg.seqs_per_block
        self._per_prios[slot * K:(slot + 1) * K].copy_(
            to_device(np.asarray(prios_alpha, np.float32), self.device))
        self._per_seq_meta[slot].copy_(
            to_device(np.asarray(meta, np.int32), self.device))
        self._per_first[slot:slot + 1].copy_(
            to_device(np.asarray([first_burn], np.int32), self.device))

    def take_prios(self) -> torch.Tensor:
        """The priority leaves, for a super-step that scatters into them
        (the caller stores the returned tensor back with
        :meth:`put_prios` before releasing the lock)."""
        return self._per_prios

    def put_prios(self, prios: torch.Tensor) -> None:
        self._per_prios = prios

    def per_meta(self) -> Dict[str, torch.Tensor]:
        """The sampling metadata, for a dispatch."""
        return dict(seq_meta=self._per_seq_meta, first=self._per_first)

    def put_per_meta(self, seq_meta: torch.Tensor,
                     first: torch.Tensor) -> None:
        """Store back sampling metadata a dispatch rewrote (the fused
        on-device loop of ROADMAP.md A item 6 writes it on the device
        instead of through :meth:`commit_per`)."""
        self._per_seq_meta = seq_meta
        self._per_first = first
