"""Vectorised prioritised-replay sum tree (host-side).

A copy of ``r2d2_tpu/replay/sum_tree.py``.  Same capability as the
reference's ``PriorityTree`` (priority_tree.py:4-45): flat-array binary
sum tree, batched leaf updates with level-by-level upward
propagation, stratified proportional sampling with a vectorised top-down
descent, and min-normalised importance-sampling weights.  Stays on the host by
design — it is O(log n) pointer-chasing, the wrong shape for the tensor
cores; the device sees only the resulting batch indices/weights.

The update/descent hot loops run under the replay-buffer lock on a host
core shared with actor inference, so they dispatch to the native C fast
path (r2d2_tpu_torch/native — exact bit-identical ports that also release the
GIL) when it is available, and fall back to the numpy implementations
otherwise (``R2D2_NO_NATIVE=1`` forces the fallback).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from r2d2_tpu_torch import native


class SumTree:
    def __init__(self, capacity: int, prio_exponent: float, is_exponent: float,
                 rng: Optional[np.random.Generator] = None):
        self.capacity = capacity
        # number of levels so that the leaf layer has >= capacity slots
        self.num_levels = 1
        while 2 ** (self.num_levels - 1) < capacity:
            self.num_levels += 1
        self.leaf_offset = 2 ** (self.num_levels - 1) - 1
        self.nodes = np.zeros(2 ** self.num_levels - 1, dtype=np.float64)
        self.prio_exponent = prio_exponent
        self.is_exponent = is_exponent
        self.rng = rng if rng is not None else np.random.default_rng()

    @property
    def total(self) -> float:
        return float(self.nodes[0])

    def update(self, idxes: np.ndarray, td_errors: np.ndarray) -> None:
        """Set leaf priorities to ``td**alpha`` and repair ancestor sums.

        Batched: each tree level is repaired once for the unique set of touched
        parents (reference: priority_tree.py:15-24).
        """
        idxes = np.asarray(idxes, dtype=np.int64)
        if idxes.size == 0:
            return
        leaf_count = self.nodes.size - self.leaf_offset
        if int(idxes.min()) < 0 or int(idxes.max()) >= leaf_count:
            # shared by both backends: the numpy path would otherwise
            # silently overwrite ancestor sums via negative indexing, the C
            # path write outside the nodes heap
            raise IndexError(
                f"sum-tree leaf index out of range [0, {leaf_count}): "
                f"[{int(idxes.min())}, {int(idxes.max())}]")
        prios = np.asarray(td_errors, dtype=np.float64) ** self.prio_exponent
        if native.st_update(self.nodes, self.num_levels, self.leaf_offset,
                            idxes, prios):
            return
        nodes = idxes + self.leaf_offset
        self.nodes[nodes] = prios
        for _ in range(self.num_levels - 1):
            nodes = np.unique((nodes - 1) // 2)
            self.nodes[nodes] = self.nodes[2 * nodes + 1] + self.nodes[2 * nodes + 2]

    def _descend(self, targets: np.ndarray) -> np.ndarray:
        """Vectorised lock-step top-down descent: prefix-sum targets →
        leaf *node* ids (priority_tree.py:26-44 analogue)."""
        out = native.st_descend(self.nodes, self.num_levels, targets)
        if out is not None:
            return out
        targets = targets.copy()
        nodes = np.zeros(targets.shape[0], dtype=np.int64)
        for _ in range(self.num_levels - 1):
            left = 2 * nodes + 1
            left_mass = self.nodes[left]
            go_right = targets >= left_mass
            nodes = np.where(go_right, left + 1, left)
            targets = np.where(go_right, targets - left_mass, targets)
        return nodes

    def sample(self, num_samples: int, raw: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Stratified proportional sample of ``num_samples`` leaves.

        The total mass is split into equal strata with one uniform draw each,
        then all descents run lock-step vectorised (priority_tree.py:26-44).
        Returns (leaf indices, IS weights).  Weights are ``(p/min_p)^-beta``
        normalised by the minimum *sampled* priority, so they lie in (0, 1]
        — the reference's scheme, which avoids a global min-tree.

        ``raw=True`` returns the sampled leaf priorities UNNORMALISED (and
        un-clamped) in the weights slot instead: the sharded replay plane's
        shard servers draw per-shard rows this way and the trainer-side
        coordinator applies the zero-leaf clamp + min-normalisation across
        ALL shards' rows at once, preserving the K=1 min-of-the-whole-batch
        IS scheme content-for-content (parallel/replay_shards.py).
        """
        total = self.nodes[0]
        if total <= 0:
            raise ValueError("cannot sample from an empty tree")
        interval = total / num_samples
        targets = interval * np.arange(num_samples, dtype=np.float64)
        targets += self.rng.uniform(0.0, interval, num_samples)
        nodes = self._descend(targets)

        prios = self.nodes[nodes]
        if raw:
            return nodes - self.leaf_offset, prios.copy()
        # numerical guard: a descent can land on a zero leaf when float error
        # accumulates; clamp to the smallest positive sampled priority
        pos = prios[prios > 0]
        min_p = pos.min() if pos.size else 1.0
        prios = np.maximum(prios, min_p)
        is_weights = (prios / min_p) ** (-self.is_exponent)
        return nodes - self.leaf_offset, is_weights

    # ------------------------------------------------------------ snapshot
    def leaf_values(self) -> np.ndarray:
        """Raw leaf priorities (already ``td**alpha``), length ``capacity``
        — the replay-snapshot payload (checkpoint.py save_replay)."""
        return self.nodes[self.leaf_offset:self.leaf_offset
                          + self.capacity].copy()

    def load_leaves(self, leaves: np.ndarray) -> None:
        """Restore raw leaf priorities (as returned by :meth:`leaf_values`)
        and rebuild every ancestor bottom-up.

        Bit-exact with the incrementally-maintained tree: :meth:`update`
        keeps the invariant that every internal node is EXACTLY the float64
        sum of its two children, so a whole-level bottom-up rebuild from
        identical leaves reproduces the identical node array (asserted in
        tests/test_recovery.py)."""
        leaves = np.asarray(leaves, np.float64)
        if leaves.shape != (self.capacity,):
            raise ValueError(
                f"leaf snapshot has shape {leaves.shape}, tree capacity is "
                f"{self.capacity} — replay snapshot written under a "
                "different buffer geometry")
        self.nodes[:] = 0.0
        self.nodes[self.leaf_offset:self.leaf_offset + self.capacity] = leaves
        for level in range(self.num_levels - 2, -1, -1):
            idx = np.arange(2 ** level - 1, 2 ** (level + 1) - 1)
            self.nodes[idx] = self.nodes[2 * idx + 1] + self.nodes[2 * idx + 2]

    def prefix_mass(self, leaf_idx: int) -> float:
        """Total priority mass of all leaves strictly before ``leaf_idx``
        (O(log n) root walk)."""
        leaf_idx = int(leaf_idx)
        if leaf_idx < 0:
            raise IndexError(f"prefix_mass leaf index {leaf_idx} < 0")
        if leaf_idx >= self.leaf_offset + 1:
            # every leaf is strictly before: the root walk below (and its C
            # port) would start one node past the array when the leaf layer
            # is exactly ``capacity`` (power-of-two capacities) and return
            # 0.0 — e.g. ready()'s last-group mass at num_sequences=4096
            return self.total
        mass = native.st_prefix_mass(self.nodes, self.leaf_offset, leaf_idx)
        if mass is not None:
            return mass
        node = leaf_idx + self.leaf_offset
        mass = 0.0
        while node > 0:
            parent = (node - 1) // 2
            if node == 2 * parent + 2:  # right child: count left sibling
                mass += float(self.nodes[2 * parent + 1])
            node = parent
        return mass

    def sample_range(self, num_samples: int, lo: int, hi: int
                     ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Stratified proportional sample restricted to leaves [lo, hi).

        Used by the dp-sharded device ring: each dp group draws its batch
        rows from its own slice of the leaf space.  Returns (leaf indices,
        raw sampled priorities, range mass) — IS-weight normalisation is
        the caller's job so it can normalise across ALL groups' draws at
        once (keeping the reference's min-of-the-whole-batch scheme), and
        the mass it needs is returned rather than recomputed (two O(log n)
        root walks per group saved in the sampling hot path).
        """
        lo_mass = self.prefix_mass(lo)
        mass = self.prefix_mass(hi) - lo_mass
        if mass <= 0:
            raise ValueError(
                f"cannot sample from empty leaf range [{lo}, {hi})")
        interval = mass / num_samples
        targets = lo_mass + interval * np.arange(num_samples,
                                                 dtype=np.float64)
        targets += self.rng.uniform(0.0, interval, num_samples)
        idxes = self._descend(targets) - self.leaf_offset
        # float error at stratum boundaries can step just outside the range
        idxes = np.clip(idxes, lo, hi - 1)
        return idxes, self.nodes[idxes + self.leaf_offset].copy(), mass
