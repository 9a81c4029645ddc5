"""The cross-rank draw: in-graph PER over every rank's slab of the ring.

The JAX package runs one GSPMD program over the whole mesh: under a
dp-sharded ring its stratified draw reads a replicated view of every
slab's PER leaves, and XLA moves the sampled sequences to the rows'
owners and the new priorities back to the slabs that hold them
(``r2d2_tpu/parallel/sharding.py:pjit_in_graph_per_super_step``, the
multi-host branch of ``r2d2_tpu/learner/learner.py:
_run_device_in_graph_per``).  The port runs one process per device, so
those moves are explicit collectives over the mesh's dp group, issued by
every rank in the same order (a collective one rank skips hangs all):

- :meth:`CrossRank.global_leaves` — one ``all_gather`` of every rank's
  slab leaves in rank order: the global ``(dp·NB_r·K,)`` f32 array, so the
  compensated cumsum runs over the same array as at world size 1 and the
  strata are bitwise those of one slab holding the same ring;
  :meth:`CrossRank.global_meta` gathers ``seq_meta`` and ``first`` the
  same way (two more);
- :func:`draw` — the stratified draw over the global arrays
  (``learner/step.py:_in_graph_sample``) with uniforms every rank holds
  alike: the global ``idx``, ``q``, ``ints`` and IS weights normalised by
  the whole batch's minimum, plus this rank's rows (no collective);
- :meth:`CrossRank.exchange_rows` — each rank gathers, from its own slab,
  the rows of every rank's share (owner = ``block_idx // NB_r``, local
  block ``block_idx % NB_r``), and one ``all_to_all_single`` per ring
  field sends each share to the rank that trains it, which keeps the
  owner's copy of each row.  The shapes follow from the batch size alone,
  so no size is exchanged and no rank waits on the host;
- :meth:`CrossRank.scatter_feedback` — one ``all_gather`` of the batch's
  new priorities; each rank writes the rows whose leaves it owns, in
  global row order, so ``scatter_last``'s last-write-wins gives the slab
  a world of one would.

For the anakin loop, :meth:`CrossRank.gather_cuts` and
:meth:`CrossRank.route_blocks` move freshly cut blocks to the owners of
their ring slots (``learner/anakin.py``), and :meth:`CrossRank.
reduce_sum` adds the lanes' counters.

At world size 1 every collective is still issued, over a group of one:
the path a larger world takes is the one a single card runs.  Every call
ticks :data:`CROSS_RANK_CALLS` by operation, and every call must come
from the learner thread (``parallel/distributed.py``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from r2d2_tpu_torch.learner.step import _in_graph_sample_raw
from r2d2_tpu_torch.parallel.distributed import (
    _check_thread,
    dp_rows_for_process,
)
from r2d2_tpu_torch.replay.device_ring import gather_batch

# collectives issued by this module, by operation ("all_gather",
# "all_to_all", "all_reduce"): the counts a run is held to
CROSS_RANK_CALLS: collections.Counter = collections.Counter()

# the gathered ring fields a rank sends to the rows' trainers
ROW_FIELDS = ("obs", "last_action", "last_reward", "hidden", "action",
              "n_step_reward", "n_step_gamma")


@dataclasses.dataclass
class Draw:
    """One global stratified draw: ``idx`` (B,) leaf indices, ``q`` (B,)
    densities, ``w`` (B,) IS weights, ``ints`` (B, 6) index rows — all
    global and the same on every rank — and ``rows``, this rank's slice
    of the batch."""
    idx: torch.Tensor
    q: torch.Tensor
    w: torch.Tensor
    ints: torch.Tensor
    rows: slice


def draw(cfg, u: torch.Tensor, leaves: torch.Tensor, seq_meta: torch.Tensor,
         first: torch.Tensor, rows: slice = None) -> Draw:
    """The stratified proportional draw over the GLOBAL leaves, one row
    per uniform in ``u`` (the same on every rank): JAX's f32 arithmetic
    (``_in_graph_sample``), IS weights ``(q / min q)^-beta`` over the
    whole batch.  No collective; ``rows`` defaults to the whole batch."""
    idx, q, ints = _in_graph_sample_raw(cfg, u, leaves, seq_meta, first)
    w = (q / q.min()) ** (-cfg.importance_sampling_exponent)
    return Draw(idx=idx, q=q, w=w.float(), ints=ints,
                rows=rows if rows is not None else slice(0, u.shape[0]))


class CrossRank:
    """The collectives of the cross-rank draw over one learner mesh.

    ``slab_blocks`` is ``NB_r``, the blocks of one rank's slab (the
    ring's ``num_blocks / dp``); rank ``d`` of the dp group owns global
    blocks ``[d·NB_r, (d+1)·NB_r)``.  Each rank holds one dp group (the
    port's one device per rank; ``dp_rows_for_process`` refuses a group
    over several ranks)."""

    def __init__(self, cfg, mesh, slab_blocks: int):
        self.cfg = cfg
        self.mesh = mesh
        self.group = mesh.get_group("dp")
        self.dp = dist.get_world_size(self.group)
        self.rank = mesh.get_local_rank("dp")
        self.nb = int(slab_blocks)
        self.K = cfg.seqs_per_block
        self.rows = dp_rows_for_process(mesh, cfg.batch_size)
        if self.nb * self.dp != cfg.num_blocks:
            raise ValueError(
                f"a slab of {self.nb} blocks on each of dp={self.dp} ranks "
                f"is not the ring's {cfg.num_blocks} blocks")

    # ------------------------------------------------------- collectives
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order."""
        _check_thread()
        src = t.contiguous()
        if src.dtype == torch.bool:
            return self.all_gather(src.view(torch.uint8)).bool()
        out = torch.empty((self.dp * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.group)
        CROSS_RANK_CALLS["all_gather"] += 1
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s dim 0 split into dp equal chunks, chunk ``d`` sent to
        rank ``d``; returns what every rank sent here, as
        ``(dp, rows / dp, ...)`` in rank order."""
        _check_thread()
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        CROSS_RANK_CALLS["all_to_all"] += 1
        return out.view(self.dp, src.shape[0] // self.dp, *src.shape[1:])

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (a new tensor)."""
        _check_thread()
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        CROSS_RANK_CALLS["all_reduce"] += 1
        return out

    # ---------------------------------------------------------- the draw
    def global_leaves(self, prios: torch.Tensor) -> torch.Tensor:
        """The global ``(dp·NB_r·K,)`` PER leaves (one all_gather)."""
        return self.all_gather(prios)

    def global_meta(self, seq_meta: torch.Tensor, first: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The global ``seq_meta`` (NB, K, 3) and ``first`` (NB,) (two
        all_gathers)."""
        return self.all_gather(seq_meta), self.all_gather(first)

    def draw(self, u: torch.Tensor, leaves: torch.Tensor,
             seq_meta: torch.Tensor, first: torch.Tensor) -> Draw:
        """:func:`draw` over the global arrays, with this rank's rows."""
        return draw(self.cfg, u, leaves, seq_meta, first, rows=self.rows)

    def exchange_rows(self, arrays: Dict[str, torch.Tensor], d: Draw
                      ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the drawn batch, as plain tensors: equal,
        bit for bit, to rows ``d.rows`` of ``gather_batch`` over the
        concatenated ring.  Each rank gathers every row's local block
        (``block_idx % NB_r``) from its own slab; one all_to_all per
        :data:`ROW_FIELDS` entry sends share ``r`` to rank ``r``; the
        receiver keeps, per row, the copy of the rank that owns it."""
        ints = d.ints
        local = torch.cat([(ints[:, :1] % self.nb), ints[:, 1:]], dim=1)
        sent = gather_batch(self.cfg, arrays, local, d.w)
        mine = ints[d.rows, 0].long()
        owner = mine // self.nb
        pick = torch.arange(owner.shape[0], device=owner.device)
        out = {k: self.all_to_all(sent[k])[owner, pick]
               for k in ROW_FIELDS}
        out.update(burn_in=ints[d.rows, 3], learning=ints[d.rows, 4],
                   forward=ints[d.rows, 5], is_weights=d.w[d.rows])
        return out

    def sample_batch(self, u: torch.Tensor, prios: torch.Tensor,
                     meta: Tuple[torch.Tensor, torch.Tensor],
                     arrays: Dict[str, torch.Tensor]
                     ) -> Tuple[Draw, Dict[str, torch.Tensor]]:
        """One inner step's draw and this rank's rows: the global leaves,
        the draw over them and ``meta`` (from :meth:`global_meta`), and
        the row exchange."""
        d = self.draw(u, self.global_leaves(prios), *meta)
        return d, self.exchange_rows(arrays, d)

    def scatter_feedback(self, prios: torch.Tensor, idx: torch.Tensor,
                         vals: torch.Tensor) -> None:
        """Write the batch's new leaf values into this rank's slab in
        place: ``vals`` is this rank's rows (already ``** prio_exponent``),
        all-gathered into the global batch; each rank writes the rows
        whose leaves it owns.  A leaf drawn more than once takes its last
        occurrence in global row order (``step.scatter_last``).  Rows of
        other slabs land on ``idx % (NB_r·K)`` too, carrying the value the
        owned row there writes, or the leaf's own value, so every write to
        one leaf carries one value."""
        allv = self.all_gather(vals)
        n = self.nb * self.K
        loc = idx % n
        owned = (idx // n) == self.rank
        pos = torch.arange(idx.shape[0], device=idx.device)
        same = (loc[:, None] == loc[None, :]) & owned[None, :]
        last = torch.where(same, pos[None, :], -1).amax(dim=1)
        prios[loc] = torch.where(last >= 0, allv[last.clamp(min=0)],
                                 prios[loc])

    # ------------------------------------------------- anakin's block routing
    def gather_cuts(self, cut: torch.Tensor, totals: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every lane's cut flag and new learning total, in global lane
        order, from this rank's lanes (one all_gather)."""
        both = self.all_gather(torch.stack([cut.int(), totals.int()], 1))
        return both[:, 0].bool(), both[:, 1]

    def route_blocks(self, rows: torch.Tensor, slot: torch.Tensor,
                     cut: torch.Tensor) -> torch.Tensor:
        """Move cut blocks to the owners of their ring slots.  ``rows``
        is this rank's lanes' packed blocks (n_r, R) uint8; ``slot`` and
        ``cut`` are every lane's global slot and cut flag (N,), the same
        on every rank.  One all_to_all of fixed shape: the chunk for rank
        ``d`` holds this rank's lanes, each the packed block where the
        lane cut into a slot ``d`` owns and zeros elsewhere (the cut
        count lives on the device, and sizing the exchange by it would
        stop the host).  Returns the (N, R) rows that arrived here, in
        global lane order."""
        n = rows.shape[0]
        mine = slice(self.rank * n, (self.rank + 1) * n)
        dest = slot[mine] // self.nb
        ranks = torch.arange(self.dp, device=rows.device)[:, None]
        keep = (dest[None, :] == ranks) & cut[mine][None, :]     # (dp, n)
        send = torch.where(keep[:, :, None], rows[None],
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        return self.all_to_all(send.reshape(self.dp * n, -1)).reshape(
            self.dp * n, -1)
