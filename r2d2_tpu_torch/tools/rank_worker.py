"""Run a task on every rank of a small gloo world on the CPU.

The meshed learner's tests run their ranks as separate processes of this
module; a task is a function of this module named ``task_<name>``, called
on every rank after the default process group is up, and whatever it
returns is pickled per rank.  Each rank has a deadline: past it the rank
dumps every thread's stack and exits (a collective that one rank issued
and its peer did not hangs both), and :func:`run_ranks` kills the whole
group at its own deadline.

Rendezvous is a ``FileStore`` in the caller's directory, never a fixed
port, so many groups can start at once.  Each rank runs one intra-op
thread.  With ``device="cuda"`` each rank takes card ``R`` (NCCL);
otherwise the cards are hidden and the group runs over gloo.

    python -m r2d2_tpu_torch.tools.rank_worker TASK --rank R --world W \\
        --dir DIR [--deadline SECONDS] [--device {cpu,cuda}]

reads ``DIR/args.pkl`` (the task's keyword arguments) and writes
``DIR/rank{R}.pkl``.
"""
from __future__ import annotations

import argparse
import faulthandler
import os
import pickle
import subprocess
import sys
import time
from typing import Any, Dict, List


def run_ranks(task: str, world: int, workdir: str,
              kwargs: Dict[str, Any] = None, timeout: float = 120.0,
              device: str = "cpu") -> List[Any]:
    """Start ``world`` ranks of ``task`` and return their results in rank
    order.  Raises with every rank's stderr if a rank fails or the group
    outlives ``timeout`` (then every rank is killed)."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "args.pkl"), "wb") as f:
        pickle.dump(kwargs or {}, f)
    # the package's parent on the path: the ranks import this checkout
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + (os.pathsep + path if path else ""))
    if device != "cuda":
        env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    procs = []
    for r in range(world):
        err = open(os.path.join(workdir, f"rank{r}.err"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "r2d2_tpu_torch.tools.rank_worker", task,
             "--rank", str(r), "--world", str(world), "--dir", workdir,
             "--deadline", str(max(5.0, timeout - 5.0)),
             "--device", device],
            stdout=err, stderr=subprocess.STDOUT,
            env=dict(env, LOCAL_RANK=str(r))), err))
    end = time.monotonic() + timeout
    failed = None
    try:
        for p, _ in procs:
            left = end - time.monotonic()
            try:
                rc = p.wait(timeout=max(0.1, left))
            except subprocess.TimeoutExpired:
                failed = f"the {world}-rank group outlived {timeout} s"
                break
            if rc != 0:
                failed = f"a rank exited with {rc}"
                break
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        logs = []
        for r, (_, err) in enumerate(procs):
            err.seek(0)
            logs.append(f"--- rank {r} ---\n{err.read()[-6000:]}")
        raise RuntimeError(f"{task}: {failed}\n" + "\n".join(logs))
    out = []
    for r, (_, err) in enumerate(procs):
        err.close()
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------ tasks

def _np(t):
    return t.detach().cpu().numpy()


def task_collectives(values):
    """sync_counter (sum/max/min) and sync_min_array of this rank's
    entries of ``values``; the default mesh's dp rows; local_rows of a
    dp-sharded tensor; host_local_batch beside shard_batch."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.parallel import distributed as pd
    from r2d2_tpu_torch.parallel.mesh import axis_sizes, make_mesh
    from r2d2_tpu_torch.parallel.sharding import ShardingTable, shard_batch

    r = dist.get_rank()
    mine = values[r]
    out = dict(sum=pd.sync_counter(mine["count"], "sum"),
               max=pd.sync_counter(mine["count"], "max"),
               min=pd.sync_counter(mine["count"], "min"),
               min_array=pd.sync_min_array(mine["array"]))
    cfg = test_config(**values["cfg"])
    mesh = make_mesh(cfg, "cpu")
    out["sizes"] = axis_sizes(mesh)
    out["names"] = mesh.mesh_dim_names
    out["rows"] = pd.dp_rows_for_process(mesh, cfg.batch_size)
    out["host_bs"] = pd.host_batch_size(cfg, mesh)
    batch = values["batch"]
    table = ShardingTable(mesh, cfg)
    rows = out["rows"]
    local = pd.host_local_batch(
        mesh, {k: v[rows] for k, v in batch.items()})
    whole = shard_batch(table, batch)
    out["batch_equal"] = all(
        torch.equal(local[k].to_local(), whole[k].to_local())
        and torch.equal(local[k].full_tensor(),
                        torch.from_numpy(np.ascontiguousarray(batch[k])))
        for k in local)
    out["local_rows"] = _np(pd.local_rows(whole["is_weights"]))
    # a replicated DTensor's rows: redistributed, then this rank's shard
    rep = whole["is_weights"].redistribute(
        placements=table.replicated())
    out["local_rows_replicated"] = _np(pd.local_rows(rep))
    return out


def task_step(params, batches, cfg_kw, layouts):
    """``len(batches)`` meshed train steps from ``params`` (a port state
    dict) at each mesh shape of ``layouts``; per layout the losses, the
    priorities (all rows, by dp coordinate), the learnhealth diag vectors
    (with ``learnhealth_interval`` in ``cfg_kw``) and the final params."""
    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        gather_state,
        mesh_train_step,
    )

    results = {}
    for shape in layouts:
        cfg = test_config(mesh_shape=tuple(shape), **cfg_kw)
        mesh = make_mesh(cfg, "cpu")
        net = create_network(cfg, 4, device="cpu", lstm_impl="scan")
        state = create_train_state(
            cfg, {k: torch.from_numpy(v) for k, v in params.items()})
        table = ShardingTable(mesh, cfg)
        step = mesh_train_step(cfg, net, table, state_template=state)
        state = table.place_state(state)
        # this rank's dp shard of the batch (replicated over fsdp and tp)
        dp = mesh.size(0)
        per = cfg.batch_size // dp
        c = mesh.get_coordinate()[0]
        rows = slice(c * per, (c + 1) * per)
        placements = {k: tuple(map(str, v.placements))
                      for k, v in state.params.items()}
        losses, prios, diags = [], [], []
        for b in batches:
            local = {k: torch.from_numpy(v[rows]) for k, v in b.items()}
            out = step(state, local)
            state, loss, p = out[:3]
            if len(out) > 3:        # cfg.learnhealth_interval > 0
                diags.append(_np(out[3]))
            losses.append(float(loss))
            got = [None] * dist.get_world_size()
            dist.all_gather_object(got, (rows.start, _np(p)))
            seen = dict(got)
            prios.append([seen[s] for s in sorted(seen)])
        full = gather_state(state)
        results[tuple(map(tuple, shape))] = dict(
            losses=losses, prios=prios, diags=diags, placements=placements,
            params={k: _np(v) for k, v in full.params.items()},
            mu={k: _np(v) for k, v in full.opt_state.mu.items()})
    return results


def task_train(cfg_kw, ckpt_dir=None, sync=False):
    """``train(cfg, use_mesh=True, device="cpu")`` (``train_sync`` with
    ``sync``) on this rank; the metrics a test reads, with the
    collectives the run issued."""
    import hashlib

    import numpy as np
    import torch

    from r2d2_tpu_torch import train as ttrain
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.parallel.distributed import COLLECTIVE_CALLS

    cfg = test_config(game_name="Fake", act_device="cpu", **cfg_kw)
    fed = []
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    real = ReplayBuffer.update_priorities
    real_add = ReplayBuffer.add
    first = []

    def counting(self, idxes, priorities, old_ptr, loss):
        fed.append(len(idxes))
        return real(self, idxes, priorities, old_ptr, loss)

    def adding(self, block, *args):
        if not first:
            # the first block this rank's actors cut
            digest = hashlib.sha256()
            for k in ("obs", "action", "last_reward"):
                digest.update(np.ascontiguousarray(
                    getattr(block, k)).tobytes())
            first.append(digest.hexdigest())
        return real_add(self, block, *args)

    ReplayBuffer.update_priorities = counting
    ReplayBuffer.add = adding
    if sync:
        m = ttrain.train_sync(cfg, use_mesh=True, device="cpu",
                              checkpoint_dir=ckpt_dir)
    else:
        m = ttrain.train(cfg, use_mesh=True, device="cpu", verbose=False,
                         checkpoint_dir=ckpt_dir, max_wall_seconds=90)
    keep = ("num_updates", "env_steps", "mean_loss", "buffer_size",
            "buffer_training_steps", "fabric_failed", "healthz")
    out = {k: m.get(k) for k in keep}
    out["params"] = {k: _np(v) for k, v in m["final_params"].items()}
    out["fed"] = fed
    out["collectives"] = dict(COLLECTIVE_CALLS)
    out["threads"] = torch.get_num_threads()
    out["first_block"] = first[0] if first else None
    return out


def _slab(v, dp, r):
    """Rank ``r``'s slab (of ``dp``) of a global ring array, as a tensor."""
    import torch

    n = v.shape[0] // dp
    return torch.from_numpy(v[r * n:(r + 1) * n].copy())


def task_cross_rank(cfg_kw, ring, us, fb_idx, fb_vals, params=None,
                    uniforms=None):
    """The cross-rank draw over this rank's slab of ``ring`` (the global
    ring arrays, ``prios``, ``seq_meta`` and ``first``): per uniform row
    of ``us`` the global draw and this rank's exchanged rows; the slab
    after ``scatter_feedback`` of ``fb_vals`` at ``fb_idx``; with
    ``params``, one meshed in-graph super-step of ``len(uniforms)`` inner
    steps (losses, sampled indices, the slab's leaves, the gathered
    params); and the collectives each part issued."""
    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_in_graph_per_super_step_fn,
    )
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.cross_rank import CROSS_RANK_CALLS, CrossRank
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        gather_state,
        mesh_step,
    )

    cfg = test_config(device_replay=True, in_graph_per=True, **cfg_kw)
    mesh = make_mesh(cfg, "cpu")
    dp, r = dist.get_world_size(), dist.get_rank()
    cross = CrossRank(cfg, mesh, cfg.num_blocks // dp)
    arrays = {k: _slab(v, dp, r) for k, v in ring["arrays"].items()}
    prios, seq_meta, first = (_slab(ring[k], dp, r)
                              for k in ("prios", "seq_meta", "first"))
    out = dict(draws=[], rows=[], calls={})

    CROSS_RANK_CALLS.clear()
    meta = cross.global_meta(seq_meta, first)
    for u in us:
        d, rows = cross.sample_batch(torch.from_numpy(u), prios, meta,
                                     arrays)
        out["draws"].append({k: _np(getattr(d, k))
                             for k in ("idx", "q", "w", "ints")})
        out["rows"].append({k: _np(v) for k, v in rows.items()})
    out["calls"]["draws"] = dict(CROSS_RANK_CALLS)

    CROSS_RANK_CALLS.clear()
    slab = prios.clone()
    rows = cross.rows
    cross.scatter_feedback(slab, torch.from_numpy(fb_idx),
                           torch.from_numpy(fb_vals[rows]))
    out["feedback"] = _np(slab)
    out["calls"]["feedback"] = dict(CROSS_RANK_CALLS)

    if params is not None:
        CROSS_RANK_CALLS.clear()
        net = create_network(cfg, 4, device="cpu", lstm_impl="scan")
        state = create_train_state(
            cfg, {k: torch.from_numpy(v) for k, v in params.items()})
        table = ShardingTable(mesh, cfg)
        step = mesh_step(cfg, net, table, state)
        state = table.place_state(state)
        fn = make_in_graph_per_super_step_fn(
            cfg, net, len(uniforms), train_step=step, cross=cross)
        drawn = []
        state, new_p, losses = fn(state, arrays, prios.clone(), seq_meta,
                                  first, uniforms=torch.from_numpy(uniforms),
                                  record=drawn)
        full = gather_state(state)
        out["super"] = dict(
            losses=_np(losses), prios=_np(new_p),
            idx=[_np(i) for i in drawn],
            params={k: _np(v) for k, v in full.params.items()},
            calls=dict(CROSS_RANK_CALLS))
    return out


def task_emit(cfg_kw, ast, ring, cut, last_q, done):
    """One routed emit (``learner/anakin.py:_make_routed_emit``) of this
    rank's lanes of ``ast`` (the global carry's fields, numpy) into its
    slab of ``ring``, under the global ``cut`` vector: this rank's slab
    and the carry's replicated fields after the emit."""
    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.anakin import _make_routed_emit
    from r2d2_tpu_torch.parallel.cross_rank import CrossRank
    from r2d2_tpu_torch.parallel.mesh import make_mesh

    cfg = test_config(**cfg_kw)
    mesh = make_mesh(cfg, "cpu")
    dp, r = dist.get_world_size(), dist.get_rank()
    cross = CrossRank(cfg, mesh, cfg.num_blocks // dp)
    n = cfg.num_actors // dp
    lanes = slice(r * n, (r + 1) * n)
    mine = {k: (torch.from_numpy(v.copy()) if v.ndim == 0
                or k == "block_learning_total"
                else torch.from_numpy(v[lanes].copy()))
            for k, v in ast.items()}
    arrays = {k: _slab(v, dp, r) for k, v in ring["arrays"].items()}
    prios, seq_meta, first = (_slab(ring[k], dp, r)
                              for k in ("prios", "seq_meta", "first"))
    emit = _make_routed_emit(cfg, 4, done, torch.device("cpu"), n, cross)
    out = emit(mine, arrays, prios, seq_meta, first,
               torch.from_numpy(cut[lanes]), torch.from_numpy(last_q[lanes]))
    return dict(arrays={k: _np(v) for k, v in arrays.items()},
                prios=_np(prios), seq_meta=_np(seq_meta), first=_np(first),
                carry={k: _np(out[k]) for k in (
                    "ptr", "fill", "env_steps_d", "blocks_d",
                    "block_learning_total")})


def task_anakin(cfg_kw, dispatches, seed=0, snap_path=None,
                replicate_lanes=False):
    """A meshed anakin plane over this rank's lanes and slab: warm-up
    rollouts until ready, then ``dispatches`` training dispatches, each
    harvested at once.  Returns the losses and stats per dispatch, the
    gathered global payload, the gathered params, the fetches, the
    collectives and whether the lanes were replicated; ``snap_path``:
    every rank calls ``write_state`` and rank 0 writes it there;
    ``replicate_lanes`` forces the replicated lane axis."""
    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.anakin import AnakinPlane
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.cross_rank import CROSS_RANK_CALLS
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.parallel.sharding import ShardingTable
    from r2d2_tpu_torch.replay.device_ring import (
        DeviceRing,
        ring_slice_config,
    )
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

    cfg = test_config(**cfg_kw)
    mesh = make_mesh(cfg, "cpu")
    table = ShardingTable(mesh, cfg)
    dp = dist.get_world_size()
    net = create_network(cfg, 4, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    learner = Learner(cfg, net, create_train_state(cfg, net.state_dict()),
                      mesh=mesh, table=table)
    ring = DeviceRing(ring_slice_config(cfg, dp), 4, device="cpu",
                      layout="dp")
    plane = AnakinPlane(cfg, net, 4, ring, table=table,
                        state_template=learner.state,
                        replicate_lanes=replicate_lanes)
    HOST_TRANSFERS.reset()
    CROSS_RANK_CALLS.clear()
    rollouts = 0
    while not plane.ready:
        plane.rollout_step(learner.state.params)
        rollouts += 1
    calls_rollout = dict(CROSS_RANK_CALLS)
    CROSS_RANK_CALLS.clear()
    losses, stats = [], []
    for _ in range(dispatches):
        learner.state, res = plane.dispatch(learner.state)
        losses.append(plane.harvest(res).tolist())
        stats.append(plane.stats())
    out = dict(losses=losses, stats=stats, rollouts=rollouts,
               calls_rollout=calls_rollout,
               calls_train=dict(CROSS_RANK_CALLS),
               fetches=HOST_TRANSFERS.get("anakin.result_fetch"),
               payload=plane._payload(),
               params={k: _np(v) for k, v in learner.full_params().items()},
               counters={k: getattr(plane, k)
                         for k in plane._COUNTER_FIELDS},
               replicated=plane.replicated_lanes)
    if snap_path is not None:
        out["meta"] = plane.write_state(snap_path)
    return out


def task_span(layouts, params, batches, ring, uniforms, anakin_kw,
              dispatches):
    """Each of ``layouts`` (mesh shapes over this world) in turn, on this
    rank: ``Learner.run`` over ``batches`` (global batches; a dp group's
    leader stages its dp rows, a peer passes no source); one meshed
    in-graph super-step over this dp group's slab of ``ring`` with
    ``uniforms`` (k, B) (the leader's slab; a peer passes none); and the
    anakin plane of ``anakin_kw`` for ``dispatches`` dispatches.  Per
    layout: the dp coordinate and leadership, the batch each step saw,
    the losses, the fed-back priorities, the drawn indices and the slab's
    leaves, the anakin payload and params, and the ``group_broadcast``
    calls of each part."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.anakin import AnakinPlane
    from r2d2_tpu_torch.learner.learner import DEVICE_BATCH_KEYS, Learner
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_in_graph_per_super_step_fn,
    )
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.cross_rank import CrossRank, GroupPeer
    from r2d2_tpu_torch.parallel.distributed import (
        COLLECTIVE_CALLS,
        dp_group,
    )
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        gather_state,
        mesh_step,
    )
    from r2d2_tpu_torch.replay.device_ring import (
        DeviceRing,
        ring_slice_config,
    )

    def state_of(cfg):
        return create_train_state(
            cfg, {k: torch.from_numpy(v) for k, v in params.items()})

    def broadcasts():
        return COLLECTIVE_CALLS.get("group_broadcast", 0)

    results = {}
    for shape in layouts:
        out = {}
        # --- the host-staged drivetrain
        cfg = test_config(mesh_shape=tuple(map(tuple, shape)),
                          superstep_pipeline=0)
        mesh = make_mesh(cfg, "cpu")
        net = create_network(cfg, 4, device="cpu", lstm_impl="scan")
        learner = Learner(cfg, net, state_of(cfg), mesh=mesh)
        span = learner.span
        dp = mesh.size(mesh.mesh_dim_names.index("dp"))
        per = cfg.batch_size // dp
        rows = slice(span.index * per, (span.index + 1) * per)
        out.update(dp_index=span.index, leader=span.is_leader,
                   group=span.ranks)
        seen, losses, fed = [], [], []
        step = learner._step_fn

        def recording(state, batch, step=step, seen=seen, losses=losses):
            seen.append({k: _np(v.to_local()) for k, v in batch.items()})
            res = step(state, batch)
            losses.append(float(res[1]))
            return res
        learner._step_fn = recording
        feed = iter(batches)

        def source(rows=rows, feed=feed):
            b = next(feed, None)
            if b is None:
                return None
            got = {k: np.ascontiguousarray(b[k][rows])
                   for k in DEVICE_BATCH_KEYS}
            got.update(idxes=np.arange(rows.start, rows.stop),
                       block_ptr=0, env_steps=0)
            return got

        b0 = broadcasts()
        learner.run(None if learner.is_peer else source,
                    None if learner.is_peer
                    else (lambda i, p, o, loss, fed=fed: fed.append(
                        (i.copy(), np.array(p)))),
                    max_steps=len(batches))
        out.update(seen=seen, losses=losses, fed=fed,
                   host_broadcasts=broadcasts() - b0,
                   params={k: _np(v) for k, v in
                           learner.full_params().items()})

        # --- one in-graph super-step over the leaders' slabs
        icfg = test_config(device_replay=True, in_graph_per=True,
                           mesh_shape=tuple(map(tuple, shape)))
        imesh = make_mesh(icfg, "cpu")
        ispan = dp_group(imesh)
        state = state_of(icfg)
        table = ShardingTable(imesh, icfg)
        istep = mesh_step(icfg, net, table, state)
        state = table.place_state(state)
        if ispan.is_leader:
            nb = icfg.num_blocks // dp
            cross = CrossRank(icfg, imesh, nb, span=ispan)
            arrays = {k: _slab(v, dp, ispan.index)
                      for k, v in ring["arrays"].items()}
            prios, seq_meta, first = (_slab(ring[k], dp, ispan.index)
                                      for k in ("prios", "seq_meta",
                                                "first"))
            u = torch.from_numpy(uniforms)
        else:
            cross = GroupPeer(ispan)
            arrays = prios = seq_meta = first = u = None
        fn = make_in_graph_per_super_step_fn(icfg, net, len(uniforms),
                                             train_step=istep, cross=cross)
        drawn = []
        b0 = broadcasts()
        state, leaves, ilosses = fn(state, arrays, prios, seq_meta, first,
                                    uniforms=u, record=drawn)
        out["in_graph"] = dict(
            idx=[_np(i) for i in drawn], losses=_np(ilosses),
            leaves=None if leaves is None else _np(leaves),
            broadcasts=broadcasts() - b0,
            params={k: _np(v) for k, v in gather_state(state)
                    .params.items()})

        # --- anakin: every rank of a group steps the group's lanes
        acfg = test_config(mesh_shape=tuple(map(tuple, shape)),
                           **anakin_kw)
        amesh = make_mesh(acfg, "cpu")
        atable = ShardingTable(amesh, acfg)
        anet = create_network(acfg, 4, device="cpu",
                              generator=torch.Generator().manual_seed(0))
        alearner = Learner(acfg, anet,
                           create_train_state(acfg, anet.state_dict()),
                           mesh=amesh, table=atable)
        aring = DeviceRing(ring_slice_config(acfg, dp), 4, device="cpu",
                           layout="dp")
        plane = AnakinPlane(acfg, anet, 4, aring, table=atable,
                            state_template=alearner.state)
        b0 = broadcasts()
        while not plane.ready:
            plane.rollout_step(alearner.state.params)
        alosses = []
        for _ in range(dispatches):
            alearner.state, res = plane.dispatch(alearner.state)
            alosses.append(plane.harvest(res).tolist())
        # this rank's replica of its dp group's slab, before the gathers
        slab = {k: _np(v) for k, v in plane._payload_tensors().items()
                if k.startswith(("ring_", "per_"))}
        out["anakin"] = dict(
            losses=alosses, slab=slab, payload=plane._payload(),
            broadcasts=broadcasts() - b0,
            counters={k: getattr(plane, k) for k in plane._COUNTER_FIELDS},
            params={k: _np(v) for k, v in
                    alearner.full_params().items()})
        results[tuple(map(tuple, shape))] = out
        dist.barrier()
    return results


def task_mesh_graphs(cfg_kw, params, batches, anakin_kw, dispatches):
    """The meshed entries as their graphs' users call them (on the CPU
    the graph-ready bodies, eagerly) against the plain functions from
    copies of the same state, on this rank: ``mesh_train_step`` against
    ``mesh_step`` over ``batches`` (global batches, this rank's dp rows),
    and the meshed anakin plane's rollouts and ``dispatches`` dispatches
    against ``make_anakin_rollout`` / ``make_anakin_super_step``.  Per
    part whether every output, the carry, the ring, the PER state and the
    train state were equal bit for bit, the collectives each call
    issued, and the losses."""
    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner import anakin
    from r2d2_tpu_torch.learner.graphs import _clone_state
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.cross_rank import CROSS_RANK_CALLS
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        gather_state,
        mesh_step,
        mesh_train_step,
    )
    from r2d2_tpu_torch.replay.device_ring import (
        DeviceRing,
        ring_slice_config,
    )

    def same_state(a, b):
        fa, fb = gather_state(a), gather_state(b)
        return (a.step == b.step and torch.equal(a.step_t, b.step_t)
                and torch.equal(a.opt_state.count_t, b.opt_state.count_t)
                and all(torch.equal(x[k], y[k]) for x, y in (
                    (fa.params, fb.params),
                    (fa.target_params, fb.target_params),
                    (fa.opt_state.mu, fb.opt_state.mu),
                    (fa.opt_state.nu, fb.opt_state.nu)) for k in x))

    dp, r = dist.get_world_size(), dist.get_rank()
    out = {}
    cfg = test_config(mesh_shape=(("dp", dp),), **cfg_kw)
    table = ShardingTable(make_mesh(cfg, "cpu"), cfg)
    net = create_network(cfg, 4, device="cpu", lstm_impl="scan")
    a, b = (table.place_state(create_train_state(
        cfg, {k: torch.from_numpy(v) for k, v in params.items()}))
        for _ in range(2))
    graphed = mesh_train_step(cfg, net, table, state_template=a)
    plain = mesh_step(cfg, net, table, b)
    per = cfg.batch_size // dp
    same, losses = True, []
    for batch in batches:
        rows = {k: torch.from_numpy(v[r * per:(r + 1) * per])
                for k, v in batch.items()}
        ga, gb = graphed(a, rows), plain(b, rows)
        same = same and all(torch.equal(x, y)
                            for x, y in zip(ga[1:], gb[1:]))
        losses.append(float(ga[1]))
    out["step"] = dict(same=same and same_state(a, b), losses=losses)

    acfg = test_config(mesh_shape=(("dp", dp),), **anakin_kw)
    atable = ShardingTable(make_mesh(acfg, "cpu"), acfg)
    anet = create_network(acfg, 4, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    learner = Learner(acfg, anet, create_train_state(acfg,
                                                     anet.state_dict()),
                      mesh=atable.mesh, table=atable)
    plane = anakin.AnakinPlane(
        acfg, anet, 4, DeviceRing(ring_slice_config(acfg, dp), 4,
                                  device="cpu", layout="dp"),
        table=atable, state_template=learner.state)
    rep = plane.replicated_lanes
    n = acfg.num_actors if rep else acfg.num_actors // dp
    lanes = (0, n) if rep else (r * n, (r + 1) * n)
    roll = anakin.make_anakin_rollout(acfg, anet, plane.env, 4,
                                      plane.roll_steps, lanes, plane.cross,
                                      rep)
    step = anakin.make_anakin_super_step(
        acfg, anet, plane.env, 4, lanes, plane.cross,
        mesh_step(acfg, anet, atable, learner.state), rep)

    def copies():
        arrays, prios, seq_meta, first = plane._handles()
        return ({k: v.clone() for k, v in plane.state.items()},
                {k: v.clone() for k, v in arrays.items()}, prios.clone(),
                seq_meta.clone(), first.clone())

    def same_as(want):
        ast, arrays, prios, seq_meta, first = want
        mine = plane._handles()
        return (all(torch.equal(plane.state[k], ast[k]) for k in ast)
                and all(torch.equal(mine[0][k], arrays[k]) for k in arrays)
                and torch.equal(mine[1], prios)
                and torch.equal(mine[2], seq_meta)
                and torch.equal(mine[3], first))

    carry = {k: v.data_ptr() for k, v in plane.state.items()}
    ok, calls = True, dict(rollout=[], dispatch=[])
    while not plane.ready:
        want = roll(learner.state.params, *copies())
        CROSS_RANK_CALLS.clear()
        got = plane.rollout(learner.state.params, plane.state,
                            *plane._handles())
        calls["rollout"].append(dict(CROSS_RANK_CALLS))
        plane._absorb(got[-1].numpy())
        ok = ok and torch.equal(got[-1], want[-1]) and same_as(want[:5])
    dlosses = []
    for d in range(dispatches):
        want = step(_clone_state(learner.state), *copies(), d)
        CROSS_RANK_CALLS.clear()
        learner.state, *rest = plane.super_step(
            learner.state, plane.state, *plane._handles(), d)
        calls["dispatch"].append(dict(CROSS_RANK_CALLS))
        ok = (ok and torch.equal(rest[-1], want[-1])
              and same_as(want[1:6]) and same_state(learner.state, want[0]))
        dlosses.append(rest[-1][:acfg.superstep_k].tolist())
    out["anakin"] = dict(
        same=ok and carry == {k: v.data_ptr()
                              for k, v in plane.state.items()},
        calls=calls, losses=dlosses, replicated=rep,
        roll_steps=plane.roll_steps)
    return out


def task_span_train(runs, device="cpu"):
    """``train(cfg, use_mesh=True, device=device)`` (``train_sync`` where
    a run says ``sync``) for each of ``runs`` (config keywords), one after
    another on this rank, with the collectives each issued.  On the CPU
    the actors act there too; on the card they act through the kernel."""
    import torch.distributed as dist

    from r2d2_tpu_torch import train as ttrain
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.parallel.distributed import COLLECTIVE_CALLS

    out = []
    for run in runs:
        kw = dict(game_name="Fake", **run)
        if device == "cpu":
            kw.setdefault("act_device", "cpu")
        sync = kw.pop("sync", False)
        cfg = test_config(**kw)
        COLLECTIVE_CALLS.clear()
        if sync:
            m = ttrain.train_sync(cfg, use_mesh=True, device=device)
        else:
            m = ttrain.train(cfg, use_mesh=True, device=device,
                             verbose=False, max_wall_seconds=90)
        keep = ("num_updates", "env_steps", "mean_loss", "buffer_size",
                "buffer_training_steps", "fabric_failed", "peer")
        got = {k: m.get(k) for k in keep}
        got["params"] = {k: _np(v) for k, v in m["final_params"].items()}
        got["collectives"] = dict(COLLECTIVE_CALLS)
        out.append(got)
        dist.barrier()
    return out


def task_soak(minutes, ingraph, device, log_path, log_interval=10.0):
    """``tools/soak.py``'s run on this rank of its dp mesh; rank 0
    appends the stats entries to ``log_path``."""
    import torch.distributed as dist

    from r2d2_tpu_torch.telemetry.runlog import RunLog
    from r2d2_tpu_torch.tools import soak

    log = (RunLog(os.path.dirname(log_path) or ".",
                  os.path.basename(log_path))
           if dist.get_rank() == 0 else None)
    try:
        return soak.soak_run(minutes, ingraph, True, device,
                             log_sink=log.append if log else None,
                             log_interval=log_interval)
    finally:
        if log is not None:
            log.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("task")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--deadline", type=float, default=115.0)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    a = ap.parse_args(argv)
    faulthandler.dump_traceback_later(a.deadline, exit=True)

    import torch
    import torch.distributed as dist

    from r2d2_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    with open(os.path.join(a.dir, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    store = dist.FileStore(os.path.join(a.dir, "store"), a.world)
    init_distributed(store=store, world_size=a.world, rank=a.rank,
                     device=a.device)
    try:
        result = globals()[f"task_{a.task}"](**kwargs)
        with open(os.path.join(a.dir, f"rank{a.rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
