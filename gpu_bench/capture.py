"""What the check reads from the run, taken where the port's entries are
built: the benchmark's weights go into every network the run builds, the
learner's first three steps and a seeded sample of the actors' acts are
copied as they happen, and every act is counted with its time.

Nothing here changes what the port computes: each wrapper calls the
port's own entry with the same arguments and returns what it returned.
The copies are made on the stream the entries run on, so they read what
each step read and wrote; after the third step the wrappers only count.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import torch

STEPS = 3


def _clone(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tree.items()}


class Capture:
    """Installs the wrappers (:meth:`install`), restores the port's entries
    (:meth:`uninstall`), and holds what they saw.

    ``act_picks``: the indices, in call order over all fleets, of the acts
    whose inputs and outputs are kept."""

    def __init__(self, weights: Dict[str, torch.Tensor], act_picks,
                 seqs_per_block: int):
        self.weights = weights
        self.act_picks = frozenset(act_picks)
        self.K = seqs_per_block
        self.steps: List[Dict[str, Any]] = []
        self.p0 = self.target0 = self.mu1 = self.p3 = None
        self.acts: List[Dict[str, Any]] = []
        # (time the act returned, lanes) of every act
        self.act_log: List[tuple] = []
        self._lock = threading.Lock()
        self._saved: List[tuple] = []
        self.learner_calls = 0
        self.t_first_step = None

    @property
    def done(self) -> bool:
        return (self.p3 is not None
                and len(self.acts) == len(self.act_picks))

    # ------------------------------------------------------------ install
    def install(self) -> None:
        from r2d2_tpu_torch import train as train_mod
        from r2d2_tpu_torch.learner import learner as learner_mod

        self._patch(train_mod, "create_network", self._network)
        self._patch(train_mod, "make_host_act_fn", self._act_fn)
        self._patch(learner_mod, "make_learner_step", self._learner_step)
        self._patch(learner_mod, "make_in_graph_per_super_step_fn",
                    self._in_graph_super_step)

    def uninstall(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()

    def _patch(self, mod, name: str, make) -> None:
        orig = getattr(mod, name)
        self._saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    # ------------------------------------------------------------ weights
    def _network(self, orig):
        weights = self.weights

        def create_network(cfg, action_dim, device="cuda", generator=None,
                           lstm_impl=None):
            net = orig(cfg, action_dim, device=device, generator=generator,
                       lstm_impl=lstm_impl)
            own = dict(net.named_parameters())
            if {k: tuple(v.shape) for k, v in own.items()} != {
                    k: tuple(v.shape) for k, v in weights.items()}:
                raise ValueError(
                    "the port's network does not have the reference's "
                    f"parameters: {sorted(own)} vs {sorted(weights)}")
            with torch.no_grad():
                for k, v in own.items():
                    v.copy_(weights[k])
            return net

        return create_network

    # ------------------------------------------------------------ learner
    def _begin_step(self, state) -> int:
        n = self.learner_calls
        if n == 0:
            self.t_first_step = time.perf_counter()
            self.p0 = _clone(state.params)
            self.target0 = _clone(state.target_params)
        return n

    def _end_step(self, n: int, state) -> None:
        if n == 0:
            self.mu1 = _clone(state.opt_state.mu)
        if n == STEPS - 1:
            self.p3 = _clone(state.params)
        self.learner_calls = n + 1

    def _learner_step(self, orig):
        """Host-staged batches: each of the first steps' batch, loss and
        priorities."""
        cap = self

        def make(cfg, net, learnhealth=False, guard=None):
            step = orig(cfg, net, learnhealth=learnhealth, guard=guard)

            def train_step(state, batch):
                n = cap.learner_calls
                if n >= STEPS:
                    return step(state, batch)
                cap._begin_step(state)
                kept = _clone(batch)
                out = step(state, batch)
                cap.steps.append(dict(batch=kept, loss=out[1].clone(),
                                      priorities=out[2].clone()))
                cap._end_step(n, state)
                return out

            train_step.graphs = step.graphs
            return train_step

        return make

    def _in_graph_super_step(self, orig):
        """Device-PER super-steps: each of the first inner steps' leaf
        masses, uniforms and drawn leaves, the ring slots those leaves lie
        in, and its loss."""
        cap = self

        def make(cfg, net, k, train_step=None, cross=None,
                 learnhealth=False, guard=None):
            sst = orig(cfg, net, k, train_step=train_step, cross=cross,
                       learnhealth=learnhealth, guard=guard)
            graphs = sst.graphs
            run = graphs.run

            def recorded_run(body, state, fixed=(), scratch=(), inputs=None,
                             armed=False):
                n = cap.learner_calls
                if n >= STEPS or cross is not None:
                    return run(body, state, fixed, scratch, inputs, armed)
                cap._begin_step(state)
                arrays, seq_meta, first = fixed[0], fixed[1], fixed[2]
                rec = dict(prios=scratch[0].clone(),
                           u=inputs["u"].clone(),
                           seq_meta=seq_meta.clone(), first=first.clone())
                out = run(body, state, fixed, scratch, inputs, armed)
                idx = out[1]
                # the step's feedback: leaves[idx] = priority ** exponent,
                # where a leaf drawn twice keeps its last row's value
                rec["leaves_after"] = scratch[0][idx].clone()
                blocks, slot = torch.unique(idx // cap.K,
                                            return_inverse=True)
                rec.update(loss=out[0].clone(), idx=idx.clone(),
                           slot=slot, blocks=blocks,
                           slots={key: a[blocks].clone()
                                  for key, a in arrays.items()})
                cap.steps.append(rec)
                cap._end_step(n, state)
                return out

            graphs.run = recorded_run
            return sst

        return make

    # ------------------------------------------------------------ acts
    def _act_fn(self, orig):
        cap = self

        def make(net, *args, **kwargs):
            act = orig(net, *args, **kwargs)

            def act_host(params, obs, last_action, last_reward, hidden):
                q, new_hidden = act(params, obs, last_action, last_reward,
                                    hidden)
                t = time.perf_counter()
                with cap._lock:
                    i = len(cap.act_log)
                    cap.act_log.append((t, q.shape[0]))
                    keep = (len(cap.acts) < len(cap.act_picks)
                            and i in cap.act_picks)
                if keep:
                    with cap._lock:
                        cap.acts.append(dict(
                            params=params, obs=obs.copy(),
                            last_action=last_action.copy(),
                            last_reward=last_reward.copy(),
                            hidden=hidden.copy(), q=q.copy(),
                            new_hidden=new_hidden.copy()))
                return q, new_hidden

            act_host.act = getattr(act, "act", None)
            return act_host

        return make


def env_frames(act_log: List[tuple], t0: float, t1: float) -> int:
    """Lanes stepped by the acts that returned in (t0, t1]."""
    return sum(n for t, n in act_log if t0 < t <= t1)


def act_sample(seed: int, count: int, first: int, last: int) -> List[int]:
    """``count`` distinct act indices in [first, last), drawn from the
    seed."""
    g = torch.Generator().manual_seed(seed & ((1 << 63) - 1))
    return sorted((torch.randperm(last - first, generator=g)[:count]
                   + first).tolist())
