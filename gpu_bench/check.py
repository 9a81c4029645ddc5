"""The comparison that decides ``correct``: what the run's timed entries
produced, against the plain reference (``reference/``) on the same
inputs.

Training (the learner's first three steps, on the batches the port drew):
``loss_gap`` is |loss - reference loss| over |reference loss| of the
first step, where both sides start from the same weights; ``grad_gap``
the worst leaf's gap between the norms of the first clipped gradient,
the port's worked out from its Adam state after one step (mu_1 = (1 -
b1) g); ``dparam_gap`` the worst leaf's gap between the norms of the
parameters' change after the three steps.  A leaf's gap is taken against
the reference's norm of that leaf or of the median leaf, whichever is
larger, over the leaves whose reference gradient is not nought
(``learn.moving_leaves``).  ``start_gap`` is the largest difference
between the parameters the port started from and the benchmark's
weights.  ``prio_gap`` is the widest gap between the first step's
priorities and the reference's, over the reference's largest (on the
ring the port's are read back from the leaves the step wrote, where a
leaf drawn twice keeps its last row's).  Read but not limited:
``loss_gap`` itself, ``loss3_gap`` (the worst of the three steps) and
the median leaf's gaps.

On the device ring the port draws its own batches: ``bad_draws`` counts
the drawn leaves that are not the stratified draw of the uniforms over
the leaf masses the step saw, and the reference gathers each batch from
copies of the drawn slots.

Acting (a seeded sample of the actors' first acts, through the port's
fused LSTM kernel): ``act_q_gap`` and ``act_h_gap`` are the norms of the
differences of q and of the new recurrent state from the reference's
single step, over the norms of the reference's, taken over every lane
of every sampled act (``act_q_widest`` and ``act_h_widest``, the largest
single differences over the largest magnitude, are read too);
``act_params_gap`` the largest difference between the parameters the
acts used and the benchmark's weights (every sampled act runs before the
first update)."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from gpu_bench.reference import learn, network, per
from gpu_bench.reference.precision import Ops, strict_f32


def _max_diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
              ) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b)


def program_side(cap, hyper: dict) -> Dict[str, Any]:
    """The port's losses, first step's priorities, first clipped gradient
    and change after three steps, as the check compares them."""
    b1 = 0.9
    c1 = float(np.float32(1.0 - b1))
    first = cap.steps[0]
    if "priorities" in first:
        prios = first["priorities"]
    else:
        prios = first["leaves_after"] ** (1.0 / hyper["prio_exponent"])
    return dict(
        losses=[float(s["loss"]) for s in cap.steps],
        priorities=[prios.float()],
        first_grad={k: v / c1 for k, v in cap.mu1.items()},
        change={k: cap.p3[k] - cap.p0[k] for k in cap.p0})


def feedback_rows(cap) -> torch.Tensor:
    """For each row of the first batch, the row whose priority the port
    keeps: itself, or on the ring the last row that drew the same leaf."""
    first = cap.steps[0]
    if "idx" not in first:
        p = first["priorities"]
        return torch.arange(p.shape[0], device=p.device)
    return per.last_rows(first["idx"])


def reference_batches(cap, hyper: dict) -> Tuple[List[dict], int]:
    """The batches the port's first steps trained on (host-staged: as
    staged; device ring: gathered here from the drawn slots), and how many
    drawn leaves were not the draw of the step's uniforms."""
    batches, bad = [], 0
    for s in cap.steps:
        if "batch" in s:
            batches.append(s["batch"])
            continue
        idx = s["idx"]
        bad += per.bad_draws(s["prios"], s["u"], idx)
        K = hyper["seqs_per_block"]
        seq = idx % K
        block = s["blocks"][s["slot"]]
        batches.append(per.gather(
            s["slots"], s["slot"], seq, s["seq_meta"][block, seq],
            s["first"][block],
            per.is_weights(s["prios"], idx,
                           hyper["importance_sampling_exponent"]),
            hyper["seq_len"], hyper["learning_steps"],
            hyper["block_length"]))
    return batches, bad


def _padded(p: torch.Tensor, n: int) -> torch.Tensor:
    """``p`` with zeros for the rows a step left out."""
    return torch.cat([p.float(), p.new_zeros(n - p.shape[0]).float()])


def training_gaps(side: Dict[str, Any], ref: Dict[str, Any], keep: set,
                  rows: torch.Tensor) -> Dict[str, float]:
    steps = [abs(a - b) / abs(b)
             for a, b in zip(side["losses"], ref["losses"])]
    p_ref = ref["priorities"][0][rows]
    p_side = _padded(side["priorities"][0], p_ref.shape[0])[rows]
    out = dict(loss_gap=steps[0], loss3_gap=max(steps),
               prio_gap=float((p_side - p_ref).abs().max()
                              / p_ref.abs().max()))
    for name, key in (("grad", "first_grad"), ("dparam", "change")):
        gaps = sorted(learn.leaf_gaps(side[key], ref[key], keep).values())
        out[f"{name}_gap"] = gaps[-1]
        out[f"{name}_median_gap"] = gaps[len(gaps) // 2]
    return out


def _act_inputs(a: Dict[str, Any], device) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a[k])).to(device)
            for k in ("obs", "last_action", "last_reward", "hidden")]


def act_reference(acts: List[Dict[str, Any]], weights, arch: dict,
                  ops: Ops) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    device = next(iter(weights.values())).device
    with torch.no_grad():
        return [network.act(weights, arch, *_act_inputs(a, device), ops)
                for a in acts]


def act_gaps(side: List[Tuple[torch.Tensor, torch.Tensor]],
             ref: List[Tuple[torch.Tensor, torch.Tensor]]
             ) -> Dict[str, float]:
    def norm(i):
        diff = sum(float(((s[i].float() - r[i]) ** 2).sum())
                   for s, r in zip(side, ref))
        return (diff / sum(float((r[i] ** 2).sum()) for r in ref)) ** 0.5

    def widest(i):
        scale = max(float(r[i].abs().max()) for r in ref)
        return max(float((s[i].float() - r[i]).abs().max())
                   for s, r in zip(side, ref)) / scale

    return dict(act_q_gap=norm(0), act_h_gap=norm(1),
                act_q_widest=widest(0), act_h_widest=widest(1))


def swapped(acts: List[Tuple[torch.Tensor, torch.Tensor]]
            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """A planted fault: each act's answer for lane 0 is lane 1's."""
    out = []
    for q, h in acts:
        q, h = q.clone(), h.clone()
        q[0], h[0] = q[1].clone(), h[1].clone()
        out.append((q, h))
    return out


def readings(cap, weights, arch: dict, hyper: dict, rows: int,
             extra: bool = False) -> Dict[str, Any]:
    """Every number compared, and with ``extra`` the control's and the
    planted faults' readings of them (``control``, ``half_batch``,
    ``swapped_act``)."""
    device = next(iter(weights.values())).device
    strict_f32()
    out: Dict[str, float] = {}
    out["start_gap"] = max(_max_diff(cap.p0, weights),
                           _max_diff(cap.target0, weights))
    batches, bad = reference_batches(cap, hyper)
    if any("idx" in s for s in cap.steps):
        out["bad_draws"] = float(bad)
    f32 = Ops("f32")
    ref = learn.follow(weights, arch, hyper, batches, f32, rows)
    keep = learn.moving_leaves(ref["first_grad"])
    side = program_side(cap, hyper)
    rows_kept = feedback_rows(cap)
    out.update(training_gaps(side, ref, keep, rows_kept))
    act_side = [(torch.from_numpy(a["q"]).to(device),
                 torch.from_numpy(a["new_hidden"]).to(device))
                for a in cap.acts]
    act_ref = act_reference(cap.acts, weights, arch, f32)
    out.update(act_gaps(act_side, act_ref))
    out["act_params_gap"] = max(
        (_max_diff(a["params"], weights) for a in cap.acts), default=0.0)
    worst = dict(losses=[side["losses"], ref["losses"]])
    for name, key in (("grad_gap", "first_grad"), ("dparam_gap", "change")):
        gaps = learn.leaf_gaps(side[key], ref[key], keep)
        leaf = max(gaps, key=gaps.get)
        worst[name] = [leaf, gaps[leaf]]
    result: Dict[str, Any] = dict(numbers=out, worst=worst,
                                  leaves_left_out=sorted(set(weights) - keep))
    if extra:
        fp8 = Ops("fp8")
        ctl = learn.follow(weights, arch, hyper, batches, fp8, rows)
        control = training_gaps(ctl, ref, keep, rows_kept)
        control.update(act_gaps(act_reference(cap.acts, weights, arch, fp8),
                                act_ref))
        half = learn.follow(weights, arch, hyper, batches, f32, rows,
                            half=True)
        result.update(control=control,
                      half_batch=training_gaps(half, ref, keep, rows_kept),
                      swapped_act=act_gaps(swapped(act_ref), act_ref))
    return result


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each number beside its limit; correct when every limited number is
    at or under its limit and none is missing."""
    table = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        table[name] = dict(value=v, limit=limit)
        if v is None or not np.isfinite(v) or v > limit:
            ok = False
    return ok, table
