"""What a traced window's ``torch.profiler`` record says about the card:
every operation that ran on it (kernels, copies, sets) with its name,
start and length; the busy time as the union of those intervals; the idle
gaps between them, each named by what the learner's thread — or, where
it was in no span, another thread — was doing on the host; and the
operations that took most time."""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

Op = Tuple[str, int, int]          # (name, start ns, end ns)
TOP = 10


def device_ops(prof, t0_ns: int, t1_ns: int) -> List[Op]:
    """The card's operations that overlap [t0_ns, t1_ns] (wall-clock ns),
    in start order."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b > t0_ns and a < t1_ns:
            out.append((e.name(), a, b))
    out.sort(key=lambda o: o[1])
    return out


def busy_intervals(ops: List[Op], t0_ns: int, t1_ns: int
                   ) -> List[Tuple[int, int]]:
    """The union of the operations' intervals within [t0_ns, t1_ns]."""
    merged: List[List[int]] = []
    for _, a, b in ops:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(ops: List[Op], t0_ns: int, t1_ns: int) -> float:
    return sum(b - a for a, b in busy_intervals(ops, t0_ns, t1_ns)) / 1e9


def top_ops(ops: List[Op], t0_ns: int, t1_ns: int) -> List[list]:
    total: Dict[str, int] = collections.defaultdict(int)
    for name, a, b in ops:
        total[name] += min(b, t1_ns) - max(a, t0_ns)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], ns / 1e9] for name, ns in ranked]


def idle_gaps(ops: List[Op], t0_ns: int, t1_ns: int,
              host_spans: List[Tuple[str, str, int, int]],
              learner_thread: str) -> List[list]:
    """The longest stretches with nothing on the card, each named by the
    innermost host span open at its middle: the learner thread's first,
    then any other thread's, else "host: no span"."""
    edges = ([t0_ns] + [x for iv in busy_intervals(ops, t0_ns, t1_ns)
                         for x in iv] + [t1_ns])
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:TOP]:
        mid = (a + b) // 2
        open_ = [(s, th, sa, sb) for s, th, sa, sb in host_spans
                 if sa <= mid <= sb]
        mine = [s for s in open_ if s[1] == learner_thread]
        pick = mine or open_
        if pick:
            name, th, _, _ = max(pick, key=lambda s: s[2])
            label = name if th == learner_thread else f"{th}: {name}"
        else:
            label = "host: no span"
        out.append([label, (b - a) / 1e9])
    return out


def kernel_ns(ops: List[Op], needle: str, t0_ns: int, t1_ns: int
              ) -> List[int]:
    """Lengths of every operation whose name holds ``needle`` and that
    ran wholly inside [t0_ns, t1_ns]."""
    return [b - a for name, a, b in ops
            if needle in name and a >= t0_ns and b <= t1_ns]
