"""bounded-wait: no unbounded blocking waits inside supervised loops.

The degraded-mode resilience layer (utils/resilience.py, ISSUE 7) exists
because a single unbounded wait can wedge a whole plane: a fleet blocked
forever on a response queue, a fabric loop parked on ``Event.wait()``
that nothing will ever set, a ``join()`` on a thread that cannot exit.
Every supervised loop in this repo is written against the stop-predicate
discipline — *poll with a timeout, check ``stop()``, repeat* — and this
rule keeps it that way:

Inside a **thread-target function** (a ``target=`` argument of a
``threading.Thread`` call), a function handed to ``Supervisor.start(
"name", fn)``, or any function named ``*_loop`` (the fabric loop
convention), a call of the form ``X.get()``, ``X.wait()`` or
``X.join()`` with **no arguments and no ``timeout=`` keyword** is a
finding.  ``q.get(timeout=0.2)``, ``ev.wait(0.5)``, ``t.join(5.0)`` and
``d.get("key")`` (an argument ≠ an unbounded block) all pass.

Intentionally unbounded waits — e.g. a sentinel-driven consumer whose
producer is *guaranteed* to deliver the sentinel on every exit path —
carry a per-line ``# graftlint: disable=bounded-wait -- <why the wake-up
is guaranteed>`` so the review decision stays visible and counted.
"""
from __future__ import annotations

import ast
from typing import List

from r2d2_tpu_torch.analysis.core import Context, Finding, rule
from r2d2_tpu_torch.analysis.thread_discipline import _target_functions

RULE = "bounded-wait"

_BLOCKING_ATTRS = ("get", "wait", "join")

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _supervised_functions(tree: ast.AST) -> List[ast.AST]:
    """Functions handed to the Supervisor by name:
    ``<anything>.start("thread-name", fn)`` — the repo's one way of
    launching a fabric loop (utils/supervisor.py)."""
    by_name = {n.name: n for n in ast.walk(tree) if isinstance(n, _FuncNode)}
    out: List[ast.AST] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "start"
                and len(node.args) == 2
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and isinstance(node.args[1], ast.Name)):
            continue
        fn = by_name.get(node.args[1].id)
        if fn is not None:
            out.append(fn)
    return out


def _unbounded_wait_calls(fn: ast.AST) -> List[ast.Call]:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _BLOCKING_ATTRS):
            continue
        if node.args:
            continue   # a positional arg is a timeout (or a dict key)
        if any(kw.arg == "timeout" for kw in node.keywords):
            continue
        out.append(node)
    return out


@rule(RULE, "supervised *_loop functions and thread targets only block "
            "with a timeout (get/wait/join need timeout= or a justified "
            "suppression)")
def check_bounded_wait(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules:
        fns = list(_target_functions(mod.tree))
        seen = {id(f) for f in fns}
        fns += [f for f in _supervised_functions(mod.tree)
                if id(f) not in seen]
        for fn in fns:
            name = getattr(fn, "name", "<lambda>")
            for call in _unbounded_wait_calls(fn):
                attr = call.func.attr
                findings.append(Finding(
                    RULE, mod.rel, call.lineno,
                    f"supervised loop {name!r} blocks on .{attr}() with "
                    "no timeout — an unbounded wait wedges the plane if "
                    "the wake-up never comes; pass timeout= and poll the "
                    "stop predicate (utils/resilience.Deadline composes "
                    "budgets), or suppress with the reason the wake-up "
                    "is guaranteed"))
    return findings
