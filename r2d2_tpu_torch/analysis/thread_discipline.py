"""thread-discipline: no unsupervised threads, no unlocked shared writes.

The fabric's liveness story (utils/supervisor.py) depends on every
long-running loop being Supervisor-managed: a bare ``threading.Thread``
that dies takes its plane down silently — exactly the reference's
fire-and-forget daemons this repo was built to retire.  Two checks:

1. **bare threads** — any ``threading.Thread(...)`` construction outside
   the allowlisted supervisor module is a finding.  Legitimate uses
   (bounded, joined measurement workers; subprocess-local drains) carry a
   per-line ``# graftlint: disable=thread-discipline -- <why safe>``.
2. **shared writes** — inside a thread-target function (a ``target=``
   argument or a ``*_loop``-named function), assigning an attribute of a
   closed-over object without a surrounding ``with <...lock...>:`` is a
   finding: cross-thread state belongs in a Lock-protected structure, a
   Queue, or an Event.  (Heuristic: writes to ``self`` inside methods and
   to function-local objects are exempt.)
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from r2d2_tpu_torch.analysis.core import Context, Finding, dotted_name, rule

RULE = "thread-discipline"

# the supervision framework itself is the one sanctioned Thread site
ALLOWLISTED_SUFFIXES = ("utils/supervisor.py",)

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _thread_calls(tree: ast.AST) -> List[ast.Call]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d in ("threading.Thread", "Thread"):
                out.append(node)
    return out


def _target_functions(tree: ast.AST) -> List[ast.AST]:
    """Functions that run on their own thread: ``target=`` arguments of
    Thread calls plus the ``*_loop`` naming convention."""
    by_name = {n.name: n for n in ast.walk(tree) if isinstance(n, _FuncNode)}
    out: List[ast.AST] = []
    seen: Set[int] = set()

    def add(fn: Optional[ast.AST]) -> None:
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            out.append(fn)

    for call in _thread_calls(tree):
        for kw in call.keywords:
            if kw.arg == "target":
                if isinstance(kw.value, ast.Name):
                    add(by_name.get(kw.value.id))
                elif isinstance(kw.value, ast.Lambda):
                    add(kw.value)
    for name, fn in by_name.items():
        if name.endswith("_loop"):
            add(fn)
    return out


def _local_names(fn: ast.AST) -> Set[str]:
    """Parameters + names assigned inside the function (its own objects —
    writes to their attributes are thread-private)."""
    names: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        names.add(a.arg)
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.For)):
            t = getattr(node, "target", None)
            if isinstance(t, ast.Name):
                names.add(t.id)
        elif isinstance(node, ast.withitem):
            if isinstance(node.optional_vars, ast.Name):
                names.add(node.optional_vars.id)
    return names


def _lockish(expr: ast.AST) -> bool:
    """Does a with-context expression look like a lock acquisition?"""
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name is not None and "lock" in name.lower():
            return True
    return False


def _shared_write_findings(rel: str, fn: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    locals_ = _local_names(fn)

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.With):
            locked_here = locked or any(_lockish(item.context_expr)
                                        for item in node.items)
            for child in node.body:
                visit(child, locked_here)
            return
        if isinstance(node, _FuncNode) and node is not fn:
            return  # nested defs judged on their own if they are targets
        if isinstance(node, (ast.Assign, ast.AugAssign)) and not locked:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id not in locals_
                        and t.value.id != "self"):
                    out.append(Finding(
                        RULE, rel, t.lineno,
                        f"thread target {getattr(fn, 'name', '<lambda>')!r} "
                        f"writes shared attribute {t.value.id}.{t.attr} "
                        "without a lock — use a Lock/Queue/Event or "
                        "suppress with the reason it is single-writer"))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    body = fn.body if isinstance(fn.body, list) else [fn.body]  # Lambda
    for stmt in body:
        visit(stmt, False)
    return out


@rule(RULE, "threads run under the Supervisor (or carry a justified "
            "suppression); thread targets don't write shared state "
            "unlocked")
def check_thread_discipline(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules:
        if any(mod.rel.endswith(sfx) for sfx in ALLOWLISTED_SUFFIXES):
            continue
        for call in _thread_calls(mod.tree):
            findings.append(Finding(
                RULE, mod.rel, call.lineno,
                "bare threading.Thread outside the Supervisor — run the "
                "loop via utils.supervisor.Supervisor.start (restart "
                "budget + health reporting) or suppress with a reason it "
                "is fire-and-forget safe"))
        for fn in _target_functions(mod.tree):
            findings.extend(_shared_write_findings(mod.rel, fn))
    return findings
