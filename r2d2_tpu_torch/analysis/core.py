"""graftlint core: the rule framework behind ``python -m r2d2_tpu_torch.analysis``.

Port of ``r2d2_tpu/analysis/core.py``.  Repo-native AST static analysis
(no third-party deps, no torch or JAX import, no device — this module is
importable on a host with neither): a registry of *rule families*, each a
function from an :class:`Context` (the parsed module set plus repo-level
metadata such as the ``Config`` field table) to a list of
:class:`Finding`\\ s.  The driver filters findings through per-line
suppressions and renders human or JSON output.

Why in-repo instead of flake8 plugins: every rule here checks an invariant
*of this codebase* — ``cfg.X`` resolution against our frozen dataclass,
thread discipline against our Supervisor, wire-format single-sourcing
against ``replay/block.py``.  Generic linters cannot see any of that.

Suppression syntax (per line, with an optional reason after ``--``), the
same comment form in both packages::

    thread = threading.Thread(...)  # graftlint: disable=thread-discipline -- joined 3 lines down

Multiple rules separate with commas; ``disable=all`` silences every rule
for that line.  Suppressed findings are still counted and reported (so a
suppression can never rot invisibly).

Adding a rule: write ``@rule("my-family", "one-line doc") def check(ctx):
...`` in a module under ``r2d2_tpu_torch/analysis/`` and import it from
``__init__``.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set

SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([\w,\-]+)(?:\s*--\s*(.+))?")

# rel-path suffixes never analyzed (generated / vendored would go here)
SKIP_PARTS = ("__pycache__",)

# the port's Config, the fallback schema when config.py is not analyzed
CONFIG_REL = "r2d2_tpu_torch/config.py"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # root-relative, forward slashes
    line: int
    message: str
    # the "-- reason" text of the matching suppression comment; set only
    # on suppressed findings (baseline files record it per suppression)
    reason: Optional[str] = None

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Module:
    """One parsed source file: AST + per-line suppression table."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        # suppressions come from genuine COMMENT tokens only — a
        # "# graftlint: disable=..." inside a string literal or docstring
        # (e.g. a pasted doc example) must never silence a real finding
        self.suppressions: Dict[int, Set[str]] = {}
        self.suppress_reasons: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = SUPPRESS_RE.search(tok.string)
                if m:
                    self.suppressions[tok.start[0]] = {
                        r.strip() for r in m.group(1).split(",")
                        if r.strip()}
                    if m.group(2):
                        self.suppress_reasons[tok.start[0]] = \
                            m.group(2).strip()
        except tokenize.TokenError:  # ast.parse above accepted it; keep
            pass                     # whatever comments tokenized cleanly

    def suppressed(self, rule_name: str, line: int) -> bool:
        rules = self.suppressions.get(line)
        return rules is not None and (rule_name in rules or "all" in rules)

    def suppress_reason(self, line: int) -> Optional[str]:
        return self.suppress_reasons.get(line)


@dataclasses.dataclass
class Rule:
    name: str
    doc: str
    check: Callable[["Context"], List[Finding]]


RULES: Dict[str, Rule] = {}


def rule(name: str, doc: str):
    """Register a rule family: ``check(ctx) -> [Finding, ...]``."""
    def deco(fn):
        RULES[name] = Rule(name, doc, fn)
        return fn
    return deco


class ConfigSchema:
    """The ``Config`` dataclass field table, parsed from its AST (never
    imported — the analyzer must run without jax on the path)."""

    def __init__(self, fields: Sequence[str], properties: Sequence[str] = (),
                 methods: Sequence[str] = (), module_rel: str = "",
                 field_lines: Optional[Dict[str, int]] = None):
        self.fields = set(fields)
        self.properties = set(properties)
        self.methods = set(methods)
        self.module_rel = module_rel
        self.field_lines = dict(field_lines or {})

    @property
    def valid_attrs(self) -> Set[str]:
        return self.fields | self.properties | self.methods

    @classmethod
    def from_module(cls, mod: Module) -> Optional["ConfigSchema"]:
        for node in mod.tree.body:
            if not (isinstance(node, ast.ClassDef) and node.name == "Config"):
                continue
            fields, props, methods, lines = [], [], [], {}
            for item in node.body:
                if (isinstance(item, ast.AnnAssign)
                        and isinstance(item.target, ast.Name)):
                    fields.append(item.target.id)
                    lines[item.target.id] = item.lineno
                elif isinstance(item, ast.FunctionDef):
                    decs = {dotted_name(d) for d in item.decorator_list}
                    (props if "property" in decs else methods).append(
                        item.name)
            return cls(fields, props, methods, mod.rel, lines)
        return None


class Context:
    """What every rule sees: the parsed modules plus repo metadata."""

    def __init__(self, modules: Sequence[Module], root: Path,
                 config_schema: Optional[ConfigSchema] = None):
        self.modules = list(modules)
        self.root = root
        if config_schema is None:
            for mod in self.modules:
                config_schema = ConfigSchema.from_module(mod)
                if config_schema is not None:
                    break
        if config_schema is None:
            # targeted run that excludes config.py (e.g. `r2d2-lint-torch
            # some/file.py`): fall back to the port's canonical config so
            # misspelled cfg.X still fails instead of no-opping to a
            # false "clean".  Field-side checks (liveness/docs) stay
            # gated on config.py being IN the analyzed set.
            p = root / CONFIG_REL
            if p.is_file():
                try:
                    config_schema = ConfigSchema.from_module(
                        Module(p, CONFIG_REL,
                               p.read_text(errors="replace")))
                except SyntaxError:
                    pass
        self.config_schema = config_schema

    def doc_texts(self) -> List[str]:
        """Prose the config-integrity mention check searches: the CLI
        module beside the analyzed ``config.py`` (``r2d2_tpu_torch/cli.py``
        for the port's tree, ``r2d2_tpu/cli.py`` for the reference's)
        plus every markdown file under docs/ and the README."""
        texts = []
        pkg = (Path(self.config_schema.module_rel).parent
               if self.config_schema and self.config_schema.module_rel
               else Path(CONFIG_REL).parent)
        for cand in [self.root / pkg / "cli.py",
                     self.root / "README.md"]:
            if cand.is_file():
                texts.append(cand.read_text(errors="replace"))
        docs = self.root / "docs"
        if docs.is_dir():
            for p in sorted(docs.rglob("*.md")):
                texts.append(p.read_text(errors="replace"))
        return texts


@dataclasses.dataclass
class Report:
    findings: List[Finding]          # unsuppressed — these fail the build
    suppressed: List[Finding]        # matched a disable comment
    errors: List[Finding]            # unparseable files
    files: int
    rules: List[str]

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def to_dict(self) -> dict:
        return dict(
            ok=self.ok,
            files=self.files,
            rules=self.rules,
            findings=[f.to_dict() for f in self.findings],
            suppressed=[f.to_dict() for f in self.suppressed],
            errors=[f.to_dict() for f in self.errors],
        )


# ---------------------------------------------------------------- helpers

def dotted_name(node) -> Optional[str]:
    """``a.b.c`` for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*.py")
                if not any(part in SKIP_PARTS for part in f.parts)))
    return out


def load_modules(paths: Sequence[Path], root: Path
                 ) -> tuple[List[Module], List[Finding]]:
    modules, errors = [], []
    for f in iter_py_files(paths):
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            modules.append(Module(f, rel, f.read_text(errors="replace")))
        except SyntaxError as e:
            errors.append(Finding("parse", rel, e.lineno or 0,
                                  f"syntax error: {e.msg}"))
    return modules, errors


def run_analysis(paths: Sequence[str], root: Optional[str] = None,
                 config_schema: Optional[ConfigSchema] = None,
                 rules: Optional[Sequence[str]] = None) -> Report:
    """Run every registered rule over ``paths`` and split the findings
    into live vs suppressed.  ``root`` anchors relative paths and the
    docs lookup (defaults to cwd)."""
    rootp = Path(root) if root is not None else Path.cwd()
    modules, errors = load_modules([Path(p) for p in paths], rootp)
    ctx = Context(modules, rootp, config_schema=config_schema)
    by_rel = {m.rel: m for m in modules}
    live: List[Finding] = []
    quiet: List[Finding] = []
    names = list(rules) if rules is not None else sorted(RULES)
    for name in names:
        for f in RULES[name].check(ctx):
            mod = by_rel.get(f.path)
            if mod is not None and mod.suppressed(f.rule, f.line):
                quiet.append(dataclasses.replace(
                    f, reason=mod.suppress_reason(f.line)))
            else:
                live.append(f)
    live.sort(key=lambda f: (f.path, f.line, f.rule))
    quiet.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings=live, suppressed=quiet, errors=errors,
                  files=len(modules), rules=names)


def analyze_source(source: str, name: str = "fixture.py",
                   config_schema: Optional[ConfigSchema] = None,
                   rules: Optional[Sequence[str]] = None) -> Report:
    """Analyze an in-memory snippet — the test-fixture entry point."""
    mod = Module(Path(name), name, source)
    ctx = Context([mod], Path("."), config_schema=config_schema)
    live: List[Finding] = []
    quiet: List[Finding] = []
    names = list(rules) if rules is not None else sorted(RULES)
    for rn in names:
        for f in RULES[rn].check(ctx):
            if mod.suppressed(f.rule, f.line):
                quiet.append(dataclasses.replace(
                    f, reason=mod.suppress_reason(f.line)))
            else:
                live.append(f)
    return Report(findings=live, suppressed=quiet, errors=[], files=1,
                  rules=names)
