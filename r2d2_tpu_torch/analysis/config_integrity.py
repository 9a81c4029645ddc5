"""config-integrity: every ``cfg.X`` resolves, every field earns its keep.

The frozen ``Config`` dataclass is referenced as bare attribute strings
(~50 fields across the tree); a typo'd ``cfg.leraning_steps`` is a
silent ``AttributeError`` at runtime — or worse, a ``getattr`` default
that quietly disables a feature.  Three checks:

1. **resolution** — every attribute access on a config-shaped receiver
   (a name that is or ends with ``cfg``/``config``, or ``*.cfg``), every
   ``getattr(cfg, "X")`` string, and every keyword of ``cfg.replace(...)``
   must name a real Config field / property / method.
2. **liveness** — every declared field must be referenced somewhere in
   the analyzed tree outside ``config.py`` itself (dead knobs rot).
3. **mention** — every field must appear (word-boundary) in the CLI
   module, README, or a ``docs/*.md`` file, so operators can discover it
   (the knob table in docs/OPERATIONS.md is the canonical home).

Checks 2 and 3 only run when the analyzed set includes the module that
defines ``Config`` (so fixture snippets exercise check 1 alone).
"""
from __future__ import annotations

import ast
import json
import re
from typing import Dict, List, Set, Tuple

from r2d2_tpu_torch.analysis.core import Context, Finding, rule

RULE = "config-integrity"

# attribute names every dataclass instance has; never worth flagging
_DATACLASS_ATTRS = {"replace", "__post_init__", "__dataclass_fields__"}

# --- population_spec JSON validation (league/, docs/LEAGUE.md) ---------
# Inline population specs (a string literal bound to a ``population_spec``
# keyword or assignment) are config too: a misspelled member knob must
# fail lint, not silently no-op at 3 a.m.  The member-object vocabulary is
# restated here rather than imported — the analyzer is pure-stdlib AST and
# must not execute repo code; tests/test_torch_analysis.py pins these
# against config.POPULATION_META_KEYS / POPULATION_MEMBER_FIELDS /
# POPULATION_PRESETS so the two can never drift.
_POPULATION_KEY = "population_spec"
_POPULATION_META_KEYS = {"name", "preset"}
_POPULATION_PRESETS = {"default", "low_resource"}
_POPULATION_MEMBER_FIELDS = {
    "game_name", "seed", "base_eps", "eps_alpha",
    "gamma", "max_episode_steps", "actor_update_interval",
    "test_epsilon", "eval_episodes", "noop_max",
}


def _population_spec_literals(tree: ast.AST):
    """(spec string, line) for every inline ``population_spec`` literal:
    keyword arguments (``Config(population_spec="[...]")``, ``replace``/
    preset kwargs) and plain assignments.  Specs built dynamically or
    passed through variables are runtime-validation territory
    (config.parse_population)."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.keyword)
                and node.arg == _POPULATION_KEY
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            yield node.value.value, node.value.lineno
        elif isinstance(node, ast.Assign):
            if (any(isinstance(t, ast.Name) and t.id == _POPULATION_KEY
                    for t in node.targets)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                yield node.value.value, node.value.lineno


def _check_population_spec(spec: str, fields: Set[str], rel: str,
                           line: int) -> List[Finding]:
    """Validate one inline spec against the Config schema — the lint
    twin of ``config.parse_population`` (structure + key resolution;
    value-range checks stay runtime-only)."""
    out: List[Finding] = []
    if not spec:
        return out   # "" = population disabled, the default
    try:
        raw = json.loads(spec)
    except ValueError as e:
        return [Finding(RULE, rel, line,
                        f"population_spec literal is not valid JSON "
                        f"({e})")]
    if not isinstance(raw, list):
        return [Finding(RULE, rel, line,
                        "population_spec must be a JSON list of member "
                        "objects")]
    for i, m in enumerate(raw):
        if not isinstance(m, dict):
            out.append(Finding(RULE, rel, line,
                               f"population member {i} is not a JSON "
                               "object"))
            continue
        preset = m.get("preset", "default")
        if preset not in _POPULATION_PRESETS:
            out.append(Finding(
                RULE, rel, line,
                f"population member {i}: unknown preset {preset!r} "
                f"(expected one of {sorted(_POPULATION_PRESETS)})"))
        for k in m:
            if k in _POPULATION_META_KEYS:
                continue
            if k not in fields:
                out.append(Finding(
                    RULE, rel, line,
                    f"population member {i} key {k!r} does not resolve "
                    "to a Config field (typo or removed knob?)"))
            elif k not in _POPULATION_MEMBER_FIELDS:
                out.append(Finding(
                    RULE, rel, line,
                    f"population member {i} key {k!r} is not "
                    "population-overridable (members share the "
                    "learner's network/replay geometry — see "
                    "config.POPULATION_MEMBER_FIELDS)"))
    return out


def _is_config_receiver(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        n = node.id.lower()
        return n in ("cfg", "config") or n.endswith("cfg") \
            or n.endswith("_config")
    if isinstance(node, ast.Attribute):
        a = node.attr.lower()
        return a == "cfg" or a.endswith("_cfg")
    return False


def _config_attr_uses(tree: ast.AST) -> List[Tuple[str, int, str]]:
    """(field, line, kind) for every config-shaped reference."""
    uses: List[Tuple[str, int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and _is_config_receiver(
                node.value):
            uses.append((node.attr, node.lineno, "attribute"))
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id == "getattr"
                    and len(node.args) >= 2
                    and _is_config_receiver(node.args[0])
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                uses.append((node.args[1].value, node.lineno, "getattr"))
            elif (isinstance(f, ast.Attribute) and f.attr == "replace"
                    and _is_config_receiver(f.value)):
                for kw in node.keywords:
                    if kw.arg is not None:
                        uses.append((kw.arg, node.lineno, "replace kwarg"))
    return uses


@rule(RULE, "cfg.X references resolve to real Config fields; every field "
            "is referenced and documented")
def check_config_integrity(ctx: Context) -> List[Finding]:
    schema = ctx.config_schema
    if schema is None:
        return []
    findings: List[Finding] = []
    valid = schema.valid_attrs | _DATACLASS_ATTRS
    referenced: Set[str] = set()
    # loose reference census for the liveness check: ANY attribute access
    # or string literal naming a field counts (receivers are heuristic;
    # liveness must not produce false "dead field" findings because a
    # config travelled under an unusual name)
    loose_attr: Dict[str, int] = {}

    analyzed_has_config = False
    for mod in ctx.modules:
        is_config_mod = (mod.rel == schema.module_rel)
        analyzed_has_config = analyzed_has_config or is_config_mod
        for name, line, kind in _config_attr_uses(mod.tree):
            if not is_config_mod:
                referenced.add(name)
            if name.startswith("__") or name in valid:
                continue
            findings.append(Finding(
                RULE, mod.rel, line,
                f"{kind} {name!r} does not resolve to a Config "
                "field/property (typo or removed knob?)"))
        # inline population specs validate against the same schema —
        # a misspelled member knob is a finding, not a silent no-op
        # (config.py itself is exempt: POPULATION_PRESETS et al. are
        # the vocabulary's definition site, not a user spec)
        if not is_config_mod:
            for spec, line in _population_spec_literals(mod.tree):
                findings.extend(_check_population_spec(
                    spec, schema.fields, mod.rel, line))
        if is_config_mod:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute):
                loose_attr[node.attr] = loose_attr.get(node.attr, 0) + 1
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and node.value in schema.fields):
                referenced.add(node.value)
            elif isinstance(node, ast.keyword) and node.arg is not None:
                # preset/test kwargs (test_config(burn_in_steps=...))
                # count as live uses of the knob
                if node.arg in schema.fields:
                    referenced.add(node.arg)

    if not analyzed_has_config:
        return findings

    docs = "\n".join(ctx.doc_texts())
    for field in sorted(schema.fields):
        line = schema.field_lines.get(field, 1)
        if field not in referenced and loose_attr.get(field, 0) == 0:
            findings.append(Finding(
                RULE, schema.module_rel, line,
                f"Config field {field!r} is never referenced outside "
                "config.py (dead knob — delete it or wire it up)"))
        if not re.search(rf"\b{re.escape(field)}\b", docs):
            findings.append(Finding(
                RULE, schema.module_rel, line,
                f"Config field {field!r} has no CLI/docs mention (add it "
                "to the docs/OPERATIONS.md knob table)"))
    return findings
