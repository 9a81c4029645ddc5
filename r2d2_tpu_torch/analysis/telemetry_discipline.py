"""telemetry-discipline: metric names are literals, not format strings.

The telemetry plane (r2d2_tpu_torch/telemetry) is a *registry*: a metric name
is an identity that dashboards, scrape configs, and greps key on.  An
ad-hoc f-string name in a hot loop (``registry.inc(f"ingest.{src}")``)
silently mints an unbounded family of series — per-entity cardinality
that belongs in a LABEL (``registry.inc("ingest.blocks",
fleet=str(src))``), where the name stays greppable and the label is the
variable part.  It is also an allocation per call in loops the registry
was specifically designed to keep allocation-light.

The check: every call of a metric-writing method — ``inc``,
``counter_max``, ``set_gauge``, ``observe``, ``observe_many``,
``declare_histogram``, ``absorb_histogram`` on a registry-shaped
receiver, plus the Tracer
surface (``span``, ``gauge``, ``incr``) and the cross-process event
tracer's recording surface (``instant``, ``complete`` —
telemetry/tracing.py; variable parts go in ``flow``/``arg``, never the
event name) — must pass the metric/event name as a plain string
literal.
Receivers are matched by name shape (``registry`` / ``metrics`` /
``telemetry`` / ``tracer`` and ``*.registry`` etc.), the same heuristic
family as config-integrity's receivers; bulk absorption helpers
(``absorb_gauges``/``absorb_counters``) take a prefix + mapping and are
exempt by design — they exist to fold fixed upstream surfaces, carry
their own suppression where they synthesize names, and keep hot loops
out of it.

**Alert-rule vocabulary** (telemetry/learnhealth.py): alert rule names
are identities too — an ``alerts.jsonl`` row, a
``learnhealth.alert{rule=...}`` series, and an operator runbook entry
all key on them.  Two extra checks:

- an ``AlertRule(...)`` construction (and ``.fire(...)`` on an
  engine-shaped receiver: ``engine`` / ``alerts`` / ``*_engine`` /
  ``*alert_engine``) must pass the rule name as a string literal;
- an ``AlertRule`` ``threshold=`` keyword must not be a bare numeric
  constant — alert thresholds are operator knobs and belong in cfg
  (``cfg.alert_*``), never inline magic numbers in rule bodies.
"""
from __future__ import annotations

import ast
from typing import List

from r2d2_tpu_torch.analysis.core import Context, Finding, rule

RULE = "telemetry-discipline"

# metric-writing methods whose first argument IS a metric/event name
_METRIC_METHODS = ("inc", "counter_max", "set_gauge", "observe",
                   "observe_many", "declare_histogram",
                   "absorb_histogram", "span", "gauge",
                   "incr", "instant", "complete")

_RECEIVER_NAMES = ("registry", "metrics", "telemetry", "tracer", "reg",
                   "tr", "events")

# alert-engine vocabulary (telemetry/learnhealth.py)
_ALERT_RECEIVER_NAMES = ("engine", "alerts")
_ALERT_THRESHOLD_KWARGS = ("threshold",)


def _is_metric_receiver(node: ast.AST) -> bool:
    """A name that plausibly holds a MetricsRegistry or Tracer."""
    if isinstance(node, ast.Name):
        n = node.id.lower()
    elif isinstance(node, ast.Attribute):
        n = node.attr.lower()
    else:
        return False
    return n in _RECEIVER_NAMES or n.endswith(
        ("registry", "tracer", "_metrics", "telemetry", "_events"))


def _name_arg(call: ast.Call):
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "name":
            return kw.value
    return None


def _is_alert_engine_receiver(node: ast.AST) -> bool:
    """A name that plausibly holds an AlertEngine."""
    if isinstance(node, ast.Name):
        n = node.id.lower()
    elif isinstance(node, ast.Attribute):
        n = node.attr.lower()
    else:
        return False
    return n in _ALERT_RECEIVER_NAMES or n.endswith(
        ("_engine", "alert_engine", "_alerts"))


def _is_alert_rule_ctor(call: ast.Call) -> bool:
    f = call.func
    return ((isinstance(f, ast.Name) and f.id == "AlertRule")
            or (isinstance(f, ast.Attribute) and f.attr == "AlertRule"))


def _is_literal_str(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


@rule(RULE, "metric names passed to the registry/tracer must be string "
            "literals (labels carry the variable part)")
def check_telemetry_discipline(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            # --- alert-rule vocabulary (telemetry/learnhealth.py) ----
            if _is_alert_rule_ctor(node):
                arg = _name_arg(node)
                if arg is not None and not _is_literal_str(arg):
                    findings.append(Finding(
                        RULE, mod.rel, node.lineno,
                        "AlertRule name is not a string literal — rule "
                        "names key alerts.jsonl rows and the "
                        "learnhealth.alert{rule} series "
                        "(telemetry/learnhealth.py)"))
                for kw in node.keywords:
                    if (kw.arg in _ALERT_THRESHOLD_KWARGS
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, (int, float))
                            and not isinstance(kw.value.value, bool)):
                        findings.append(Finding(
                            RULE, mod.rel, node.lineno,
                            "AlertRule threshold is an inline magic "
                            "number — alert thresholds are operator "
                            "knobs and must come from cfg "
                            "(cfg.alert_*)"))
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire"
                    and _is_alert_engine_receiver(node.func.value)):
                arg = _name_arg(node)
                if arg is not None and not _is_literal_str(arg):
                    findings.append(Finding(
                        RULE, mod.rel, node.lineno,
                        "alert rule name for .fire() is not a string "
                        "literal (telemetry/learnhealth.py)"))
                continue
            # --- metric/event name literals --------------------------
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_METHODS
                    and _is_metric_receiver(node.func.value)):
                continue
            arg = _name_arg(node)
            if arg is None:
                continue      # pathological call; runtime will complain
            if _is_literal_str(arg):
                continue
            kind = type(arg).__name__
            detail = ("f-string" if isinstance(arg, ast.JoinedStr)
                      else f"non-literal ({kind})")
            findings.append(Finding(
                RULE, mod.rel, node.lineno,
                f"metric name for .{node.func.attr}() is {detail} — "
                "register a literal name and put the variable part in a "
                "label (telemetry/registry.py)"))
    return findings
