"""graftlint over the port (``python -m r2d2_tpu_torch.analysis``).

Port of ``r2d2_tpu/analysis``: the framework-neutral rule families,
checking the invariants of ``r2d2_tpu_torch/`` itself:

- ``config-integrity``     cfg.X resolution + field liveness/docs
- ``thread-discipline``    Supervisor-managed threads, locked shared writes
- ``bounded-wait``         supervised loops / thread targets never block
  without a timeout (get/wait/join need timeout=)
- ``wire-format``          shm slot layout / CRC single-sourced in
  replay/block, the session frames in serving/wire, the net replay
  frames in replay/netwire
- ``telemetry-discipline`` metric, event and alert-rule names are
  registered literals, not f-strings (the variable part belongs in a
  label); pure receiver-name matching on the registry, tracer and
  learnhealth surfaces, which the port shares with the reference

Not ported, and why: the reference's three JAX families check what the
port does not have.  ``jit-purity`` (host effects inside jit-traced
code) and ``donation-discipline`` (buffer-donation contracts) have
nothing to read: the port traces no function and donates no buffer.
``transfer-flow`` (implicit device<->host transfers outside jit) is
guarded at run time instead: ``utils/trace.py:TransferGuard`` puts the
hot windows under ``torch.cuda.set_sync_debug_mode("error")``.

Importing this package registers every rule.  The analyzer is pure
stdlib ``ast``: the package imports neither torch nor JAX, and
``r2d2_tpu_torch/__init__.py`` imports nothing heavy, so it runs on a
host with neither installed, in milliseconds.
"""
from r2d2_tpu_torch.analysis.core import (  # noqa: F401
    RULES,
    ConfigSchema,
    Context,
    Finding,
    Report,
    analyze_source,
    rule,
    run_analysis,
)
from r2d2_tpu_torch.analysis import (  # noqa: F401  (import = rule registration)
    bounded_wait,
    config_integrity,
    telemetry_discipline,
    thread_discipline,
    wire_format,
)


def main(argv=None) -> int:
    """Console entry (pyproject ``r2d2-lint-torch``); same driver as
    ``python -m r2d2_tpu_torch.analysis``."""
    from r2d2_tpu_torch.analysis.__main__ import main as _main

    return _main(argv)


def preflight(root, paths=("r2d2_tpu_torch",)) -> None:
    """Shared fail-fast gate for the port's long-running tools
    (``tools/soak.py``, ``tools/chaos_soak.py``): run the analyzer CLI as
    a bounded subprocess over ``paths`` and ``sys.exit`` with its report
    if the tree is dirty — a multi-minute soak must not burn its wall
    budget proving what the analyzer knows up front (misspelled cfg
    fields, unsupervised threads, restated shm CRC literals)."""
    import subprocess
    import sys

    try:
        proc = subprocess.run(
            [sys.executable, "-m", "r2d2_tpu_torch.analysis", *paths,
             "--json"],
            cwd=root, capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired:
        # genuinely bounded: a wedged interpreter start-up (hung
        # filesystem) must fail the preflight, not park the soak forever
        # before its own watchdogs exist
        sys.exit("graftlint preflight timed out after 120 s — the "
                 "analyzer child never finished; fix the host before "
                 "burning a soak budget")
    if proc.returncode != 0:
        print(proc.stdout or proc.stderr, file=sys.stderr)
        sys.exit("graftlint preflight failed — fix the findings above "
                 "before burning a soak budget")
