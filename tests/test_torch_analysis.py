"""graftlint over the port (``r2d2_tpu_torch/analysis``) against the
reference analyzer (``r2d2_tpu/analysis``), on the CPU.

- **Fixture parity**: every positive, negative and suppressed fixture of
  the five framework-neutral families (copied from
  ``tests/test_static_analysis.py``) goes through both packages'
  ``analyze_source``; the findings and suppressions must be the same
  ``(rule, line, message, reason)`` once ``r2d2_tpu.`` reads
  ``r2d2_tpu_torch.`` (in the fixture's imports and in the messages).
- **Tree parity**: both analyzers over the reference tree (``r2d2_tpu``,
  ``tools``) give the same findings and suppressions, rule by rule.
  ``wire-format`` is left out: its canonical modules are each package's
  own, so the two disagree by design on the other package's tree.
- **The gate**: zero findings over ``r2d2_tpu_torch`` and exact agreement
  with ``GRAFTLINT_TORCH_BASELINE.json``, every suppression with a reason.
- **Preflight**, the CLI, and importing the analyzer with JAX and the
  reference package blocked.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

import r2d2_tpu.analysis as ref
import r2d2_tpu_torch.analysis as port
from r2d2_tpu_torch.analysis import baseline as port_bl
from r2d2_tpu_torch.analysis.core import Module

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEUTRAL = ("bounded-wait", "config-integrity", "telemetry-discipline",
           "thread-discipline", "wire-format")


def _src(s: str) -> str:
    return textwrap.dedent(s)


def _map(text):
    return None if text is None else text.replace("r2d2_tpu.",
                                                  "r2d2_tpu_torch.")


def _rows(findings, mapped=False):
    return [(f.rule, f.path, f.line, _map(f.message) if mapped else
             f.message, f.reason) for f in findings]


# (name, source, rules, schema kwargs or None, findings, suppressed):
# the counts are what tests/test_static_analysis.py holds, or, where it
# holds only substrings, what the reference gives
_SCHEMA = dict(fields=["lr", "batch_size"], properties=["seq_len"],
               methods=["replace"])
_POP_SCHEMA = dict(fields=["lr", "gamma", "game_name"], properties=[],
                   methods=[])
FIXTURES = [
    ("config-misspelled", """
        def f(cfg):
            a = cfg.lr
            b = cfg.leraning_rate
            c = getattr(cfg, "bogus_knob", None)
            d = cfg.replace(batch_sise=1)
            return a, b, c, d
    """, ["config-integrity"], _SCHEMA, 3, 0),
    ("config-valid", """
        def f(cfg, self_like):
            a = cfg.lr + cfg.seq_len
            b = cfg.replace(lr=1e-3, batch_size=8)
            c = getattr(cfg, "batch_size")
            d = self_like.cfg.lr          # attribute receiver
            e = acfg.batch_size           # *cfg-suffixed receiver
            f2 = other.value              # non-config receiver: ignored
            return a, b, c, d, e, f2
    """, ["config-integrity"], _SCHEMA, 0, 0),
    ("config-suppressed", """
        def f(cfg):
            return cfg.retired_knob  # graftlint: disable=config-integrity -- fixture
    """, ["config-integrity"], _SCHEMA, 0, 1),
    ("config-bad-population", """
        cfg = make(population_spec='[{"name": "a", "gama": 0.9}]')
        population_spec = '[{"preset": "giant"}]'
        c2 = make(population_spec='not json')
        c3 = make(population_spec='[{"lr": 1e-3}]')
    """, ["config-integrity"], _POP_SCHEMA, 4, 0),
    ("config-valid-population", """
        cfg = make(population_spec='[{"name": "a"}, '
                   '{"preset": "low_resource", "gamma": 0.99, '
                   '"game_name": "Pong"}]')
        off = make(population_spec="")
        indirect = make(population_spec=SPEC_VAR)  # runtime territory
    """, ["config-integrity"], _POP_SCHEMA, 0, 0),
    ("suppression-only-from-comments", """
        import threading

        t = threading.Thread(target=f); s = "# graftlint: disable=all"
    """, ["thread-discipline"], None, 1, 0),
    ("thread-bare-and-shared-write", """
        import threading

        def worker_loop():
            shared.counter = shared.counter + 1

        t = threading.Thread(target=worker_loop, daemon=True)
    """, ["thread-discipline"], None, 2, 0),
    ("thread-lambda-target", """
        import threading

        t = threading.Thread(target=lambda: work())
    """, ["thread-discipline"], None, 1, 0),
    ("thread-locked-and-locals", """
        def pump_loop():
            local = Thing()
            local.value = 1          # thread-private: fine
            with state.lock:
                state.value = 2      # lock-held: fine
            queue.put(3)             # queue traffic: fine
    """, ["thread-discipline"], None, 0, 0),
    ("thread-suppressed", """
        import threading

        t = threading.Thread(target=f)  # graftlint: disable=thread-discipline -- bounded, joined below
        t.start(); t.join()
    """, ["thread-discipline"], None, 0, 1),
    ("bounded-unbounded-blocks", """
        import threading

        def ingest_loop(q, ev):
            item = q.get()
            ev.wait()

        def drain(q, t):
            q.get()
            t.join()

        def pumper(q):
            q.get()

        threading.Thread(target=drain)  # graftlint: disable=thread-discipline -- fixture
        sup.start("pump", pumper)
    """, ["bounded-wait"], None, 5, 0),
    ("bounded-timeouts-and-scope", """
        def sample_loop(q, ev, t, d):
            a = q.get(timeout=0.2)
            ev.wait(0.5)
            t.join(5.0)
            b = d.get("key")        # an argument: not an unbounded block
            return a, b

        def plain_helper(q):
            return q.get()          # not a loop / target: out of scope
    """, ["bounded-wait"], None, 0, 0),
    ("bounded-suppressed", """
        def drain_loop(q):
            while True:
                item = q.get()  # graftlint: disable=bounded-wait -- producer guarantees a sentinel on every exit path
                if item is None:
                    return
    """, ["bounded-wait"], None, 0, 1),
    ("wire-restated-crc", """
        import zlib
        from multiprocessing import shared_memory

        def slot_crc(buf):
            return zlib.crc32(buf) & 0xFFFFFFFF
    """, ["wire-format"], None, 3, 0),
    ("wire-importing-module", """
        from multiprocessing import shared_memory
        from r2d2_tpu.replay.block import payload_crc32, slot_layout

        def check(views, seq):
            return payload_crc32((seq,), [views["obs"]])

        def place(spec):
            return slot_layout(spec)
    """, ["wire-format"], None, 0, 0),
    ("wire-non-shm-module", """
        import zlib

        def checksum(b):
            return zlib.crc32(b) & 0xFFFFFFFF
    """, ["wire-format"], None, 0, 0),
    ("wire-shard-rpc", """
        from multiprocessing import shared_memory

        def batch_slot_spec(cfg, action_dim, batch):
            return ()

        def take(views):
            return [views[f] for f in BATCH_ROW_FIELDS]
    """, ["wire-format"], None, 2, 0),
    ("wire-shard-rpc-sanctioned", """
        from multiprocessing import shared_memory
        from r2d2_tpu.replay.block import (
            BATCH_ROW_FIELDS, batch_slot_spec, payload_crc32)

        def crc(views, seq, n):
            return payload_crc32((seq, n),
                                 [views[f][:n] for f in BATCH_ROW_FIELDS])
    """, ["wire-format"], None, 0, 0),
    ("wire-session-socket", """
        import socket
        import zlib

        def session_request_spec(cfg, action_dim):
            return ()

        class FrameReader:
            pass

        def handle(body):
            h, v = decode_frame((), body)
            return zlib.crc32(body) & 0xFFFFFFFF
    """, ["wire-format"], None, 5, 0),
    ("wire-session-sanctioned", """
        import socket
        from r2d2_tpu.serving.wire import (
            FrameReader, decode_frame, encode_frame, peek_kind,
            session_request_spec)

        def handle(sock, body):
            kind = peek_kind(body)
            return decode_frame(session_request_spec(None, 4), body)
    """, ["wire-format"], None, 0, 0),
    ("wire-socket-alone", """
        import socket

        def dial(host, port):
            return socket.create_connection((host, port))
    """, ["wire-format"], None, 0, 0),
    ("wire-net-replay", """
        import socket

        NMSG_INGEST = 18

        def net_ingest_spec(cfg, action_dim):
            return ()

        def route(sock, body):
            return decode_frame(net_sample_response_spec(None, 4, 8),
                                body)
    """, ["wire-format"], None, 4, 0),
    ("wire-net-replay-sanctioned", """
        import socket
        from r2d2_tpu.replay.netwire import (
            NMSG_INGEST, NMSG_PRIO, net_ingest_spec,
            net_sample_response_spec)
        from r2d2_tpu.serving.wire import decode_frame, peek_kind

        def route(body):
            if peek_kind(body) == NMSG_INGEST:
                return decode_frame(net_ingest_spec(None, 4), body)
    """, ["wire-format"], None, 0, 0),
    ("wire-suppressed", """
        import zlib
        from multiprocessing import shared_memory

        def legacy(buf):
            return zlib.crc32(buf)  # graftlint: disable=wire-format -- fixture
    """, ["wire-format"], None, 0, 1),
    ("telemetry-fstring-and-computed", """
        def ingest_loop(registry, tracer, src):
            registry.inc(f"ingest.blocks.{src}")
            registry.set_gauge("fill." + str(src), 1.0)
            tracer.span(make_name(src))
            self.registry.observe(f"lat.{src}", 0.1)
    """, ["telemetry-discipline"], None, 4, 0),
    ("telemetry-literals-and-labels", """
        def ingest_loop(registry, tracer, src):
            registry.inc("ingest.blocks", fleet=str(src))
            registry.counter_max("steps", n)
            tracer.gauge("depth", q.qsize())
            registry.declare_histogram("lat", [1, 2, 4])
            some_set.observe(f"not.{a}.metric")   # not a registry shape
            obj.inc(f"free.{x}")                  # nor this
    """, ["telemetry-discipline"], None, 0, 0),
    ("telemetry-tracing-api", """
        def hot_loop(src, tid):
            EVENTS.instant(f"ingest.{src}", flow=tid)
            EVENTS.complete(make_name(src), t0, 0.1)
            self._events.instant(f"hop.{src}")
    """, ["telemetry-discipline"], None, 3, 0),
    ("telemetry-tracing-literals", """
        def hot_loop(src, tid):
            EVENTS.instant("ingest.block", flow=tid, arg=src)
            EVENTS.complete("fleet.block_send", t0, 0.1, flow=tid)
            registry.observe_many("pipeline.block_age_at_train_s", ages)
            fut.complete(f"not.a.{tracer_like}")   # not an events shape
    """, ["telemetry-discipline"], None, 0, 0),
    ("telemetry-alert-rules", """
        def build(cfg, engine, kind):
            rules = [
                AlertRule(f"rule_{kind}", check=chk),
                AlertRule("loss_spike", check=chk, threshold=10.0),
                learnhealth.AlertRule(name_var, check=chk),
            ]
            engine.fire(f"alert_{kind}")
            self.alert_engine.fire(kind)
    """, ["telemetry-discipline"], None, 5, 0),
    ("telemetry-alert-rules-clean", """
        def build(cfg, engine):
            rules = [
                AlertRule("nonfinite", check=chk),
                AlertRule("dq_drift", check=chk,
                          threshold=cfg.alert_dq_budget),
                AlertRule("replay_ratio", check=chk, threshold=None),
            ]
            engine.fire("nonfinite", value=1.0)
            queue.fire(f"not_an_{engine_like}")   # not an engine shape
    """, ["telemetry-discipline"], None, 0, 0),
    ("telemetry-suppressed", """
        def absorb(registry, mapping, prefix):
            for k, v in mapping.items():
                registry.set_gauge(f"{prefix}.{k}", v)  # graftlint: disable=telemetry-discipline -- fixture
    """, ["telemetry-discipline"], None, 0, 1),
]


@pytest.mark.parametrize(
    "source,rules,schema,n_found,n_quiet",
    [f[1:] for f in FIXTURES], ids=[f[0] for f in FIXTURES])
def test_fixture_parity(source, rules, schema, n_found, n_quiet):
    src = _src(source)
    kw = dict(rules=rules)
    want = ref.analyze_source(
        src, config_schema=ref.ConfigSchema(**schema) if schema else None,
        **kw)
    got = port.analyze_source(
        _map(src),
        config_schema=port.ConfigSchema(**schema) if schema else None, **kw)
    assert _rows(got.findings) == _rows(want.findings, mapped=True)
    assert _rows(got.suppressed) == _rows(want.suppressed, mapped=True)
    assert (len(got.findings), len(got.suppressed)) == (n_found, n_quiet)


def test_schema_fallback_reads_the_ports_config(tmp_path):
    """A targeted run that excludes config.py falls back to
    ``r2d2_tpu_torch/config.py`` under the root, so a misspelled cfg field
    still fails (the field-side checks stay off), as the reference's
    falls back to its own."""
    bad = tmp_path / "mod.py"
    bad.write_text("def f(cfg):\n    return cfg.leraning_steps\n")
    got = port.run_analysis([str(bad)], root=REPO_ROOT,
                            rules=["config-integrity"])
    want = ref.run_analysis([str(bad)], root=REPO_ROOT,
                            rules=["config-integrity"])
    assert len(got.findings) == 1
    assert "leraning_steps" in got.findings[0].message
    assert _rows(got.findings) == _rows(want.findings)


def test_config_schema_and_population_vocabulary_match_the_port():
    """The port's Config parses to the reference's field table, and the
    population vocabulary the rule restates is the port config's own."""
    import pathlib

    from r2d2_tpu.analysis.core import Module as RefModule
    from r2d2_tpu_torch import config as pcfg
    from r2d2_tpu_torch.analysis import config_integrity as ci

    root = pathlib.Path(REPO_ROOT)
    mine = port.ConfigSchema.from_module(Module(
        root / "r2d2_tpu_torch/config.py", "r2d2_tpu_torch/config.py",
        (root / "r2d2_tpu_torch/config.py").read_text()))
    theirs = ref.ConfigSchema.from_module(RefModule(
        root / "r2d2_tpu/config.py", "r2d2_tpu/config.py",
        (root / "r2d2_tpu/config.py").read_text()))
    assert mine.fields == theirs.fields and len(mine.fields) > 40
    assert {"seq_len", "num_blocks", "stored_obs_shape"} <= mine.properties
    assert ci._POPULATION_META_KEYS == set(pcfg.POPULATION_META_KEYS)
    assert ci._POPULATION_MEMBER_FIELDS == set(pcfg.POPULATION_MEMBER_FIELDS)
    assert ci._POPULATION_PRESETS == set(pcfg.POPULATION_PRESETS)


def test_wire_vocabulary_exists_in_the_ports_modules():
    """Every name the wire-format rule guards is defined in the port's
    canonical module it names."""
    import importlib

    from r2d2_tpu_torch.analysis import wire_format as wf

    for module, _suffix, names in wf._VOCABULARIES:
        assert module.startswith("r2d2_tpu_torch.")
        mod = importlib.import_module(module)
        missing = sorted(n for n in names if not hasattr(mod, n))
        assert not missing, f"{module} lacks {missing}"


@pytest.fixture(scope="module")
def reference_tree_reports():
    """Both analyzers over the reference tree, the four families whose
    verdict does not depend on which package's modules are canonical."""
    rules = ["bounded-wait", "config-integrity", "telemetry-discipline",
             "thread-discipline"]
    paths = [os.path.join(REPO_ROOT, "r2d2_tpu"),
             os.path.join(REPO_ROOT, "tools")]
    return (ref.run_analysis(paths, root=REPO_ROOT, rules=rules),
            port.run_analysis(paths, root=REPO_ROOT, rules=rules))


@pytest.mark.parametrize("rule", ["bounded-wait", "config-integrity",
                                  "telemetry-discipline",
                                  "thread-discipline"])
def test_tree_parity_on_the_reference_tree(reference_tree_reports, rule):
    want, got = reference_tree_reports
    assert got.files == want.files and not got.errors

    def pick(fs):
        return [r for r in _rows(fs) if r[0] == rule]

    assert pick(got.findings) == pick(want.findings)
    assert pick(got.suppressed) == pick(want.suppressed)


def test_tree_parity_baseline_snapshots(reference_tree_reports):
    """The two packages' baseline snapshots of the same report agree (the
    file format is shared)."""
    from r2d2_tpu.analysis import baseline as ref_bl

    want, got = reference_tree_reports
    assert port_bl.snapshot(got) == ref_bl.snapshot(want)
    assert got.suppressed, "the reference tree carries suppressions"


def test_port_tree_is_clean():
    """The port's gate: zero unsuppressed findings over
    ``r2d2_tpu_torch`` with every neutral family, exact agreement with
    GRAFTLINT_TORCH_BASELINE.json, and a written reason on every
    suppression."""
    report = port.run_analysis([os.path.join(REPO_ROOT, "r2d2_tpu_torch")],
                               root=REPO_ROOT)
    assert sorted(report.rules) == sorted(NEUTRAL)
    assert report.errors == []
    assert report.findings == [], "\n".join(
        f.format() for f in report.findings)
    pinned = port_bl.load(os.path.join(REPO_ROOT,
                                       "GRAFTLINT_TORCH_BASELINE.json"))
    assert port_bl.diff(pinned, report) == []
    assert pinned["findings"] == []
    for s in pinned["suppressions"]:
        assert s["reasons"], f"reasonless suppression pinned: {s}"
    for f in report.suppressed:
        assert f.reason, f"reasonless suppression: {f.format()}"


def test_cli_baseline_and_seeded_violation(tmp_path):
    """``python -m r2d2_tpu_torch.analysis --baseline ...`` exits 0 on the
    tree; a seeded restated CRC in an shm module exits 1 with a
    wire-format finding naming the port's module."""
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.analysis",
         "--baseline", "GRAFTLINT_TORCH_BASELINE.json"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 drift line(s)" in proc.stdout
    bad = tmp_path / "bad_transport.py"
    bad.write_text(_src("""
        import zlib
        from multiprocessing import shared_memory

        def my_crc(buf):
            return zlib.crc32(buf) & 0xFFFFFFFF

        def place(spec):
            return slot_layout(spec)
    """))
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.analysis", str(bad),
         "--json"], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1
    report = json.loads(proc.stdout)
    msgs = [f["message"] for f in report["findings"]
            if f["rule"] == "wire-format"]
    assert len(msgs) == 3
    assert any("r2d2_tpu_torch.replay.block" in m for m in msgs)


def test_list_rules_is_the_neutral_families():
    assert sorted(port.RULES) == sorted(NEUTRAL)
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.analysis", "--list-rules"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    assert [ln.split(":")[0] for ln in proc.stdout.splitlines()] == sorted(
        NEUTRAL)


@pytest.fixture
def tree_on_path(monkeypatch):
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH",
                       REPO_ROOT + (os.pathsep + path if path else ""))


def test_preflight_exits_with_the_report_on_a_dirty_tree(
        tmp_path, tree_on_path, capsys):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(_src("""
        import threading

        threading.Thread(target=print).start()
    """))
    with pytest.raises(SystemExit) as e:
        port.preflight(str(tmp_path), paths=("pkg",))
    assert "graftlint preflight failed" in str(e.value.code)
    err = json.loads(capsys.readouterr().err)
    assert [f["rule"] for f in err["findings"]] == ["thread-discipline"]
    assert err["findings"][0]["path"] == "pkg/mod.py"


def test_preflight_returns_on_a_clean_tree(tmp_path, tree_on_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(_src("""
        import threading

        t = threading.Thread(target=print)  # graftlint: disable=thread-discipline -- joined below
        t.start()
        t.join(1.0)
    """))
    assert port.preflight(str(tmp_path), paths=("pkg",)) is None
    assert port.preflight(REPO_ROOT) is None


def test_analyzer_imports_without_jax_or_the_reference():
    """The card's machine has no JAX: the analyzer, its CLI and the two
    tools import with ``jax`` and ``r2d2_tpu`` blocked, and the analyzer
    pulls in neither torch nor numpy."""
    code = _src("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "r2d2_tpu"):
            sys.modules[name] = None
        from r2d2_tpu_torch.analysis import run_analysis
        from r2d2_tpu_torch.analysis.__main__ import main
        r = run_analysis(["r2d2_tpu_torch"])
        assert r.ok and r.files > 50, r.findings
        assert "torch" not in sys.modules and "numpy" not in sys.modules
        from r2d2_tpu_torch.tools import r2d2_top
        assert "torch" not in sys.modules
        from r2d2_tpu_torch.tools import soak
        print("ok", r.files)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
