"""Chaos soak: repeated kill/resume cycles under continuous fault
injection.

Port of ``tools/chaos_soak.py``, every mode, with the per-round and
soak-level invariants listed below.  The fast per-failure-mode assertions
are the tests; this is the endurance version for local soaks before a
release.  It runs on the CUDA device (``--device cpu`` runs it on the
CPU, acting included).

Each round runs the threaded fabric with a chaos spec armed (fleet
kills + slab garbling on the process transport, learner freezes, a
truncated checkpoint save), ends it with a drain-then-save stop, then
resumes from the full-state snapshot and VERIFIES the warm restart:
replay mass/size match the snapshot meta, the learner state restores,
and training keeps advancing.  Exit code 1 on any violated invariant.

Run:  python -m r2d2_tpu_torch.tools.chaos_soak [minutes] [--process]
          [--serve] [--anakin] [--shards] [--nethost] [--trace]
          [--sessions] [--league] [--out OUT.json] [--device {cuda,cpu}]

``--process`` soaks the subprocess actor plane (enables the kill_fleet /
garble_block sites); ``--serve`` additionally routes acting through the
centralized InferenceService (implies --process — the kill_fleet site
then also drills the respawn path's server-hidden zeroing, and the
degraded-mode sites are armed: ``freeze_service`` forces a full
freeze→circuit-open→local-fallback→re-attach cycle every round, with
``drop_act_response`` / ``garble_act_response`` / ``stall_pump`` noise
on top; a round fails if any fleet's circuit is still open at exit or
if the freeze produced fleet deaths).  ``--anakin`` soaks the fused
on-device loop with ``wedge_dispatch`` armed against a tight
``dispatch_deadline``: wedged rounds must abort cleanly with a
resumable snapshot, and the next round must come up warm.  ``--shards``
soaks the SHARDED replay plane (``replay_shards=2``) with
``kill_replay_shard`` + ``garble_sample_response`` + ``stall_shard``
armed: every round must finish with zero learner stalls, all shards
alive (the watchdog respawned every kill), every garbled response
caught-and-retried, and conserved priority accounting (the plane's
training-step count equals the learner's updates — no feedback silently
lost outside the counted cross-respawn drops).  ``--nethost`` soaks the
CROSS-HOST replay fabric (``replay_transport="socket"``, loopback
managed shards — the same wire path a remote deployment runs) with the
socket failure sites armed on top of the shard kills: link partitions
(``partition_shard_link``), rtt spikes (``delay_shard_link``),
half-open peers (``half_open_shard``) and frame garbling
(``garble_net_frame``).  Every round must finish with zero learner
stalls, every link connected and every shard alive (partitions healed,
kills respawned through the epoch handshake), and the same conserved
priority accounting — stale cross-epoch feedback is COUNTED
(stale_feedback/epoch_drops), never silently applied; the soak-level
gate additionally requires >= 2 partitions and >= 1 shard kill to have
actually fired and healed across the soak.  ``--sessions`` soaks
the SESSION-SERVING tier (r2d2_tpu_torch/serving, no trainer involved):
rounds of synthetic episodic load with ``kill_session_client`` +
``slow_session_client`` armed and an LRU budget below the offered
session count; every round must keep the tier ``ok``/``degraded``
(never 503-failing), reap every disconnect's sessions (no leaked
hidden slots — the reap counter must cover the kills' abandons),
keep the accounting invariant ``admitted == completed + reaped +
evicted + live``, and keep completing sessions while a straggler is
frozen; every other round restarts the server through the session
snapshot (save → restore) and the counters must carry over.
``--league`` soaks the
POPULATION + standing-eval plane (r2d2_tpu_torch/league): a 2-member
population (base + the low_resource member preset) with the eval
sidecar attached and ``kill_eval_sidecar`` armed — every kill must be
answered by an eval_watch respawn whose checkpoint cursor resumes from
league.jsonl (zero duplicate (step, member) rows across the WHOLE
soak, rows monotone across resume rounds — one continuous record), and
training throughput must be untouched (the fabric never fails over a
dead evaluator).  ``--trace`` (implies
--process) adds a tracing round: once the first round has seen a
kill_fleet fire, a cross-process capture window is armed mid-soak over
/tracez, and the round fails unless the dump parses as Chrome trace
JSON and carries events from the respawned fleet's NEW incarnation
(the slab slot re-attached with a bumped incarnation tag —
telemetry/tracing.py).  Default soaks the thread transport (freeze +
truncate sites only).
"""
import argparse
import json
import os
import sys
import tempfile
import time

from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import test_config
from r2d2_tpu_torch.envs.fake import FakeAtariEnv
from r2d2_tpu_torch.telemetry.runlog import artifact_log
from r2d2_tpu_torch.train import train

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
A = 4


def env_factory(cfg, seed):
    return FakeAtariEnv(obs_shape=cfg.obs_shape, action_dim=A, seed=seed,
                        episode_len=32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("minutes", nargs="?", type=float, default=10.0)
    for flag in ("process", "serve", "anakin", "shards", "nethost",
                 "trace", "sessions", "league"):
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    # --serve, --trace and --league ride on the process transport
    a.process = a.process or a.serve or a.trace or a.league
    return a


def _device_kw(opts) -> dict:
    """Config fields for ``--device cpu``: acting on the CPU too."""
    return dict(act_device="cpu") if opts.device == "cpu" else {}


def _train_device(opts):
    return "cpu" if opts.device == "cpu" else None


def _trace_dumps(ck_dir: str):
    """Existing capture dumps, numerically sorted (numbers continue
    across rounds/resumes; a lexical sort would rank trace_2.json above
    trace_10.json)."""
    tel = os.path.join(ck_dir, "telemetry")
    try:
        names = os.listdir(tel)
    except FileNotFoundError:
        return []
    return sorted((f for f in names if f.startswith("trace_")
                   and f.endswith(".json")),
                  key=lambda f: int(f[len("trace_"):-5]))


def _check_trace_dump(ck_dir: str, pre_existing):
    """--trace round verdict: THIS round's capture dump (not a stale one
    from an earlier round) must parse as Chrome trace JSON and carry
    events recorded by a respawned fleet's NEW incarnation (tid = the
    slab slot's incarnation tag — a kill fired before arming, so the
    live writer is a respawn).  Returns an error string, or None when
    the invariant holds."""
    tel = os.path.join(ck_dir, "telemetry")
    dumps = [f for f in _trace_dumps(ck_dir) if f not in pre_existing]
    if not dumps:
        return "trace armed but no NEW dump was written this round"
    try:
        with open(os.path.join(tel, dumps[-1])) as f:
            evs = json.load(f)["traceEvents"]
    except (ValueError, KeyError) as e:
        return f"trace dump does not parse: {e}"
    fleet_pids = {e["pid"] for e in evs
                  if e.get("ph") == "M" and e.get("name") == "process_name"
                  and e["args"]["name"].startswith("fleet")}
    if not fleet_pids:
        return "trace dump has no fleet track"
    if not any(e.get("ph") == "X" and e["pid"] in fleet_pids
               and e.get("tid", 0) >= 1 for e in evs):
        return ("trace dump has no events from a respawned fleet "
                "incarnation (tid >= 1)")
    return None


def session_soak(opts) -> int:
    """--sessions: soak the session-serving tier (module docstring) —
    load-gen rounds with client-kill/straggler chaos against a tight LRU
    budget, a save→restore server restart every other round, and the
    tier's invariants asserted per round."""
    import torch

    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.serving import SessionServer
    from r2d2_tpu_torch.tools import session_load_gen as slg
    from r2d2_tpu_torch.utils.chaos import ChaosInjector
    from r2d2_tpu_torch.utils.supervisor import Supervisor

    from r2d2_tpu_torch.analysis import preflight

    preflight(ROOT)
    cfg = test_config(serve_max_sessions=48, serve_max_batch=16,
                      serve_session_idle_s=3.0,
                      serve_request_deadline=5.0, **_device_kw(opts))
    device = _train_device(opts)
    params = create_network(cfg, A, device="cpu",
                            generator=torch.Generator().manual_seed(0)
                            ).state_dict()
    deadline = time.time() + opts.minutes * 60
    rounds, failures = [], []
    seed = int(time.time()) & 0xFFFF
    with tempfile.TemporaryDirectory() as ck_dir:
        ckpt = Checkpointer(ck_dir)
        server = None
        rnd = 0
        while time.time() < deadline:
            rnd += 1
            restarted = False
            if server is None:
                server = SessionServer(cfg, A, device=device)
                server.publish_params(params)
                server.warmup()
                server.start()
            elif rnd % 2 == 0:
                # restart drill: snapshot the live store, bring a fresh
                # server up from it — counters must carry over so the
                # accounting invariant spans the restart
                before = server.store.counts()
                server.stop()
                server.close()            # drain loops BEFORE state()
                server.save_sessions(ckpt)
                server = SessionServer(cfg, A, device=device)
                server.publish_params(params)
                server.restore_sessions(ckpt)
                server.start()
                after = server.store.counts()
                restarted = True
                if after != before:
                    failures.append(
                        f"round {rnd}: restart dropped counters "
                        f"{before} -> {after}")
            chaos = ChaosInjector(
                "kill_session_client:every=150,n=1000000"
                ";slow_session_client:every=211,dur=0.8,n=1000000",
                seed=seed + rnd)
            out: list = []
            sup = Supervisor(max_restarts=0)
            srv = server

            def _round(out=out, srv=srv, chaos=chaos, rnd=rnd):
                out.append(slg.run_load(
                    cfg, A, srv.host, srv.port, sessions=80, workers=4,
                    steps_mean=8, think_s=0.005,
                    run_seconds=min(25.0, max(5.0,
                                              deadline - time.time())),
                    call_timeout=20.0, seed=seed + rnd, chaos=chaos))

            sup.start(f"session_round_{rnd}", _round)
            worst = "ok"
            round_deadline = time.time() + 120.0   # run_load self-bounds
            while not out and not sup.any_failed \
                    and time.time() < round_deadline:
                time.sleep(0.25)
                status = server.healthz()["status"]
                if status == "failing":
                    worst = "failing"
                elif status == "degraded" and worst == "ok":
                    worst = "degraded"
            sup.join_all(timeout=30.0)
            if not out:
                failures.append(f"round {rnd}: load-gen round died")
                break
            load = out[0]
            s = server.stats()
            rec = dict(round=rnd, restarted=restarted, load=load,
                       server={k: s[k] for k in
                               ("admitted", "completed", "reaped",
                                "evicted", "rejected", "expired", "gone",
                                "batches", "requests", "live")},
                       worst_health=worst, chaos=chaos.counts())
            rounds.append(rec)
            print(json.dumps(rec), flush=True)
            # invariants a session round must uphold
            if worst == "failing":
                failures.append(f"round {rnd}: tier went 503-failing")
            if s["admitted"] != (s["completed"] + s["reaped"]
                                 + s["evicted"] + s["live"]):
                failures.append(f"round {rnd}: accounting broken {s}")
            kills = chaos.counts().get("kill_session_client", 0)
            if kills and load["abandoned"] and s["reaped"] == 0:
                failures.append(
                    f"round {rnd}: {kills} client kills abandoned "
                    f"{load['abandoned']} sessions but nothing reaped — "
                    "leaked hidden slots")
            if load["completed"] == 0:
                failures.append(f"round {rnd}: no session ever completed")
            if load["workers_failed"]:
                failures.append(f"round {rnd}: load-gen worker crashed")
        if server is not None:
            server.stop()
            server.close()
    summary = dict(minutes=opts.minutes, mode="sessions",
                   rounds=len(rounds), failures=failures,
                   final=rounds[-1]["server"] if rounds else None)
    print(json.dumps(summary, indent=2))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(dict(summary=summary, rounds=rounds), f, indent=2)
    if failures:
        print("CHAOS SOAK FAILED", file=sys.stderr)
        return 1
    print("chaos soak clean")
    return 0


def main(argv=None) -> int:
    from r2d2_tpu_torch.analysis import preflight

    opts = parse_args(argv)
    if opts.sessions:
        return session_soak(opts)
    # fail fast on a dirty tree before hours of kill/resume cycles
    preflight(ROOT)
    anakin, shards, nethost = opts.anakin, opts.shards, opts.nethost
    process, serve, league, trace = (opts.process, opts.serve, opts.league,
                                     opts.trace)
    chaos = "freeze_learner:every=40,dur=0.5;truncate_ckpt:p=0.3"
    transport = dict(actor_transport="thread")
    extra = {}
    if anakin:
        # fused-loop mode: the wedge_dispatch site vs a tight dispatch
        # deadline — every wedge must abort cleanly with a snapshot
        chaos = "wedge_dispatch:every=60,dur=1.0,n=1000000"
        transport = dict(actor_transport="anakin", num_actors=2,
                         superstep_k=2, anakin_episode_len=12,
                         learning_starts=16)
        extra = dict(dispatch_deadline=0.4)
    elif shards:
        # sharded replay plane: shard kill → respawn-with-restore,
        # response garbling → bounded retry, SIGSTOP stalls → the RPC
        # deadline redistributes the rows (learner never stalls).  No
        # truncate_ckpt here: a truncated learner save legitimately
        # resumes the learner at an earlier step than the plane's
        # counters, which would trip the accounting invariant for a
        # reason that has nothing to do with sharding
        chaos = ("freeze_learner:every=40,dur=0.5"
                 ";kill_replay_shard:every=200,n=1000000"
                 ";garble_sample_response:p=0.01"
                 ";stall_shard:every=350,dur=1.0,n=1000000")
        transport = dict(actor_transport="thread", num_actors=2)
        extra = dict(replay_shards=2, replay_sample_timeout=1.0)
    elif nethost:
        # cross-host replay fabric over loopback sockets: shard kills →
        # respawn + epoch-handshake re-attach, link partitions → stale
        # gossip view → strata redistribute then heal, half-open peers
        # → RPC deadline + circuit, rtt spikes → rtt histogram, frame
        # garbling → CRC drop + bounded retry.  No truncate_ckpt (the
        # shards rationale).  Partition opportunities count per-shard
        # sample requests, so every=400 lands one partition roughly
        # every ~10 s of real sampling traffic
        chaos = ("freeze_learner:every=40,dur=0.5"
                 ";kill_replay_shard:every=250,n=1000000"
                 ";partition_shard_link:every=400,dur=1.5,n=1000000"
                 ";delay_shard_link:every=700,dur=0.3,n=1000000"
                 ";half_open_shard:every=900,dur=1.0,n=1000000"
                 ";garble_net_frame:p=0.002")
        transport = dict(actor_transport="thread", num_actors=2)
        extra = dict(replay_shards=2, replay_transport="socket",
                     replay_sample_timeout=1.0, replay_net_cooldown=1.0)
    elif process:
        chaos += ";kill_fleet:every=120;garble_block:p=0.005"
        transport = dict(actor_transport="process", num_actors=2,
                         actor_fleets=2,
                         actor_inference="serve" if serve else "local")
        # the param-staleness watchdog drill rides along either way
        chaos += ";stall_pump:every=300,dur=2,n=1000000"
        if league:
            # population + standing-eval soak: 2 members (base + the
            # low_resource member preset), the eval sidecar attached,
            # and a sidecar SIGKILL every ~30 s of chaos-loop polls —
            # each must respawn with the league.jsonl cursor resumed
            # (zero duplicate rows across the whole soak)
            transport["actor_fleets"] = 2
            chaos += ";kill_eval_sidecar:every=600,n=1000000"
            extra = dict(
                extra,
                population_spec='[{"name": "base"}, {"name": "low", '
                                '"preset": "low_resource"}]',
                league_eval=True, league_eval_episodes=2,
                league_eval_interval=0.5)
        if serve:
            # one full freeze→degrade→re-attach cycle per round, plus
            # response loss/corruption noise absorbed by bounded retry
            # freeze opportunities count SERVED batches, so every=800
            # forces a full degrade→re-attach cycle well inside a round
            chaos += (";freeze_service:every=800,dur=4,n=1000000"
                      ";drop_act_response:p=0.002"
                      ";garble_act_response:p=0.002")
            # MERGE, never reassign: --league's extras (population spec,
            # sidecar knobs) may already be armed — a wholesale
            # replacement would silently turn --serve --league into a
            # league-free soak whose league invariants pass vacuously
            extra = dict(extra, act_response_timeout=0.5)
    if trace:
        # the /tracez arming below needs the exporter; kill_fleet rides
        # along from the --process spec so a respawned incarnation
        # exists to capture
        extra = dict(extra, telemetry_port=-1)
    cfg = test_config(
        game_name="Fake", training_steps=10 ** 9, log_interval=1.0,
        save_interval=200, keep_checkpoints=3, chaos_spec=chaos,
        learner_stall_timeout=30.0, replay_snapshot_interval=5.0,
        # learnhealth plane armed as a STANDING SOAK INVARIANT: the
        # in-graph diagnostics run every 8 steps and every alert rule is
        # armed (wide/neutral thresholds) — a round that fires ANY
        # learnhealth.alert fails below.  The default chaos spec keeps
        # freeze_learner in every round, so this also pins the
        # loss-spike/stall interplay: a frozen learner produces NO new
        # loss samples, the spike EWMA only advances on samples, and a
        # freeze must therefore never false-positive a loss_spike.
        learnhealth_interval=8, alert_ess_min=0.005,
        alert_replay_ratio_min=0.0, alert_replay_ratio_max=1e6,
        alert_dq_budget=1e6,
        seed=int(time.time()) & 0xFFFF, **transport, **extra,
        **_device_kw(opts))

    deadline = time.time() + opts.minutes * 60
    rounds, failures = [], []
    last_updates = 0
    # machine-readable per-interval telemetry across ALL rounds, each
    # entry tagged with its round (one continuous curve over the whole
    # kill/resume soak); train() also writes its own run.jsonl under
    # ck_dir, but that dies with the TemporaryDirectory
    runlog = artifact_log(opts.out, "chaos_soak_telemetry.jsonl")
    try:
        with tempfile.TemporaryDirectory() as ck_dir:
            rnd = 0
            while time.time() < deadline:
                rnd += 1
                kwargs = {} if anakin else dict(env_factory=env_factory)
                rcfg = cfg
                if anakin:
                    # alternate the wedge grade: odd rounds stall past
                    # the 2x-budget grace (hard wedge — fetch abandoned,
                    # bounded snapshot), even rounds land inside it
                    # (slow wedge — drain + inline snapshot) so BOTH
                    # abort paths stay drilled
                    dur = 1.0 if rnd % 2 else 0.6
                    rcfg = cfg.replace(
                        chaos_spec="wedge_dispatch:every=60,"
                                   f"dur={dur},n=1000000")
                trace_state = dict(armed=False)
                pre_dumps = set(_trace_dumps(ck_dir)) if trace else set()

                def log_sink(e, r=rnd, ts=trace_state):
                    runlog.append(dict(e, round=r))
                    # --trace round: once a fleet kill fired, arm a
                    # capture spanning the rest of the round (the
                    # shutdown force-close dumps it) — the respawned
                    # fleet's NEW incarnation is then the live writer
                    if (trace and not ts["armed"]
                            and (e.get("chaos") or {}).get("kill_fleet")
                            and e.get("telemetry_port")):
                        import urllib.request

                        try:
                            urllib.request.urlopen(
                                "http://127.0.0.1:%d/tracez?steps=%d"
                                % (e["telemetry_port"], 10 ** 9),
                                timeout=5).read()
                            ts["armed"] = True
                        except Exception as exc:
                            print(f"trace arm failed: {exc}",
                                  file=sys.stderr)

                m = train(rcfg, checkpoint_dir=ck_dir, resume=rnd > 1,
                          verbose=False, device=_train_device(opts),
                          log_sink=log_sink,
                          max_wall_seconds=min(45.0,
                                               deadline - time.time()),
                          **kwargs)
                if trace and trace_state["armed"]:
                    err = _check_trace_dump(ck_dir, pre_dumps)
                    if err:
                        failures.append(f"round {rnd}: {err}")
                ck = Checkpointer(ck_dir)
                fleet = m.get("fleet_health") or {}
                rec = dict(round=rnd, updates=m["num_updates"],
                           buffer=m["buffer_size"],
                           restored=m.get("restored_replay"),
                           stalled=m.get("learner_stalled"),
                           wedged=m.get("dispatch_wedged"),
                           chaos=m.get("chaos"),
                           fleet=fleet,
                           replay_shards=m.get("replay_shard_health"),
                           resilience=fleet.get("resilience"),
                           complete_steps=ck.steps(),
                           partial_steps=[s for s in
                                          ck.steps(complete=False)
                                          if s not in ck.steps()],
                           replay_steps=ck.replay_steps())
                if league:
                    # league invariants per round: every committed row
                    # unique per (step, member) — a respawned sidecar
                    # resuming its cursor must never double-score; the
                    # file is append-only so this also covers resume
                    # continuity across rounds
                    from r2d2_tpu_torch.league.eval_service import read_league

                    lrows = [e for e in read_league(ck_dir)
                             if e.get("kind") == "eval"]
                    pairs = [(e["step"], e["member"]) for e in lrows]
                    dups = len(pairs) - len(set(pairs))
                    rec["league"] = m.get("league")
                    rec["league_rows"] = len(pairs)
                    rec["league_dups"] = dups
                    if dups:
                        failures.append(
                            f"round {rnd}: {dups} duplicate league "
                            "rows (cursor resume broke)")
                rec["alerts"] = m.get("alerts") or {}
                rounds.append(rec)
                print(json.dumps(rec), flush=True)

                # learnhealth standing invariant: chaos drills exercise
                # RECOVERY paths, none of which may look like a learning
                # pathology — zero unexpected alert fires per round
                # (incl. the freeze_learner rounds: a stall must not
                # false-positive the loss-spike rule)
                fired = {k: v for k, v in rec["alerts"].items() if v}
                if fired:
                    failures.append(
                        f"round {rnd}: unexpected learnhealth alerts "
                        f"{fired}")

                # invariants a chaos round must uphold.  (num_updates may
                # legitimately regress across rounds: a truncated final
                # save resumes from an earlier complete step — that is
                # the point.)
                if rnd > 1 and not m.get("restored_replay"):
                    failures.append(f"round {rnd}: resume came up cold")
                if shards or nethost:
                    rh = m.get("replay_shard_health") or {}
                    if m.get("learner_stalled"):
                        failures.append(
                            f"round {rnd}: learner stalled under shard "
                            "chaos")
                    if rh.get("alive") != rh.get("shards"):
                        failures.append(
                            f"round {rnd}: dead shard at exit "
                            f"({rh.get('alive')}/{rh.get('shards')})")
                    # conserved priority accounting: every learner update
                    # reached the plane's feedback fan-out (cross-respawn
                    # drops are counted, never silent)
                    if m.get("buffer_training_steps") != m["num_updates"]:
                        failures.append(
                            f"round {rnd}: feedback accounting "
                            f"{m.get('buffer_training_steps')} != "
                            f"updates {m['num_updates']}")
                if nethost:
                    nh = (m.get("replay_shard_health") or {}).get("net") \
                        or {}
                    # every partition healed, every kill re-attached: a
                    # round must END with every link connected (the
                    # sampled health is taken before teardown)
                    if nh.get("connected") != rh.get("shards"):
                        failures.append(
                            f"round {rnd}: disconnected link at exit "
                            f"({nh.get('connected')}/{rh.get('shards')})")
                if anakin and m.get("dispatch_wedged") \
                        and not ck.replay_steps():
                    failures.append(
                        f"round {rnd}: wedged abort left no resumable "
                        "snapshot")
                rep = ck.restore_replay()
                if rep is not None:
                    meta = rep[0]
                    # anakin snapshots carry kind="anakin" and their own
                    # payload layout — the ring-counter check is
                    # host-ring-shaped only
                    counters = meta.get("counters") or {}
                    if counters.get("size", 0) < 0:
                        failures.append(
                            f"round {rnd}: negative snapshot size")
                if len(ck.steps()) > cfg.keep_checkpoints:
                    failures.append(f"round {rnd}: retention GC fell "
                                    f"behind ({ck.steps()})")
                last_updates = m["num_updates"]
    finally:
        runlog.close()

    # soak-level failover invariant (--serve): if any freeze_service
    # fired, at least one circuit must have opened AND at least one
    # re-attach resync must have landed somewhere in the soak — a freeze
    # the fleets never noticed, or a degrade that never re-attached,
    # both mean the failover path is broken.  (Per-round end-state is
    # not checked: a 45 s round may legitimately END mid-freeze.)
    if serve and rounds:
        freezes = sum((r["chaos"] or {}).get("freeze_service", 0)
                      for r in rounds)
        opens = sum((r.get("resilience") or {}).get("circuit_opens", 0)
                    for r in rounds)
        resyncs = sum(((r["fleet"].get("service") or {}).get("resyncs", 0))
                      for r in rounds)
        if freezes and not opens:
            failures.append("freeze_service fired but no circuit opened")
        if opens and not resyncs:
            failures.append("circuits opened but no re-attach resync "
                            "ever landed")
    # soak-level invariants (--shards): every shard kill must have been
    # answered by a watchdog respawn, and armed response garbling must
    # have been exercised AND caught (garbled_responses only counts
    # CRC-caught flips — an uncaught one reaches the learner as a torn
    # batch and fails the round's accounting instead)
    if shards and rounds:
        kills = sum((r["chaos"] or {}).get("kill_replay_shard", 0)
                    for r in rounds)
        respawns = sum(sum((r.get("replay_shards") or {})
                           .get("respawns", [])) for r in rounds)
        garbles = sum((r.get("replay_shards") or {})
                      .get("garbled_responses", 0) for r in rounds)
        if kills and respawns < kills:
            failures.append(f"{kills} shard kills but only {respawns} "
                            "respawns")
        if not garbles:
            failures.append("garble_sample_response armed but no garbled "
                            "response was ever caught")
    # soak-level invariants (--nethost): the committed-artifact gate —
    # the drills must have actually FIRED (>= 2 partitions, >= 1 shard
    # kill) and been answered (respawns cover kills; the per-round
    # connected/alive/accounting checks above prove the heals)
    if nethost and rounds:
        kills = sum((r["chaos"] or {}).get("kill_replay_shard", 0)
                    for r in rounds)
        partitions = sum((r["chaos"] or {}).get("partition_shard_link", 0)
                         for r in rounds)
        respawns = sum(sum((r.get("replay_shards") or {})
                           .get("respawns", [])) for r in rounds)
        if kills < 1:
            failures.append("nethost soak never fired a shard kill — "
                            "lengthen the soak")
        if partitions < 2:
            failures.append(f"nethost soak fired only {partitions} "
                            "partitions (need >= 2) — lengthen the soak")
        if kills and respawns < kills:
            failures.append(f"{kills} shard kills but only {respawns} "
                            "respawns")
    # soak-level invariants (--league): every sidecar kill must have been
    # answered by an eval_watch respawn somewhere in the soak (a kill
    # landing in a round's final seconds may respawn next round), rows
    # must be monotone across resume rounds (append-on-resume — one
    # continuous record), and the fabric must never have failed over a
    # dead evaluator (the per-round resume/update checks cover that)
    if league and rounds:
        kills = sum((r["chaos"] or {}).get("kill_eval_sidecar", 0)
                    for r in rounds)
        respawns = sum((((r.get("league") or {}).get("health") or {})
                        .get("restarts", 0)) for r in rounds)
        if kills and not respawns:
            failures.append(f"{kills} sidecar kills but no eval_watch "
                            "respawn ever fired")
        rows_seq = [r.get("league_rows", 0) for r in rounds]
        if any(b < a for a, b in zip(rows_seq, rows_seq[1:])):
            failures.append("league rows regressed across resume "
                            f"rounds: {rows_seq}")
    summary = dict(minutes=opts.minutes, rounds=len(rounds),
                   failures=failures,
                   final_updates=last_updates,
                   telemetry_jsonl=runlog.path,
                   chaos_fires=rounds[-1]["chaos"] if rounds else None)
    print(json.dumps(summary, indent=2))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(dict(summary=summary, rounds=rounds), f, indent=2)
    if failures:
        print("CHAOS SOAK FAILED", file=sys.stderr)
        return 1
    print("chaos soak clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
