"""The port's recovery paths, on the CPU: replay snapshots, drain-then-save
and warm resume, supervised restarts, chaos drills.

- a replay snapshot written by either package restores in the other, bit
  for bit, and the next ``sample_batch`` draws the same rows; a snapshot
  of another geometry is refused; a partial one is never selected;
- ``train()`` (``device="cpu"``, ``act_device="cpu"``, ``test_config``
  size) restarts an actor whose env raised once, drains and saves on its
  ``stop_fn``, resumes warm (``restored_replay``, counters monotone), runs
  from a thread that is not the main one, writes periodic snapshots on
  its cadence, and stops cleanly when ``poison_params`` trips the
  learning-health sentry or ``freeze_learner`` the stall watchdog; a
  ``truncate_ckpt`` save is never restored.

Mirrors tests/test_recovery.py and the recovery half of
tests/test_train_end_to_end.py (both slow-marked in the JAX package,
where the learner step compiles; the port's runs take seconds).
"""
import os
import threading

import numpy as np
import pytest

from r2d2_tpu.checkpoint import Checkpointer as JaxCheckpointer
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.replay import block as jblock
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as JaxReplayBuffer
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.replay import block as tblock
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.telemetry.learnhealth import read_alerts
from r2d2_tpu_torch.telemetry.runlog import read_entries

A = 4


def env_factory(cfg, seed):
    return FakeAtariEnv(obs_shape=cfg.obs_shape, action_dim=A, seed=seed,
                        episode_len=32)


def cpu_config(**kw):
    base = dict(game_name="Fake", act_device="cpu", prefetch_batches=2,
                log_interval=0.2)
    base.update(kw)
    return port_test_config(**base)


def run(cfg, ck=None, **kw):
    return ttrain.train(cfg, env_factory=env_factory, checkpoint_dir=ck,
                        verbose=False, device="cpu", max_wall_seconds=120,
                        **kw)


# ------------------------------------------------------- replay snapshots

def _filled_pair(n_blocks, seed=3):
    """A JAX and a port ReplayBuffer fed the same blocks (cut by each
    package's LocalBuffer from the same inputs) with the same seeds."""
    jcfg, tcfg = jax_test_config(), port_test_config()
    rng = np.random.default_rng(seed)
    ref = JaxReplayBuffer(jcfg, A, rng=np.random.default_rng(7))
    port = ReplayBuffer(tcfg, A, rng=np.random.default_rng(7))
    for it in range(n_blocks):
        lj, lt = jblock.LocalBuffer(jcfg, A), tblock.LocalBuffer(tcfg, A)
        o = rng.integers(0, 255, jcfg.obs_shape, dtype=np.uint8)
        lj.reset(o)
        lt.reset(o)
        for _ in range(int(rng.integers(1, jcfg.block_length + 1))):
            step = (int(rng.integers(A)), float(rng.normal()),
                    rng.integers(0, 255, jcfg.obs_shape, dtype=np.uint8),
                    rng.normal(size=A).astype(np.float32),
                    rng.normal(size=(2, jcfg.lstm_layers, jcfg.hidden_dim)
                               ).astype(np.float32))
            lj.add(*step)
            lt.add(*step)
        last_q = None if it % 3 else rng.normal(size=A).astype(np.float32)
        ref.add(*lj.finish(last_q))
        port.add(*lt.finish(last_q))
    b = ref.sample_batch()
    port.sample_batch()
    prios = rng.random(b["idxes"].size).astype(np.float32)
    ref.update_priorities(b["idxes"], prios, b["block_ptr"], 0.25)
    port.update_priorities(b["idxes"], prios, b["block_ptr"], 0.25)
    return jcfg, tcfg, ref, port


def _assert_same_state(a, b, spec):
    for name, _, _ in spec:
        if name == "tree_leaves":
            np.testing.assert_array_equal(a.tree.leaf_values(),
                                          b.tree.leaf_values())
        else:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)
    for k in ReplayBuffer.STATE_COUNTERS:
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replay_snapshot_restores_across_packages(tmp_path, writer):
    """Written by one package through its Checkpointer, read by the other
    into a fresh buffer: every ring array, the PER leaves, the counters
    and the sampling RNG bitwise, so the next draw is the same batch."""
    jcfg, tcfg, ref, port = _filled_pair(25)
    assert port.state_spec() == ref.state_spec()
    src, src_ck = ((ref, JaxCheckpointer(str(tmp_path)))
                   if writer == "jax" else (port, Checkpointer(str(tmp_path))))
    src_ck.save_replay(7, src.write_state, actors=[{"lane": 1}])
    if writer == "jax":
        dst = ReplayBuffer(tcfg, A, rng=np.random.default_rng(99))
        meta, path, actors = Checkpointer(str(tmp_path)).restore_replay()
    else:
        dst = JaxReplayBuffer(jcfg, A, rng=np.random.default_rng(99))
        meta, path, actors = JaxCheckpointer(str(tmp_path)).restore_replay()
    assert meta["step"] == 7 and actors == [{"lane": 1}]
    dst.read_state(path, meta)
    _assert_same_state(dst, src, port.state_spec())
    got, want = dst.sample_batch(), src.sample_batch()
    for k in want:
        if k != "ages":
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_replay_snapshot_of_another_geometry_is_refused(tmp_path):
    _, _, _, port = _filled_pair(5)
    meta = port.write_state(str(tmp_path / "ring.bin"))
    other = ReplayBuffer(port_test_config(buffer_capacity=320), A)
    with pytest.raises(ValueError, match="layout mismatch"):
        other.read_state(str(tmp_path / "ring.bin"), meta)


def test_partial_replay_snapshot_is_never_selected(tmp_path):
    """A snapshot whose meta.json never landed (a crash mid-write, or the
    truncate_ckpt drill) is invisible; the newest COMMITTED one wins,
    by commit time, not by step."""
    _, _, _, port = _filled_pair(5)
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save_replay(10, port.write_state)
    os.makedirs(tmp_path / "step_20.replay")            # torn: no meta
    open(tmp_path / "step_20.replay" / "ring.bin", "wb").close()
    assert ck.replay_steps() == [10]
    assert ck.restore_replay()[0]["step"] == 10
    assert ck.restore_replay(step=20) is None
    ck.save_replay(5, port.write_state)                 # step regressed
    assert ck.restore_replay()[0]["step"] == 5

    class Truncate:
        def fire(self, kind):
            return kind == "truncate_ckpt"

    ck.chaos = Truncate()
    ck.save_replay(30, port.write_state)
    assert 30 not in ck.replay_steps()
    assert ck.restore_replay()[0]["step"] == 5


def test_checkpoint_gc_takes_the_replay_snapshot_with_its_step(tmp_path):
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models import create_network

    cfg = port_test_config()
    state = create_train_state(cfg, create_network(cfg, A, device="cpu")
                               .state_dict())
    _, _, _, port = _filled_pair(3)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, state)
    ck.save_replay(1, port.write_state)
    ck.save(2, state)
    assert ck.steps() == [2]
    assert not os.path.exists(tmp_path / "step_1.replay")


def test_session_snapshot_falls_back_to_old(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.restore_sessions() is None

    def writer(tag):
        def w(path):
            with open(path, "w") as f:
                f.write(tag)
            return dict(tag=tag)
        return w

    assert ck.save_sessions(writer("a")) == dict(tag="a")
    ck.save_sessions(writer("b"))
    meta, path = ck.restore_sessions()
    assert meta == dict(tag="b") and open(path).read() == "b"
    # a crash between the two renames leaves only the .old snapshot
    os.replace(tmp_path / "sessions.snap", tmp_path / "sessions.snap.old")
    assert ck.restore_sessions()[0] == dict(tag="b")


# ------------------------------------------------------ the fabric's paths

class _FlakyEnv:
    """FakeAtariEnv that raises once, ``fail_at`` steps in."""

    def __init__(self, cfg, seed, fail_at):
        self._env = FakeAtariEnv(obs_shape=cfg.obs_shape, action_dim=A,
                                 seed=seed, episode_len=32)
        self.action_space = self._env.action_space
        self._steps = 0
        self._fail_at = fail_at
        self._failed = False

    def reset(self, **kw):
        return self._env.reset(**kw)

    def step(self, a):
        self._steps += 1
        if not self._failed and self._steps >= self._fail_at:
            self._failed = True
            raise RuntimeError("injected env fault")
        return self._env.step(a)


def test_actor_that_raises_once_is_restarted():
    cfg = cpu_config(training_steps=20)
    m = ttrain.train(cfg, env_factory=lambda c, seed: _FlakyEnv(c, seed,
                                                                fail_at=150),
                     verbose=False, device="cpu", max_wall_seconds=120)
    assert m["num_updates"] == 20 and not m["fabric_failed"]
    health = m["health"]["actor"]
    assert health["restarts"] >= 1 and not health["gave_up"]
    assert "injected env fault" in health["last_error"]
    assert np.isfinite(m["mean_loss"])


def test_stop_fn_drains_saves_and_resumes_warm(tmp_path):
    """A programmatic stop mid-run drains and saves the learner state and
    the full replay snapshot; the resumed run restores both (the ring, the
    actors' lanes) and its counters continue."""
    ck = str(tmp_path / "ck")
    built = []
    real = ttrain._build

    def capture(*a, **kw):
        sys_ = real(*a, **kw)
        built.append(sys_)
        return sys_

    ttrain._build = capture
    try:
        first = run(cpu_config(training_steps=10_000), ck,
                    stop_fn=lambda: (bool(built)
                                     and built[0]["learner"].num_updates
                                     >= 6))
        saved = Checkpointer(ck)
        step = first["num_updates"]
        assert 6 <= step < 10_000 and saved.latest_step() == step
        assert saved.replay_steps() == [step]
        actor_steps = built[0]["actor"].actor_steps
        m = run(cpu_config(training_steps=step + 4), ck, resume=True)
    finally:
        ttrain._build = real
    assert m["restored_replay"] and m["num_updates"] == step + 4
    assert m["buffer_training_steps"] == step + 4
    assert built[1]["learner"].num_updates >= step
    assert m["env_steps"] >= first["env_steps"]
    assert built[1]["actor"].actor_steps > actor_steps
    entries = list(read_entries(os.path.join(ck, "telemetry", "run.jsonl")))
    curve = [e["env_steps"] for e in entries]
    assert curve == sorted(curve) and len(entries) >= 2


def test_train_from_a_worker_thread():
    """Signals reach only the main thread: run from a worker, train()
    skips its hooks and still drains and returns."""
    out = {}

    def body():
        out["m"] = run(cpu_config(training_steps=8))

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert out["m"]["num_updates"] == 8 and not out["m"]["fabric_failed"]


def test_periodic_replay_snapshots_on_their_cadence(tmp_path, monkeypatch):
    """replay_snapshot_interval > 0 arms the snapshot thread: snapshots
    land mid-run (tagged with the buffer's feedback count), besides the
    drained one at the end."""
    calls = []
    real = Checkpointer.save_replay

    def counting(self, step, writer, actors=None):
        calls.append((step, actors is not None))
        return real(self, step, writer, actors=actors)

    monkeypatch.setattr(Checkpointer, "save_replay", counting)
    ck = str(tmp_path / "ck")
    m = run(cpu_config(training_steps=10_000,
                       replay_snapshot_interval=0.3), ck,
            stop_fn=lambda: len(calls) >= 3)
    periodic = [c for c in calls if not c[1]]
    assert len(periodic) >= 3
    assert calls[-1] == (m["num_updates"], True)   # the drained save
    assert Checkpointer(ck).replay_steps() == [m["num_updates"]]


def test_poison_params_trips_learnhealth_and_stops_cleanly(tmp_path):
    """The NaN drill: the next loss is non-finite, the nonfinite alert
    fires (durably), /healthz degrades, and the fabric drains and saves
    instead of crashing or training on."""
    ck = str(tmp_path / "ck")
    m = run(cpu_config(training_steps=10_000,
                       chaos_spec="poison_params:at=40"), ck)
    assert m["chaos"] == {"poison_params": 1}
    assert m["learnhealth"]["nonfinite"] >= 1
    # the trip fires at once; a pipelined step already past the poison
    # may add a second non-finite loss, and the delta rule its row
    fired = m["alerts"].get("nonfinite", 0)
    assert fired >= 1 and set(m["alerts"]) == {"nonfinite"}
    assert m["healthz"]["status"] == "degraded" and m["healthz"]["ok"]
    assert not m["fabric_failed"] and m["num_updates"] < 10_000
    assert [r["rule"] for r in read_alerts(ck)] == ["nonfinite"] * fired
    assert Checkpointer(ck).latest_step() == m["num_updates"]


def test_freeze_learner_trips_the_stall_watchdog():
    m = run(cpu_config(training_steps=10_000, learner_stall_timeout=0.3,
                       chaos_spec="freeze_learner:at=30,dur=1.5"))
    assert m["learner_stalled"] and m["chaos"] == {"freeze_learner": 1}
    assert not m["fabric_failed"] and m["num_updates"] < 10_000


def test_truncated_checkpoint_is_never_restored(tmp_path):
    """truncate_ckpt on the first save: that step has no sidecar, so the
    latest complete step is a later one, and a resume restores it."""
    ck = str(tmp_path / "ck")
    m = run(cpu_config(training_steps=8, save_interval=4,
                       chaos_spec="truncate_ckpt:at=1"), ck)
    saved = Checkpointer(ck)
    assert m["chaos"] == {"truncate_ckpt": 1}
    assert saved.steps(complete=False) == [4, 8] and saved.steps() == [8]
    m2 = run(cpu_config(training_steps=10), ck, resume=True)
    assert m2["num_updates"] == 10
