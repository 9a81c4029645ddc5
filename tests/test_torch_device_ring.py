"""The port's device-resident replay against the JAX package's, on the CPU.

``r2d2_tpu_torch.replay.device_ring``, ``ReplayBuffer(device_ring=...)``
and its ``sample_meta``, the host-sampled super-step and
``Learner.run_device`` hold to ``r2d2_tpu``'s at ``test_config`` size (mlp
torso, H=16, float32), fed the same blocks (cut by the port's LocalBuffer,
which matches the JAX package's bit for bit, tests/test_torch_replay.py)
with the same sampler seeds.  Mirrors tests/test_device_ring.py.

Tolerances: the ring contents, ``sample_meta`` bundles and every gathered
field are bitwise (index arithmetic on integers and copies of the same
bytes).  The super-step against JAX's ``make_super_step_fn``: losses and
priorities within 1e-5 relative / 1e-6 absolute, params within 1e-6
absolute (tests/test_torch_learner.py's learner tolerances: both sides sum
in other orders, nothing else differs).  A super-step against k sequential
train steps in the port: bitwise (one CPU, the same kernels).
"""
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import pong_config as jax_pong_config
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.learner.learner import Learner as JaxLearner
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.replay import replay_buffer as jrb
from r2d2_tpu.replay.device_ring import DeviceRing as JaxDeviceRing
from r2d2_tpu.replay.device_ring import gather_batch as jax_gather_batch
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import pong_config
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.replay.block import LocalBuffer
from r2d2_tpu_torch.replay.device_ring import (
    DeviceRing,
    gather_batch,
    resolve_layout,
)
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer, data_bytes
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

A = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=1e-6)
FIELDS = ("obs", "last_action", "last_reward", "hidden", "action",
          "n_step_reward", "n_step_gamma", "burn_in", "learning", "forward",
          "is_weights")


def scripted_blocks(cfg, n_blocks, seed=0):
    """Deterministic well-formed blocks via the port's LocalBuffer."""
    rng = np.random.default_rng(seed)
    local = LocalBuffer(cfg, A)
    out = []
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    while len(out) < n_blocks:
        for _ in range(cfg.block_length):
            local.add(int(rng.integers(A)), float(rng.normal()),
                      rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=A).astype(np.float32),
                      rng.normal(size=(2, cfg.lstm_layers, cfg.hidden_dim)
                                 ).astype(np.float32))
        blk, prios, _ = local.finish(rng.normal(size=A).astype(np.float32))
        out.append((blk, prios))
    return out


def port_buffers(cfg, n_blocks=4, seed=0):
    """A host-ring buffer and a device-ring buffer (on the CPU) fed the same
    blocks, with identically seeded samplers."""
    host = ReplayBuffer(cfg.replace(device_replay=False, in_graph_per=False),
                        A, rng=np.random.default_rng(99))
    ring = DeviceRing(cfg, A, device="cpu")
    dev = ReplayBuffer(cfg, A, rng=np.random.default_rng(99),
                       device_ring=ring)
    for blk, prios in scripted_blocks(cfg, n_blocks, seed):
        host.add(blk, prios, None)
        dev.add(blk, prios, None)
    return host, dev, ring


def jax_buffer(jcfg, n_blocks=4, seed=0):
    """The JAX package's device-ring buffer fed the same blocks."""
    ring = JaxDeviceRing(jcfg, A)
    buf = jrb.ReplayBuffer(jcfg, A, rng=np.random.default_rng(99),
                           device_ring=ring)
    for blk, prios in scripted_blocks(port_test_config(), n_blocks, seed):
        buf.add(blk, prios, None)
    return buf, ring


def flax_to_port(tree):
    return params_from_flax(jax.device_get(tree))


def env_factory(cfg, seed):
    return FakeAtariEnv(obs_shape=cfg.obs_shape, action_dim=A, seed=seed,
                        episode_len=32)


def cpu_config(**kw):
    base = dict(game_name="Fake", act_device="cpu", log_interval=0.2,
                device_replay=True)
    base.update(kw)
    return port_test_config(**base)


# ----------------------------------------------------------------- ring

def test_data_bytes_matches_ring_allocation_and_jax():
    cfg = port_test_config(device_replay=True)
    ring = DeviceRing(cfg, A, device="cpu")
    assert ring.nbytes() == data_bytes(cfg, A) == jrb.data_bytes(
        jax_test_config(), A)
    assert {k: (tuple(a.shape), a.dtype) for k, a in ring.arrays.items()} \
        == {k: (tuple(a.shape), torch.from_numpy(np.zeros(0, a.dtype)).dtype)
            for k, a in JaxDeviceRing(jax_test_config(), A).arrays.items()}
    # the Pong preset's full ring, never allocated here: 15.80 GB
    big = data_bytes(pong_config(game_name="Fake"), 6)
    assert big == jrb.data_bytes(jax_pong_config(game_name="Fake"), 6)
    assert round(big / 1e9, 2) == 15.80


@pytest.mark.parametrize("n_blocks", [4, 22])
def test_device_gather_matches_jax_and_the_host_ring(n_blocks):
    """Same blocks, same sampler seed: ``sample_meta``'s bundle equals
    JAX's bit for bit, and the port's gather of it equals JAX's gather and
    the host ring's ``sample_batch``, every field.  22 blocks wrap the
    20-slot ring, so slots 0 and 1 hold overwritten data."""
    cfg = port_test_config(device_replay=True)
    host, dev, ring = port_buffers(cfg, n_blocks)
    jbuf, jring = jax_buffer(jax_test_config(device_replay=True), n_blocks)
    assert dev.block_ptr == jbuf.block_ptr == host.block_ptr == n_blocks % 20
    for k, a in ring.arrays.items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(jring.arrays[k]),
                                      err_msg=k)

    meta = dev.sample_meta(k=1, batch_size=8)
    jmeta = jbuf.sample_meta(k=1, batch_size=8)
    for key in ("ints", "is_weights", "idxes", "block_ptr", "env_steps"):
        np.testing.assert_array_equal(meta[key], jmeta[key], err_msg=key)
    host_batch = host.sample_batch(8)
    np.testing.assert_array_equal(meta["idxes"][0], host_batch["idxes"])

    got = gather_batch(cfg, ring.snapshot(), torch.from_numpy(meta["ints"][0]),
                       torch.from_numpy(meta["is_weights"][0]))
    want = jax_gather_batch(jax_test_config(), jring.snapshot(),
                            jnp.asarray(jmeta["ints"][0]),
                            jnp.asarray(jmeta["is_weights"][0]))
    for key in FIELDS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(got[key].numpy(), host_batch[key],
                                      err_msg=key)
    assert got["action"].dtype == torch.int64
    assert got["last_action"].dtype == torch.float32


def test_sample_meta_matches_jax_and_dispatches_under_the_lock():
    """k=3 bundles equal JAX's bit for bit (no feedback between them), the
    sampled-row counts advance alike, and the ``dispatch`` callback runs
    with the buffer lock held."""
    cfg = port_test_config(device_replay=True)
    _, dev, _ = port_buffers(cfg, 6)
    jbuf, _ = jax_buffer(jax_test_config(device_replay=True), 6)
    seen = []

    def dispatch(ints, weights):
        seen.append((dev.lock.locked(), ints.shape, weights.shape))
        return "enqueued"

    for _ in range(2):
        meta = dev.sample_meta(k=3, dispatch=dispatch)
        jmeta = jbuf.sample_meta(k=3)
        for key in ("ints", "is_weights", "idxes"):
            np.testing.assert_array_equal(meta[key], jmeta[key], err_msg=key)
    assert meta["dispatched"] == "enqueued"
    assert seen == [(True, (3, 8, 6), (3, 8))] * 2
    assert dev.samples_per_member == jbuf.samples_per_member


def test_sample_batch_and_snapshot_refuse_a_device_buffer(tmp_path):
    cfg = port_test_config(device_replay=True)
    _, dev, _ = port_buffers(cfg, 2)
    with pytest.raises(RuntimeError, match="device_replay"):
        dev.sample_batch(4)
    with pytest.raises(RuntimeError, match="device_replay"):
        dev.write_state(str(tmp_path / "ring.bin"))
    # the device buffer allocates only the count arrays on the host
    assert not hasattr(dev, "obs") and dev.burn_in_steps.shape == (20, 2)


def test_the_dp_layout_needs_the_learner_mesh():
    """Without a mesh the ring is whole and "dp" raises, pointing at
    ``use_mesh``; under one a rank holds its dp slab (layout "dp", one
    group).  Raw densities are the meshed draw's and equal the JAX
    package's; a ring of several slot groups in one process has no
    counterpart (one device per rank)."""
    cfg = port_test_config(device_replay=True)
    assert resolve_layout(cfg) == "replicated"
    with pytest.raises(ValueError, match="use_mesh"):
        resolve_layout(cfg.replace(device_ring_layout="dp"))
    assert resolve_layout(cfg.replace(device_ring_layout="dp"),
                          dict(dp=1)) == "dp"
    slab = DeviceRing(cfg, A, device="cpu", layout="dp")
    assert slab.layout == "dp" and slab.num_groups == 1
    with pytest.raises(ValueError, match="layout"):
        DeviceRing(cfg, A, device="cpu", layout="diagonal")
    _, dev, ring = port_buffers(cfg, 2)
    jbuf, _ = jax_buffer(jax_test_config(device_replay=True), 2)
    got = dev.sample_meta(2, raw_densities=True)
    want = jbuf.sample_meta(2, raw_densities=True)
    for key in ("ints", "is_weights", "idxes"):
        np.testing.assert_array_equal(got[key], want[key])
    ring.num_groups = 2
    with pytest.raises(ValueError, match="one dp group"):
        ReplayBuffer(cfg, A, device_ring=ring)


def test_staging_pads_a_short_block_with_zeros():
    """A partial block (an episode's end) lands zero-padded to the slot
    shape, over whatever the slot held before."""
    cfg = port_test_config(device_replay=True)
    ring = DeviceRing(cfg, A, device="cpu")
    for a in ring.arrays.values():
        a.fill_(7)
    rng = np.random.default_rng(5)
    local = LocalBuffer(cfg, A)
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    for _ in range(3):
        local.add(int(rng.integers(A)), 0.5,
                  rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                  rng.normal(size=A).astype(np.float32),
                  rng.normal(size=(2, 1, cfg.hidden_dim)).astype(np.float32))
    blk, _, _ = local.finish(None)
    ring.commit(ring.stage(blk), 3)
    n = blk.obs.shape[0]
    np.testing.assert_array_equal(ring.arrays["obs"][3, :n].numpy(), blk.obs)
    assert (ring.arrays["obs"][3, n:] == 0).all()
    assert (ring.arrays["hidden"][3, blk.num_sequences:] == 0).all()
    assert (ring.arrays["obs"][2] == 7).all()


# ----------------------------------------------------------- super-step

def test_super_step_matches_jax():
    """k=2 host-sampled super-step from the same params on the same ring
    and bundles as JAX's ``make_super_step_fn``: losses, priorities and
    the params after both steps."""
    jcfg = jax_test_config(device_replay=True)
    cfg = port_test_config(device_replay=True)
    _, dev, ring = port_buffers(cfg, 4)
    jbuf, jring = jax_buffer(jcfg, 4)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(1))
    meta = dev.sample_meta(k=2)

    jstate, jlosses, jprios = jax.jit(jstep.make_super_step_fn(jcfg, jnet, 2))(
        jstep.create_train_state(jcfg, params), jring.snapshot(),
        jnp.asarray(meta["ints"]), jnp.asarray(meta["is_weights"]))
    state = tstep.create_train_state(cfg, flax_to_port(params))
    super_step = tstep.make_super_step_fn(
        cfg, create_network(cfg, A, device="cpu"), 2)
    state, losses, prios = super_step(state, ring.snapshot(),
                                      torch.from_numpy(meta["ints"]),
                                      torch.from_numpy(meta["is_weights"]))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    np.testing.assert_allclose(prios.numpy(), np.asarray(jprios), **LOSS_TOL)
    assert state.step == int(jstate.step) == 2
    ref = flax_to_port(jstate.params)
    for k, v in ref.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)


def test_super_step_equals_sequential_steps_bitwise():
    """k=3 fused steps on the device gathers equal k plain train steps on
    the host ring's batches of the same draws, bit for bit: losses,
    priorities, params, target params and Adam moments (the target syncs
    at step 2 inside the super-step)."""
    cfg = port_test_config(device_replay=True, target_net_update_interval=2)
    host, dev, ring = port_buffers(cfg, 4)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    meta = dev.sample_meta(k=3)

    seq = tstep.create_train_state(cfg, net.state_dict())
    step = tstep.make_train_step(cfg, net)
    seq_losses, seq_prios = [], []
    for j in range(3):
        batch = host.sample_batch()
        np.testing.assert_array_equal(batch["idxes"], meta["idxes"][j])
        seq, loss, prios = step(seq, {k: torch.from_numpy(batch[k])
                                      for k in FIELDS})
        seq_losses.append(loss)
        seq_prios.append(prios)

    fused = tstep.create_train_state(cfg, net.state_dict())
    fused, losses, prios = tstep.make_super_step_fn(cfg, net, 3)(
        fused, ring.snapshot(), torch.from_numpy(meta["ints"]),
        torch.from_numpy(meta["is_weights"]))
    assert torch.equal(losses, torch.stack(seq_losses))
    assert torch.equal(prios, torch.stack(seq_prios))
    assert fused.step == seq.step == 3
    for a, b in ((fused.params, seq.params),
                 (fused.target_params, seq.target_params),
                 (fused.opt_state.mu, seq.opt_state.mu),
                 (fused.opt_state.nu, seq.opt_state.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------------- run_device

def test_run_device_matches_jax_with_cadences_and_drain(tmp_path):
    """12 updates, k=3, from the same params on the same ring and sampler
    seed as JAX's ``Learner.run_device``: the same 12 sink calls (indices
    bitwise, priorities and losses within the learner tolerance),
    publication on the crossings of 4 (+1 at construction), checkpoints on
    the crossings of 5 and the final save, and the pending super-step
    harvested at exit.  One dispatch put of a few hundred bytes and one
    result fetch per dispatch."""
    jcfg = jax_test_config(device_replay=True, training_steps=12,
                           superstep_k=3, weight_publish_interval=4,
                           save_interval=5)
    cfg = port_test_config(device_replay=True, training_steps=12,
                           superstep_k=3, weight_publish_interval=4,
                           save_interval=5)
    jbuf, jring = jax_buffer(jcfg, 4)
    _, dev, ring = port_buffers(cfg, 4)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(5))
    jsunk, sunk = [], []
    JaxLearner(jcfg, jnet, jstep.create_train_state(jcfg, params)).run_device(
        jbuf, jring, priority_sink=lambda i, p, ptr, l: jsunk.append(
            (i.copy(), np.array(p), l)))

    store = ParamStore()
    learner = Learner(cfg, create_network(cfg, A, device="cpu"),
                      tstep.create_train_state(cfg, flax_to_port(params)),
                      param_store=store,
                      checkpointer=Checkpointer(str(tmp_path)))
    HOST_TRANSFERS.reset()
    metrics = learner.run_device(
        dev, ring, priority_sink=lambda i, p, ptr, l: sunk.append(
            (i.copy(), p.copy(), l)))
    assert metrics["num_updates"] == 12 and np.isfinite(metrics["mean_loss"])
    assert len(sunk) == len(jsunk) == 12
    for (i, p, l), (ji, jp, jl) in zip(sunk, jsunk):
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(p, jp, **LOSS_TOL)
        np.testing.assert_allclose(l, jl, **LOSS_TOL)
    assert store.get()[0] == 4
    assert Checkpointer(str(tmp_path)).steps() == [6, 12]
    assert HOST_TRANSFERS.get("learner.dispatch_put") == 4
    assert HOST_TRANSFERS.get("learner.result_fetch") == 4
    assert HOST_TRANSFERS.get("learner.dispatch_put_bytes") == 4 * 3 * 8 * 28


@pytest.mark.parametrize("depth", [0, 3])
def test_run_device_pipeline_depths(depth):
    """Every dispatched sub-batch's priorities reach the sink exactly once
    at any pipeline depth: 0 (synchronous harvest) and deeper than the
    run (the exit drain)."""
    cfg = port_test_config(device_replay=True, training_steps=12,
                           superstep_k=2, superstep_pipeline=depth)
    _, dev, ring = port_buffers(cfg, 4)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(7))
    learner = Learner(cfg, net, tstep.create_train_state(cfg,
                                                         net.state_dict()))
    sunk = []
    metrics = learner.run_device(
        dev, ring, priority_sink=lambda i, p, ptr, l: sunk.append(p.copy()))
    assert metrics["num_updates"] == 12 and len(sunk) == 12
    assert all(np.isfinite(p).all() for p in sunk)


def test_run_device_stop_midway():
    """A stop() between super-steps exits promptly and still harvests the
    in-flight super-step."""
    cfg = port_test_config(device_replay=True, training_steps=1000,
                           superstep_k=2)
    _, dev, ring = port_buffers(cfg, 4)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(6))
    learner = Learner(cfg, net, tstep.create_train_state(cfg,
                                                         net.state_dict()))
    calls, sunk = [], []
    metrics = learner.run_device(
        dev, ring, priority_sink=lambda i, p, ptr, l: sunk.append(1),
        stop=lambda: len(calls) >= 3 or calls.append(1))
    assert metrics["num_updates"] == 2 * 3
    assert len(sunk) == 2 * 3


def test_run_device_waits_for_learning_starts():
    """Below ``learning_starts`` the gate waits (polling stop) and never
    dispatches."""
    cfg = port_test_config(device_replay=True, learning_starts=1000)
    _, dev, ring = port_buffers(cfg, 2)
    net = create_network(cfg, A, device="cpu")
    learner = Learner(cfg, net, tstep.create_train_state(cfg,
                                                         net.state_dict()))
    polls = []
    metrics = learner.run_device(dev, ring,
                                 stop=lambda: len(polls) >= 5
                                 or polls.append(1))
    assert metrics["num_updates"] == 0 and np.isnan(metrics["mean_loss"])


# ---------------------------------------------------------------- train()

def test_train_end_to_end_with_device_replay(tmp_path):
    """The threaded fabric on the device ring with host-sampled PER: every
    update's priorities fed back through the priority thread, no sample
    thread, learner state saved and no replay snapshot; resuming over a
    directory that holds a host-ring replay snapshot warns that the ring
    starts cold."""
    ck = str(tmp_path / "ck")
    host = ttrain.train(cpu_config(device_replay=False, training_steps=4),
                        env_factory=env_factory, checkpoint_dir=ck,
                        verbose=False, device="cpu", max_wall_seconds=120)
    assert host["num_updates"] == 4 and Checkpointer(ck).replay_steps() == [4]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = ttrain.train(cpu_config(superstep_k=2, training_steps=12),
                         env_factory=env_factory, checkpoint_dir=ck,
                         resume=True, verbose=False, device="cpu",
                         max_wall_seconds=120)
    assert any("cold ring" in str(x.message) for x in w)
    assert not m["restored_replay"]
    assert m["num_updates"] == 12 and m["buffer_training_steps"] == 8
    assert np.isfinite(m["mean_loss"]) and not m["fabric_failed"]
    assert "sample" not in m["health"] and "priority" in m["health"]
    assert 12 in Checkpointer(ck).steps()
    assert Checkpointer(ck).replay_steps() == [4]


def test_device_replay_falls_back_to_host_when_ring_too_big(monkeypatch):
    """The capacity guard degrades to host replay with a warning (not a
    crash, not an OOM) when the ring exceeds 80% of the device."""
    monkeypatch.setattr(ttrain, "_device_memory_bytes", lambda device: 1024)
    cfg = cpu_config(superstep_k=2, training_steps=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = ttrain.train(cfg, env_factory=env_factory, verbose=False,
                         device="cpu", max_wall_seconds=120)
    assert any("falling back to host replay" in str(w.message)
               for w in caught)
    assert m["num_updates"] == m["buffer_training_steps"] == 4
    assert "sample" in m["health"] and not m["fabric_failed"]


def test_device_memory_is_the_cards_total(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: calls.append(device) or (1, 80e9))
    assert ttrain._device_memory_bytes(torch.device("cuda", 0)) == 80e9
    assert ttrain._device_memory_bytes(torch.device("cpu")) is None
    assert calls == [torch.device("cuda", 0)]


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """Importing the device-ring slice (and the trainer over it) in a fresh
    interpreter loads no ``jax`` and no ``r2d2_tpu`` module."""
    code = ("import sys\n"
            "import r2d2_tpu_torch.train, r2d2_tpu_torch.replay.device_ring\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'r2d2_tpu.')) or m == 'r2d2_tpu']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
