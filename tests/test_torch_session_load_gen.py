"""The port's session load generator, on the CPU.

``run_load`` drives a CPU ``SessionServer`` at test size with both
session chaos sites armed: the store's accounting holds exactly, the
disconnect reap covers what the kills abandoned, the worker counters
equal the injector's fires, and the fires equal what the JAX package's
``ChaosInjector`` gives for the same spec, seed and opportunities (both
injectors draw per-kind streams, so the interleaving of the workers'
calls does not matter).  ``main`` runs both cells at the flagship width
for a second each.
"""
import json

import numpy as np
import pytest
import torch

from r2d2_tpu.utils.chaos import ChaosInjector as JaxChaosInjector
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.models import create_network
from r2d2_tpu_torch.serving.server import SessionServer
from r2d2_tpu_torch.tools import session_load_gen as slg
from r2d2_tpu_torch.utils.chaos import ChaosInjector

A = 4
SPECS = {
    "every": "kill_session_client:every=40,n=1000;"
             "slow_session_client:every=23,dur=0.3,n=1000",
    "p": "kill_session_client:p=0.02;slow_session_client:p=0.05,dur=0.2",
}


@pytest.fixture
def server():
    cfg = port_test_config(act_device="cpu", serve_max_sessions=24,
                           serve_max_batch=16, serve_session_idle_s=3.0,
                           serve_request_deadline=5.0)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    srv = SessionServer(cfg, A, device="cpu")
    srv.publish_params(net.state_dict())
    srv.warmup()
    srv.start()
    try:
        yield cfg, srv
    finally:
        srv.stop()
        srv.close()


@pytest.mark.parametrize("spec", list(SPECS))
def test_run_load_under_chaos_keeps_the_accounting(spec, server):
    cfg, srv = server
    chaos = ChaosInjector(SPECS[spec], seed=7)
    out = slg.run_load(cfg, A, srv.host, srv.port, sessions=40, workers=3,
                       steps_mean=6, think_s=0.002, run_seconds=3.0,
                       call_timeout=10.0, seed=3, chaos=chaos)
    s = srv.stats()
    assert s["admitted"] == s["completed"] + s["reaped"] + s["evicted"] + \
        s["live"]
    assert not out["workers_failed"] and out["client_errors"] == 0
    assert out["acts"] > 0 and out["completed"] > 0
    fires = chaos.counts()
    assert out["kills"] == fires.get("kill_session_client", 0)
    assert out["slow"] == fires.get("slow_session_client", 0)
    assert out["kills"] > 0 and out["slow"] > 0
    # the disconnect reap frees what the kills abandoned (a session
    # evicted before its owner died was already freed by the LRU)
    assert s["reaped"] > 0
    # offered 40 sessions (and replacements) against a budget of 24
    assert s["evicted"] > 0
    assert srv.healthz()["status"] != "failing"
    # the same opportunities through the JAX package's injector
    ref = JaxChaosInjector(SPECS[spec], seed=7)
    for kind, n in chaos._opportunities.items():
        for _ in range(n):
            ref.fire(kind)
    assert ref.counts() == fires


def test_publish_client_percentiles_reaches_the_registry(server):
    cfg, srv = server
    slg._publish_client_percentiles(srv.registry, dict(
        act_p50_ms=1.5, act_p95_ms=2.5, act_p99_ms=3.5,
        sessions_per_sec=4.0))
    assert srv.registry.get_gauge("serving.client.act_p99_ms") == 3.5
    assert srv.registry.get_gauge("serving.client.sessions_per_sec") == 4.0


def test_cells_serve_in_their_dtype():
    """The float32 cell computes in float32 (so on the card its LSTM takes
    the f32 route, ``lstm_step_cudacore``), the bfloat16 cell in bf16 with
    quantized params (``lstm_step_wgmma``); both at the flagship width."""
    f32, bf16 = (slg.cell_config(d, 64, 192) for d in slg.CELLS)
    assert (f32.compute_dtype, f32.serve_dtype) == ("float32", "float32")
    assert (bf16.compute_dtype, bf16.serve_dtype) == ("bfloat16", "bfloat16")
    for c in (f32, bf16):
        assert (c.torso, c.hidden_dim, c.obs_space_to_depth) == (
            "nature", 512, True)
        assert c.serve_max_sessions == 192 and c.serve_max_batch == 64


def test_main_runs_both_cells_and_prints_their_lines(capsys):
    rc = slg.main(["--device", "cpu", "--sessions", "12", "--workers", "2",
                   "--seconds", "1", "--max-batch", "8", "--max-sessions",
                   "8", "--steps-mean", "3", "--think-ms", "1",
                   "--chaos", "kill_session_client:every=30;"
                              "slow_session_client:every=17,dur=0.2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 0
    cells, summary = lines[:2], lines[2]
    assert [c["serve_dtype"] for c in cells] == list(slg.CELLS)
    for c in cells:
        assert c["accounting_ok"] and c["health"] != "failing"
        assert c["client"]["acts"] > 0
        assert c["kernel_launches"] == {}      # the CPU launches no kernel
        assert c["warmup_batches"] == 4        # buckets 1, 2, 4, 8
    assert summary["cells"] == 2 and summary["device"] == "cpu"
    assert np.isfinite(summary["f32_p99_ms"])
