"""A cell at test sizes on the CPU, for the benchmark's own tests: the
port's ``test_config`` widths (mlp torso, 12x12 frames, H=16, float32),
four actor lanes, host replay or the replay ring with in-graph PER, and
the limits of a real cell's file."""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpu_bench import cells  # noqa: E402

SETTINGS = dict(game_name="Fake", torso="mlp", obs_shape=[12, 12, 1],
                hidden_dim=16, compute_dtype="float32", batch_size=8,
                burn_in_steps=4, learning_steps=4, forward_steps=2,
                block_length=8, buffer_capacity=320, learning_starts=64,
                act_device="cpu", lstm_impl="scan")


def cell(ring: bool, limits_of: str = None, **settings) -> dict:
    """The tiny cell; ``limits_of`` names the real cell whose limits it
    takes (default: loose limits that any sound run meets)."""
    program = dict(actor_transport="thread", num_actors=4, actor_fleets=1,
                   env_workers=0, device_replay=ring, in_graph_per=ring,
                   superstep_k=2 if ring else 8, superstep_pipeline=1,
                   prefetch_batches=0 if ring else 2,
                   training_steps=10 ** 9, replay_snapshot=False,
                   telemetry_port=0, log_interval=10.0)
    if limits_of is None:
        limits = dict(start_gap=0.0, prio_gap=1e-4, grad_gap=1e-4,
                      dparam_gap=1e-3, act_q_gap=1e-5, act_h_gap=1e-5,
                      act_params_gap=0.0)
        if ring:
            limits["bad_draws"] = 0.0
    else:
        limits = cells.load_cell(limits_of)["cell_file"]["limits"]
    bench = cells.benchmark()
    return dict(name=bench["workloads"][0]["name"], config="tiny",
                traffic="tiny", chips=1,
                config_file=dict(preset="test_config",
                                 settings=dict(SETTINGS, **settings),
                                 arith="r2d2"),
                traffic_file=dict(program=program,
                                  env=dict(name="fake", episode_len=20,
                                           actions=4),
                                  setup_limit_s=60, trace_seconds=1),
                cell_file=dict(check=dict(acts=4, act_window=20, rows=4),
                               limits=limits),
                bench=bench)
