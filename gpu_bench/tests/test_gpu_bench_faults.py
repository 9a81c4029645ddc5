"""The check fails what it must.  Runs of the harness on the CPU at test
sizes (``tiny.py``), the look for a card skipped, with the port broken
underneath, must come out not correct under a real cell's limits: a step
that leaves the state unchanged, a loss over half of the batch, an act
whose answer is altered where it is produced.  (The cells run on one
card, so there is no exchange between cards to leave out.)  And the
control — the reference in fp8 in the port's place — must read far above
the port; on a card, at a cell's own size, it must fail the cell's
limits."""
from __future__ import annotations

import pytest
import torch

import tiny
from gpu_bench import cells, check
from gpu_bench.harness import run_loaded

SEED = 2 ** 32 + 3
CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def _run(ring: bool, limits_of: str, **kw):
    return run_loaded(tiny.cell(ring, limits_of=limits_of), SEED, 1.0,
                      False, device="cpu", **kw)


def _frozen_step(monkeypatch):
    from r2d2_tpu_torch.learner import step

    def update(self, grads, state, params, updates=None):
        state.count += 1
        state.count_t.add_(1)

    monkeypatch.setattr(step.Optimizer, "update", update)


def _half_batch(monkeypatch):
    from r2d2_tpu_torch.learner import step

    orig = step.loss_and_priorities

    def half(cfg, net, params, target_params, batch, with_aux=False):
        n = batch["learning"].shape[0] // 2
        out = orig(cfg, net, params, target_params,
                   {k: v[:n] for k, v in batch.items()}, with_aux)
        # the rows left out get no priority
        prios = torch.cat([out[1], torch.zeros_like(out[1])])
        return (out[0], prios) + tuple(out[2:])

    monkeypatch.setattr(step, "loss_and_priorities", half)


def _altered_act(monkeypatch):
    from r2d2_tpu_torch import actor

    orig = actor.make_act_fn

    def make(net, *args, **kwargs):
        act = orig(net, *args, **kwargs)

        def altered(*a):
            q, h = act(*a)
            q = q.clone()
            q[0, 0] += 1.0
            return q, h

        return altered

    monkeypatch.setattr(actor, "make_act_fn", make)


FAULTS = {"unchanged_state": _frozen_step, "half_batch": _half_batch,
          "altered_act": _altered_act}


@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_port_is_not_correct(monkeypatch, fault, ring):
    limits_of = CELLS[1] if ring else CELLS[0]
    FAULTS[fault](monkeypatch)
    res = _run(ring, limits_of)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_control_reads_far_above_the_port(ring):
    res = _run(ring, None, extra=True)
    assert res["correct"], res["checks"]
    cal = res["calibration"]
    for name, v in cal["control"].items():
        assert v > 100 * max(cal["program"][name], 1e-9), (name, cal)
    for name, v in cal["half_batch"].items():
        assert v > 100 * max(cal["program"][name], 1e-9), (name, cal)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_on_a_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    cell = cells.load_cell(name)
    res = run_loaded(cell, SEED, 2.0, False, extra=True)
    ok, _ = check.judge(dict(res["calibration"]["program"],
                             **res["calibration"]["control"]),
                        cell["cell_file"]["limits"])
    assert res["correct"] and not ok, res["calibration"]
