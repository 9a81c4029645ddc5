"""The port's command line against the JAX package's, on the CPU.

``r2d2_tpu_torch.cli`` must offer every subcommand and option of
``r2d2_tpu.cli`` with the same dest, default and choices, plus only
``--device``; ``build_config`` must give a ``Config`` equal field for
field; the train → eval round trip must give JAX's record keys and step
list (tests/test_cli.py:57); ``bench`` goes to the isolated path; and
``python -m r2d2_tpu_torch`` imports neither JAX nor the JAX package.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from r2d2_tpu import cli as jcli
from r2d2_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ("train", "serve", "replay-shard", "eval", "bench", "sweep")
# the one option the port adds, on the subcommands that run an entry point
DEVICE_SUBCOMMANDS = ("train", "serve", "replay-shard", "eval", "sweep")
CPU = ["--device", "cpu", "--set", "act_device=cpu"]


class _Captured(Exception):
    pass


def captured_parser(monkeypatch, main) -> argparse.ArgumentParser:
    """The parser ``main`` builds, taken at its ``parse_args`` call (the
    JAX package builds its parser inside ``main``)."""
    held = {}

    def grab(self, args=None, namespace=None):
        held["parser"] = self
        raise _Captured

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Captured):
            main([])
    return held["parser"]


def option_table(parser: argparse.ArgumentParser) -> dict:
    """option strings → (dest, default, choices, type, required, nargs,
    action class) for every optional and positional argument."""
    return {tuple(a.option_strings) or (a.dest,): (
        a.dest, a.default, tuple(a.choices) if a.choices else None,
        getattr(a.type, "__name__", a.type), a.required, a.nargs,
        type(a).__name__) for a in parser._actions
        if not isinstance(a, argparse._HelpAction)}


def subparsers(parser: argparse.ArgumentParser) -> dict:
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return dict(sub.choices)


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_parser_matches_jax_plus_device(cmd, monkeypatch):
    jsub = subparsers(captured_parser(monkeypatch, jcli.main))
    tsub = subparsers(captured_parser(monkeypatch, tcli.main))
    assert set(tsub) == set(jsub) == set(SUBCOMMANDS)
    want = option_table(jsub[cmd])
    got = option_table(tsub[cmd])
    if cmd in DEVICE_SUBCOMMANDS:
        device = got.pop(("--device",))
        assert device[:3] == ("device", "cuda", ("cuda", "cpu"))
    assert got == want


class _Args:
    def __init__(self, **kw):
        self.preset = kw.pop("preset", "default")
        self.game = kw.pop("game", None)
        self.actors = kw.pop("actors", None)
        self.seed = kw.pop("seed", None)
        self.training_steps = kw.pop("training_steps", None)
        self.overrides = kw.pop("overrides", None)
        self.actor_transport = kw.pop("actor_transport", None)
        self.actor_inference = kw.pop("actor_inference", None)
        assert not kw


OVERRIDES = ["lr=5e-5", "batch_size=32", "torso=impala", "remat=true",
             'mesh_shape=[["dp", 4]]', "param_dtype=bfloat16",
             "serve_dtype=bfloat16", "actor_fleets=1"]
CONFIG_CASES = [
    *(dict(preset=p, game="Breakout" if p == "atari57" else None)
      for p in sorted(jcli._PRESETS)),
    dict(preset="pong", actors=4, seed=3, training_steps=7,
         overrides=[jcli._parse_override("lr=5e-5")]),
    dict(preset="hard_exploration", actors=2),
    dict(preset="hard_exploration", actors=8, game="Pitfall",
         overrides=[jcli._parse_override("actor_fleets=1")]),
    dict(preset="test", actor_transport="process",
         actor_inference="serve", actors=4),
]


@pytest.mark.parametrize("kw", CONFIG_CASES,
                         ids=[f"{c['preset']}{i}"
                              for i, c in enumerate(CONFIG_CASES)])
def test_build_config_matches_jax(kw):
    want = jcli.build_config(_Args(**kw))
    got = tcli.build_config(_Args(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kv", OVERRIDES)
def test_parse_override_matches_jax(kv):
    assert tcli._parse_override(kv) == jcli._parse_override(kv)
    name, value = tcli._parse_override(kv)
    got = tcli.build_config(_Args(preset="test", overrides=[(name, value)]))
    want = jcli.build_config(_Args(preset="test", overrides=[(name, value)]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_parse_override_rejects_unknown():
    with pytest.raises(argparse.ArgumentTypeError):
        tcli._parse_override("not_a_field=3")
    with pytest.raises(argparse.ArgumentTypeError):
        tcli._parse_override("no_equals_sign")


def last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


def test_cli_train_then_eval_round_trip_matches_jax(tmp_path, capsys):
    """The same two commands through both packages (tests/test_cli.py:57):
    the same metrics keys, and an eval curve with the same record keys and
    step list."""
    common = ["--preset", "test", "--game", "Fake", "--sync",
              "--training-steps", "4", "--set", "save_interval=2"]
    curves = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, CPU)):
        ckpt = str(tmp_path / name)
        assert main(["train", *common, "--ckpt-dir", ckpt, *extra]) == 0
        metrics = last_json(capsys.readouterr().out)
        assert metrics["num_updates"] == 4
        out_json = str(tmp_path / f"{name}.json")
        assert main(["eval", "--preset", "test", "--game", "Fake",
                     "--ckpt-dir", ckpt, "--episodes", "2",
                     "--out-json", out_json, *extra]) == 0
        printed = [json.loads(line) for line in
                   capsys.readouterr().out.strip().splitlines()]
        with open(out_json) as f:
            curves[name] = json.load(f)
        assert printed == curves[name]
        curves[name + "_metrics"] = set(metrics)
    assert [c["step"] for c in curves["port"]] == [
        c["step"] for c in curves["jax"]] == [2, 4]
    assert [set(c) for c in curves["port"]] == [set(c)
                                                for c in curves["jax"]]
    assert curves["port_metrics"] <= curves["jax_metrics"] | {"device"}


def test_cli_eval_env_uses_noop_start(tmp_path, monkeypatch):
    """Eval protocol parity with the reference (test.py:16): eval envs must
    randomize start states via noop starts, same as training envs."""
    ckpt = str(tmp_path / "ckpt")
    tcli.main(["train", "--preset", "test", "--game", "Fake", "--sync",
               "--training-steps", "1", "--ckpt-dir", ckpt, *CPU])

    import r2d2_tpu_torch.envs as envs_pkg

    seen = []
    real_create = envs_pkg.create_env

    def spy(cfg, noop_start=True, seed=None, **kw):
        seen.append(noop_start)
        return real_create(cfg, noop_start=noop_start, seed=seed, **kw)

    monkeypatch.setattr(envs_pkg, "create_env", spy)
    tcli.main(["eval", "--preset", "test", "--game", "Fake",
               "--ckpt-dir", ckpt, "--episodes", "1", *CPU])
    assert seen and all(seen), "eval env built without noop_start=True"


@pytest.mark.parametrize("cmd", ["train", "eval"])
def test_cuda_is_the_default_device(cmd, tmp_path, monkeypatch):
    """Without --device cpu the entry points act on the CUDA device and
    raise without one; they never move to the CPU by themselves."""
    import torch

    ckpt = str(tmp_path / "ckpt")
    tcli.main(["train", "--preset", "test", "--game", "Fake", "--sync",
               "--training-steps", "1", "--ckpt-dir", ckpt, *CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train": ["train", "--preset", "test", "--game", "Fake",
                      "--sync", "--training-steps", "1"],
            "eval": ["eval", "--preset", "test", "--game", "Fake",
                     "--ckpt-dir", ckpt, "--episodes", "1"]}[cmd]
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(argv)
    if cmd == "train":
        # --device cpu puts the learner there; its actors still act where
        # act_device says (the card) until --set act_device=cpu
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv + ["--device", "cpu"])


def test_cli_bench_routes_to_isolated_script_main(monkeypatch):
    """`bench` goes through the phase-isolated script path (a wedged phase
    then times out bounded), not the in-process bench.main()."""
    from r2d2_tpu_torch import bench

    calls = []
    monkeypatch.setattr(bench, "_script_main",
                        lambda argv: calls.append(argv) or 0)
    assert tcli.main(["bench", "--steps", "7"]) == 0
    assert calls == [["7"]]


@pytest.mark.parametrize("argv", [
    ["--shard-id", "2", "--replay-shards", "2"],
    ["--shard-id", "-1"],
    ["--shard-id", "1"],            # the test preset has one shard
])
def test_replay_shard_id_outside_range_is_an_argparse_error(argv, capsys):
    with pytest.raises(SystemExit) as ex:
        tcli.main(["replay-shard", "--preset", "test", "--game", "Fake",
                   "--port", "0", *argv])
    assert ex.value.code == 2
    assert "outside" in capsys.readouterr().err


def test_replay_shard_serves_then_stops_on_its_wall_budget(capsys):
    """``replay-shard`` binds an ephemeral port, prints it, serves until
    its wall budget and prints its counter summary."""
    assert tcli.main(["replay-shard", "--preset", "test", "--game", "Fake",
                      "--port", "0", "--replay-shards", "2",
                      "--shard-id", "1", "--action-dim", "4",
                      "--max-wall-seconds", "0.5", "--quiet"]) == 0
    summary = last_json(capsys.readouterr().out)
    assert summary["shard"] == 1 and summary["port"] > 0
    assert summary["blocks"] == 0


def test_serve_needs_a_checkpoint_dir(capsys):
    with pytest.raises(SystemExit) as ex:
        tcli.main(["serve", "--preset", "test", *CPU])
    assert ex.value.code == 2


def test_module_help_imports_no_jax():
    """``python -m r2d2_tpu_torch --help`` in a fresh interpreter: the
    port's whole command line loads without JAX or the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['r2d2_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('r2d2_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "import r2d2_tpu_torch.cli, r2d2_tpu_torch.bench, "
            "r2d2_tpu_torch.sweep\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'r2d2_tpu' or "
            "m.startswith('r2d2_tpu.'))\n"
            "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "train,serve,replay-shard,eval,bench,sweep" in out.stdout
    assert "LEAKED []" in out.stdout
