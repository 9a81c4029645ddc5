"""A cell from its files: ``BENCHMARK.json`` names the cell's
configuration and traffic; ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``workloads/<cell>.json`` hold them.  A
later cell, configuration or traffic mix is new files: nothing here lists
them."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def metric_names(bench: Dict[str, Any], section: str, cell: str
                 ) -> List[Dict[str, Any]]:
    """The ``section`` metrics ("end_to_end" or "per_layer") that
    ``cell`` reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str) -> Dict[str, Any]:
    """The cell's entry of BENCHMARK.json with its configuration file
    (``config_file``), traffic file (``traffic_file``) and its own file
    (``cell_file``) read."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return dict(entry,
                config_file=_load(os.path.join(ROOT, conf["file"])),
                traffic_file=_load(os.path.join(HERE, "traffic",
                                                entry["traffic"] + ".json")),
                cell_file=_load(os.path.join(HERE, "workloads",
                                             name + ".json")),
                bench=bench)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def build_config(cell: Dict[str, Any], seed: int):
    """The port's ``Config`` for the cell: the configuration's preset and
    settings, then the traffic's program settings, and the run's seed.
    Raises when the traffic would change a setting of the configuration,
    or when the config as built differs from the configuration's file."""
    from r2d2_tpu_torch import config as config_mod

    conf, traffic = cell["config_file"], cell["traffic_file"]
    settings = {k: _tuples(v) for k, v in conf["settings"].items()}
    program = {k: _tuples(v) for k, v in traffic["program"].items()}
    clash = set(settings) & set(program)
    if clash:
        raise ValueError(f"traffic {cell['traffic']!r} changes the "
                         f"configuration's {sorted(clash)}")
    preset = getattr(config_mod, conf["preset"])
    cfg = preset(**settings, **program, seed=seed)
    for k, v in {**settings, **program}.items():
        if getattr(cfg, k) != v:
            raise ValueError(f"config key {k}: built {getattr(cfg, k)!r}, "
                             f"file says {v!r}")
    return cfg


def arch_of(cfg, action_dim: int) -> Dict[str, Any]:
    """The reference's sizes of the network ``cfg`` runs."""
    return dict(torso=cfg.torso, obs=tuple(cfg.stored_obs_shape),
                s2d=bool(cfg.obs_space_to_depth), hidden=cfg.hidden_dim,
                layers=cfg.lstm_layers, actions=action_dim)


def hyper_of(cfg) -> Dict[str, Any]:
    """The numbers the reference's update, draw and gather take."""
    return dict(lr=cfg.lr, adam_eps=cfg.adam_eps, grad_norm=cfg.grad_norm,
                forward_steps=cfg.forward_steps,
                learning_steps=cfg.learning_steps, seq_len=cfg.seq_len,
                block_length=cfg.block_length,
                seqs_per_block=cfg.seqs_per_block,
                importance_sampling_exponent=(
                    cfg.importance_sampling_exponent),
                prio_exponent=cfg.prio_exponent)
