"""Process planes of the port: the subprocess actor fleets, the
centralized inference service, and the sharded replay plane over shared
memory or TCP (``actor_procs``, ``inference_service``, ``replay_shards``,
``replay_net``).

The reference's ``parallel/__init__`` also exports the mesh, sharding and
multi-host modules; those wait for ROADMAP.md A item 7.  The exports load
on first use, so a replay shard child imports its own module and the
numpy replay core, never torch.
"""
import importlib

_EXPORTS = {
    "CorruptBlockError": "actor_procs",
    "FleetStopped": "actor_procs",
    "ProcessFleetPlane": "actor_procs",
    "ShmBlockChannel": "actor_procs",
    "ShmBlockProducer": "actor_procs",
    "ActChannel": "inference_service",
    "InferenceService": "inference_service",
    "RemoteActClient": "inference_service",
    "act_slot_spec": "inference_service",
    "SHARD_STAT_FIELDS": "replay_shards",
    "ShardedReplayPlane": "replay_shards",
    "allocate_strata": "replay_shards",
    "NET_STAT_FIELDS": "replay_net",
    "NetShardedReplayPlane": "replay_net",
    "ShardLink": "replay_net",
    "ShardServer": "replay_net",
    "run_shard_server": "replay_net",
    "shard_slice_config": "replay_net",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(mod, name)
