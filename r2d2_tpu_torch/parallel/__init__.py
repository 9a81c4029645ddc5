"""Process planes and the learner mesh of the port: the subprocess actor
fleets, the centralized inference service, the sharded replay plane over
shared memory or TCP (``actor_procs``, ``inference_service``,
``replay_shards``, ``replay_net``), and the learner's device mesh, its
sharding table and the multi-rank runtime (``mesh``, ``sharding``,
``distributed``).

The exports load on first use, so a replay shard child imports its own
module and the numpy replay core, never torch, and a fleet child never
imports torch's distributed stack.
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
    "AXES": "mesh",
    "make_mesh": "mesh",
    "trivial_mesh": "mesh",
    "DEVICE_BATCH_KEYS": "sharding",
    "ShardingTable": "sharding",
    "UnresolvedShardingError": "sharding",
    "mesh_super_step": "sharding",
    "mesh_train_step": "sharding",
    "shard_batch": "sharding",
    "host_batch_size": "distributed",
    "host_local_batch": "distributed",
    "init_distributed": "distributed",
    "local_rows": "distributed",
    "sync_counter": "distributed",
    "sync_min_array": "distributed",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(mod, name)
