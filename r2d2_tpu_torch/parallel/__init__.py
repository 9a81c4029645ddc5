"""Process planes of the port: the subprocess actor fleets and the
centralized inference service (``actor_procs``, ``inference_service``).

The reference's ``parallel/__init__`` also exports the mesh, sharding and
multi-host modules; those wait for ROADMAP.md A item 7, and the replay
shard and socket planes for item 8b.
"""
from r2d2_tpu_torch.parallel.actor_procs import (
    CorruptBlockError,
    FleetStopped,
    ProcessFleetPlane,
    ShmBlockChannel,
    ShmBlockProducer,
)
from r2d2_tpu_torch.parallel.inference_service import (
    ActChannel,
    InferenceService,
    RemoteActClient,
    act_slot_spec,
)

__all__ = [
    "ActChannel",
    "CorruptBlockError",
    "FleetStopped",
    "InferenceService",
    "ProcessFleetPlane",
    "RemoteActClient",
    "ShmBlockChannel",
    "ShmBlockProducer",
    "act_slot_spec",
]
