"""Multi-rank runtime: process bring-up and the per-rank data plane.

Port of ``r2d2_tpu/parallel/distributed.py``.  PyTorch runs one process
per device, so every dp group of the learner mesh is one rank and the
JAX package's *multi-host* path is the port's only meshed path:

- **Bring-up**: :func:`init_distributed` joins the default process group
  from torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo
  when the caller asks for the CPU.  The device is never chosen by what
  happens to be present.
- **Data plane**: replay stays per rank.  ``cfg.batch_size`` is the
  global batch; each rank samples :func:`host_batch_size` rows from its
  own buffer and :func:`host_local_batch` wraps them as this rank's shard
  of one dp-sharded DTensor batch, with no communication.  The step's
  priorities come back through :func:`local_rows` — this rank's rows
  only, so feedback pairs with the indices this rank sampled.
- **Agreement**: :func:`sync_counter` and :func:`sync_min_array` reduce
  small host values over every rank (the learner's stop/ready gate, the
  global min density of a draw, the ring decision).  With a process group
  they always reduce, even over one rank: a world of one issues the same
  collectives as a world of eight.

Every collective here must run on the learner's thread: a collective one
rank issues and its peer does not hangs both, and only the learner thread
runs in lockstep with its peers.  :func:`bind_learner_thread` names that
thread; a collective from any other thread raises.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from r2d2_tpu_torch.parallel.sharding import DEVICE_BATCH_KEYS, ShardingTable

# collectives issued per call site, for the checks that a run made exactly
# the agreement it should ("gate", "min_density", ...)
COLLECTIVE_CALLS: collections.Counter = collections.Counter()

_learner_thread: Optional[threading.Thread] = None


def bind_learner_thread(thread: Optional[threading.Thread] = None) -> None:
    """Make ``thread`` (default: the caller) the one thread allowed to
    issue this module's collectives; ``None`` after :func:`unbind`."""
    global _learner_thread
    _learner_thread = thread or threading.current_thread()


def unbind_learner_thread() -> None:
    global _learner_thread
    _learner_thread = None


def _check_thread() -> None:
    t = _learner_thread
    if t is not None and threading.current_thread() is not t:
        raise RuntimeError(
            f"collective issued from thread "
            f"{threading.current_thread().name!r}; only the learner thread "
            f"({t.name!r}) may call into torch.distributed")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:LOCAL_RANK``
    (raises when no card is visible: no silent CPU fallback)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this rank needs a CUDA device and none is visible; pass "
            "device='cpu' to run the rank on the CPU (gloo)")
    return torch.device("cuda", _env_int("LOCAL_RANK") or 0)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, auto: bool = False,
                     device=None, store: Any = None) -> Dict[str, Any]:
    """Join (or create) the default process group.

    Arguments default to torchrun's variables (``WORLD_SIZE``, ``RANK``;
    ``init_method`` to ``env://``, which reads ``MASTER_ADDR`` and
    ``MASTER_PORT``); ``store`` (a ``FileStore``/``TCPStore``) replaces
    the rendezvous.  With nothing configured and ``auto=False`` (the
    library default) it is a no-op, so single-process use needs no
    guards; with ``auto=True`` and nothing configured it raises — an
    explicit distributed request never quietly becomes N independent
    runs.  The backend follows the device (:func:`rank_device`): NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU.

    Returns ``{"process_id": rank, "process_count": world_size}``, as
    the JAX package does."""
    if dist.is_initialized():
        return dict(process_id=dist.get_rank(),
                    process_count=dist.get_world_size())
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    configured = (store is not None or init_method is not None
                  or world_size is not None)
    if not configured:
        if auto:
            raise RuntimeError(
                "distributed bring-up requested but nothing is configured: "
                "launch under torchrun (RANK, WORLD_SIZE, LOCAL_RANK, "
                "MASTER_ADDR, MASTER_PORT) or pass init_method/store, "
                "world_size and rank")
        return dict(process_id=0, process_count=1)
    if world_size is None or rank is None:
        raise RuntimeError("init_distributed needs both a world size and a "
                           "rank (WORLD_SIZE and RANK under torchrun)")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = dict(backend=backend, world_size=world_size, rank=rank)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dict(process_id=rank, process_count=world_size)


def _collective_device() -> torch.device:
    """Where the small agreement tensors live: the current card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _dp_coordinate(mesh) -> int:
    return mesh.get_coordinate()[mesh.mesh_dim_names.index("dp")]


def owned_dp_groups(mesh) -> slice:
    """The dp groups this rank owns: one, its own dp coordinate.

    Raises (JAX's topology rule) when a dp group spans several ranks —
    any fsdp or tp axis larger than 1 in a world of several ranks, since
    a rank holds one device: the group's ranks would each sample their
    own rows for one shard of the batch."""
    names = mesh.mesh_dim_names
    spread = mesh.size() // mesh.size(names.index("dp"))
    if spread > 1:
        raise RuntimeError(
            f"each dp group spans {spread} ranks (fsdp × tp); the per-rank "
            "data plane needs every dp group on one rank, as the JAX "
            "package's multi-host data plane does: train with a dp-only "
            "mesh_shape (the meshed step itself runs at any layout)")
    c = _dp_coordinate(mesh)
    return slice(c, c + 1)


def dp_rows_for_process(mesh, global_batch: int) -> slice:
    """The contiguous rows of the global batch this rank's dp group owns
    (raises, as :func:`owned_dp_groups`, when the group spans ranks)."""
    owned = owned_dp_groups(mesh)
    per = global_batch // mesh.size(mesh.mesh_dim_names.index("dp"))
    return slice(owned.start * per, owned.stop * per)


def host_batch_size(cfg, mesh) -> int:
    """How many rows of the global ``cfg.batch_size`` this rank samples
    from its own replay buffer."""
    rows = dp_rows_for_process(mesh, cfg.batch_size)
    return rows.stop - rows.start


def host_local_batch(mesh, local_batch: Dict[str, Any],
                     shardings: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The dp-sharded DTensor batch from this rank's rows
    (``host_batch_size`` of them; numpy or tensors, moved to the mesh's
    device): no data crosses ranks."""
    from torch.distributed.tensor import DTensor

    from r2d2_tpu_torch.parallel.sharding import _mesh_device

    if shardings is None:
        shardings = ShardingTable(mesh).batch_shardings()
    device = _mesh_device(mesh)
    out = {}
    for k in DEVICE_BATCH_KEYS:
        v = local_batch[k]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = DTensor.from_local(t.to(device), mesh, list(shardings[k]))
    return out


def local_rows(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a tensor sharded over dp along ``axis``, as a
    plain tensor: the rank's dp shard, without duplicates over the
    replicated axes.  A plain tensor is returned as it is (it already
    holds this rank's rows).  A DTensor in another layout is first
    redistributed (collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    want = [Shard(axis) if n == "dp" else Replicate() for n in names]
    if list(t.placements) != want:
        t = t.redistribute(placements=want)
    return t.to_local()


def global_from_local_rows(mesh, local_data: Any, global_shape: tuple,
                           axis: int, offset: int):
    """This rank's rows ``[offset, offset + n)`` of ``axis`` (replicated
    over the other mesh axes) as its shard of a dp-sharded DTensor of
    ``global_shape`` — the (k, B, 6) index bundles shard axis 1."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from r2d2_tpu_torch.parallel.sharding import _mesh_device

    t = local_data if isinstance(local_data, torch.Tensor) else (
        torch.from_numpy(np.ascontiguousarray(local_data)))
    n = t.shape[axis]
    if offset != _dp_coordinate(mesh) * n or n * mesh.size(
            mesh.mesh_dim_names.index("dp")) != global_shape[axis]:
        raise ValueError(
            f"rows [{offset}, {offset + n}) of axis {axis} are not this "
            f"rank's dp shard of {global_shape}")
    pl = [Shard(axis) if name == "dp" else Replicate()
          for name in mesh.mesh_dim_names]
    return DTensor.from_local(t.to(_mesh_device(mesh)), mesh, pl,
                              shape=torch.Size(global_shape),
                              stride=torch.empty(global_shape,
                                                 device="meta").stride())


_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "sum": dist.ReduceOp.SUM}


def sync_counter(value: int, reduce: str = "max", tag: str = "counter"
                 ) -> int:
    """All-rank reduction (``"max"``, ``"min"`` or ``"sum"``) of a host
    counter; the identity with no process group."""
    if reduce not in _OPS:
        raise ValueError(f"unknown reduce {reduce!r}")
    if not dist.is_initialized():
        return int(value)
    _check_thread()
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_collective_device())
    dist.all_reduce(t, op=_OPS[reduce])
    COLLECTIVE_CALLS[tag] += 1
    return int(t.item())


def sync_min_array(values: Any, tag: str = "min_array") -> np.ndarray:
    """Element-wise min of a small float64 array over every rank (the
    learner's gate flags, a draw's global min density); the identity with
    no process group."""
    values = np.asarray(values, np.float64)
    if not dist.is_initialized():
        return values
    _check_thread()
    t = torch.from_numpy(values.copy()).to(_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    COLLECTIVE_CALLS[tag] += 1
    return t.cpu().numpy()
