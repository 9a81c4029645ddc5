"""r2d2_tpu_torch — the PyTorch/CUDA port of ``r2d2_tpu``.

A second package beside the JAX one, laid out like it so each counterpart
is easy to find.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``r2d2_tpu``: it keeps its own copies of the jax-free modules
it needs.  Its entry points run on the CUDA device unless the caller
passes ``device="cpu"``.

Ported so far: the session-serving path (``serving/``) over the R2D2
network (``models/``) with the fused LSTM inference unroll as a
hand-written Hopper kernel (``ops/lstm.py``, ``csrc/lstm_infer.cu``), and
the training path (``train.train_sync`` and the threaded ``train.train``:
actors, replay on the host or on the device, learner, checkpoints,
evaluation), whose actors act through that kernel, anakin, the fused
on-device loop on a batched device env (``actor_transport="anakin"``,
``learner/anakin.py``), the process fleets with the centralized
inference service (``actor_transport="process"``, ``parallel/``), and the
sharded replay plane over shared memory or TCP (``replay_shards > 1``,
``replay_transport="socket"``, ``parallel/replay_shards.py``,
``parallel/replay_net.py``).  ROADMAP.md lists what comes next.
"""
from r2d2_tpu_torch.config import Config, test_config

__all__ = ["Config", "test_config"]
