"""Session-serving tier: the Q-network as a product (port of
``r2d2_tpu/serving``).  See ``serving/server.py`` for the composition."""
from r2d2_tpu_torch.serving.admission import AdmissionController, Request
from r2d2_tpu_torch.serving.batcher import ContinuousBatcher, bucket_sizes
from r2d2_tpu_torch.serving.client import SessionClient, SessionClientError
from r2d2_tpu_torch.serving.server import (
    SessionServer,
    follow_params_once,
    run_server,
)
from r2d2_tpu_torch.serving.store import SessionStore

__all__ = [
    "AdmissionController",
    "ContinuousBatcher",
    "Request",
    "SessionClient",
    "SessionClientError",
    "SessionServer",
    "SessionStore",
    "bucket_sizes",
    "follow_params_once",
    "run_server",
]
