"""Session-serving tier: the Q-network as a product (port of
``r2d2_tpu/serving``).  See ``serving/server.py`` for the composition.

The exports load on first use, so a process that needs only the frame
grammar (``serving/wire.py``: the replay shard servers) never imports
torch."""
import importlib

_EXPORTS = {
    "AdmissionController": "admission",
    "Request": "admission",
    "ContinuousBatcher": "batcher",
    "bucket_sizes": "batcher",
    "SessionClient": "client",
    "SessionClientError": "client",
    "SessionServer": "server",
    "follow_params_once": "server",
    "run_server": "server",
    "SessionStore": "store",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(mod, name)
