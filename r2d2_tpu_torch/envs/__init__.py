"""Environment layer (port of ``r2d2_tpu/envs``): the fake and grid envs,
the ALE wrappers, the single factory every other component uses, and the
anakin transport's batched device envs (``envs/anakin.py``)."""
from r2d2_tpu_torch.envs.atari import (
    NoopResetEnv,
    SeedFirstReset,
    SpaceToDepth,
    WarpFrame,
    atari_available,
    create_env,
)
from r2d2_tpu_torch.envs.fake import FakeAtariEnv
from r2d2_tpu_torch.envs.grid import GridWorldEnv

__all__ = ["FakeAtariEnv", "GridWorldEnv", "NoopResetEnv", "SeedFirstReset",
           "SpaceToDepth", "WarpFrame", "atari_available", "create_env"]
