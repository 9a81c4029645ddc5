"""Environment layer (port of ``r2d2_tpu/envs``): the fake env and the
single factory every other component uses."""
from r2d2_tpu_torch.envs.atari import SpaceToDepth, create_env
from r2d2_tpu_torch.envs.fake import FakeAtariEnv

__all__ = ["FakeAtariEnv", "SpaceToDepth", "create_env"]
