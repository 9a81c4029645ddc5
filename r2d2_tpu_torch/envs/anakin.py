"""Batched device envs: the anakin transport's envs, as tensor ops.

Port of ``r2d2_tpu/envs/anakin.py``.  The anakin transport runs env step →
act → block cut → ring write → train step on the device with no host
round trip inside a dispatch, so the environment itself must be a handful
of tensor ops over a ``(num_lanes, ...)`` state.  :class:`AnakinFakeEnv`
is the device twin of :class:`~r2d2_tpu_torch.envs.fake.FakeAtariEnv`,
:class:`AnakinGridEnv` that of :class:`~r2d2_tpu_torch.envs.grid.
GridWorldEnv`; :func:`make_anakin_env` resolves ``cfg.anakin_env``.

Bit-exactness contract (tests/test_torch_anakin_env.py): given the same
reset draws, ``step``/``observe`` reproduce the numpy env's observation
bytes, rewards and truncation flags exactly, and the JAX package's — the
dynamics are integer arithmetic plus the constants {0.0, 1.0, 2.0}.

Randomness.  JAX draws each lane's resets from a threefry key in the
state.  Here each lane carries a counter-based stream, ``key`` (N, 2)
int64 = [stream id, counter], and a draw is a 32-bit integer hash
(:func:`mix32`) of (stream id, counter, draw slot) in int64 tensor ops.
So the state is tensors only (a snapshot is plain arrays, and there is
no ``torch.Generator`` state to persist), draws are elementwise in the
lane axis, and a JAX snapshot, whose keys are uint32, fails the layout
check instead of being read as this one's.  ``reset_lanes(...,
draws=...)`` replaces the stream's values: the parity tests feed JAX's
own draws through it.

API (every method is batched tensor ops on the env's device, with no
host synchronisation):

- ``init_state(root, draws=None) -> state``: every lane reset; ``root``
  (a python int, or a 0-d int64 tensor from :func:`derive`) is what the
  lanes' streams derive from;
- ``observe(state) -> (N, *obs_shape) uint8``;
- ``step(state, actions) -> (state', reward (N,) f32, truncated (N,)
  bool)``: no auto-reset — the caller records the post-step observation
  first, then calls
- ``reset_lanes(state, mask, draws=None) -> state'``: redraw and zero the
  step counter for masked lanes only.

``STATE_KEYS`` names the state's entries (the fused loop carries them as
``ast["env_<key>"]``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from r2d2_tpu_torch.envs.grid import AGENT_PIXEL, GOAL_PIXEL, GRID

_MASK32 = 0xFFFFFFFF
# odd 32-bit constants: murmur3's finaliser multipliers and the golden
# ratio, which spreads consecutive lane and slot numbers apart
_M1, _M2, _GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32), as two 16-bit halves so
    that no int64 product overflows.  ``x`` is a python int or an int64
    tensor."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def mix32(x):
    """murmur3's 32-bit finaliser of ``x``'s low 32 bits: a python int, or
    an int64 tensor elementwise."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _int(x):
    return x if isinstance(x, torch.Tensor) else int(x)


def derive(root, *salts):
    """A stream root derived from ``root`` and ``salts`` in order:
    distinct salts give independent streams.  Each is a python int, or an
    int64 tensor of values in [0, 2**32) (a CUDA graph's input index):
    then the root is a tensor, computed on its device elementwise, bit
    for bit the python int."""
    x = mix32(_int(root) + _GOLDEN)
    for s in salts:
        x = mix32(x ^ mix32(_int(s) + _GOLDEN))
    return x


def lane_keys(root, n: int, device) -> torch.Tensor:
    """(n, 2) int64 keys [stream id, counter 0] for ``n`` lanes under
    ``root`` (a python int, or a 0-d int64 tensor from :func:`derive`)."""
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    ids = mix32(mix32(lanes + _GOLDEN) ^ root)
    return torch.stack([ids, torch.zeros_like(ids)], dim=1)


def stream_bits(key: torch.Tensor, slot: int) -> torch.Tensor:
    """(N,) int64 in [0, 2**32): draw ``slot`` at each lane's current
    counter."""
    return mix32(key[:, 0] ^ mix32(key[:, 1] * 4 + slot + _GOLDEN))


def advance(key: torch.Tensor) -> torch.Tensor:
    """The keys one counter step on."""
    return torch.stack([key[:, 0], key[:, 1] + 1], dim=1)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits (the top 24, exactly)."""
    return (bits >> 8).float() * (1.0 / (1 << 24))


def randint(bits: torch.Tensor, n: int) -> torch.Tensor:
    """int32 in [0, n) from 32 random bits (multiply-shift)."""
    return ((bits * n) >> 32).int()


def make_anakin_env(cfg, action_dim: int, device="cuda"):
    """The anakin transport's env-selection point: resolve
    ``cfg.anakin_env`` to a device env over ``cfg.num_actors`` lanes.  Both
    built-ins share the 4-action set; another env plugs in by implementing
    the same four-method surface and being returned from here."""
    kind = getattr(cfg, "anakin_env", "fake")
    cls = {"fake": AnakinFakeEnv, "grid": AnakinGridEnv}.get(kind)
    if cls is None:
        raise ValueError(f"unknown anakin_env {kind!r} "
                         "(expected 'fake' or 'grid')")
    return cls(obs_shape=cfg.stored_obs_shape, action_dim=action_dim,
               episode_len=cfg.anakin_episode_len,
               num_lanes=cfg.num_actors, device=device)


class AnakinFakeEnv:
    """Batched :class:`~r2d2_tpu_torch.envs.fake.FakeAtariEnv` twin.

    State (N = num_lanes, all on ``device``):
      ``phase`` (N,) int32 — the hidden phase counter,
      ``t`` (N,) int32 — steps into the current episode,
      ``key`` (N, 2) int64 — the lanes' reset streams.
    """

    STATE_KEYS = ("phase", "t", "key")

    def __init__(self, obs_shape: Tuple[int, ...] = (84, 84, 1),
                 action_dim: int = 4, episode_len: int = 32,
                 num_lanes: int = 1, device="cuda"):
        self.obs_shape = tuple(obs_shape)
        self.action_dim = int(action_dim)
        self.episode_len = int(episode_len)
        self.num_lanes = int(num_lanes)
        self.device = torch.device(device)
        self._rows_per_band = max(1, self.obs_shape[0] // self.action_dim)
        self._rows = torch.arange(self.obs_shape[0], dtype=torch.int32,
                                  device=self.device)

    # ------------------------------------------------------------ lifecycle
    def init_state(self, root,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """All lanes reset, each lane's stream derived from ``root``."""
        n = self.num_lanes
        state = dict(
            phase=torch.zeros(n, dtype=torch.int32, device=self.device),
            t=torch.zeros(n, dtype=torch.int32, device=self.device),
            key=lane_keys(root, n, self.device))
        return self.reset_lanes(
            state, torch.ones(n, dtype=torch.bool, device=self.device),
            draws)

    def reset_lanes(self, state: dict, mask: torch.Tensor,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> dict:
        """Redraw the phase (the numpy env's ``rng.integers(action_dim)``)
        and zero the step counter for masked lanes; unmasked lanes keep
        everything, their stream position included.  ``draws["phase"]``
        (N,) replaces the stream's phases."""
        key = state["key"]
        phase = (randint(stream_bits(key, 0), self.action_dim)
                 if draws is None else draws["phase"].int())
        return dict(
            phase=torch.where(mask, phase, state["phase"]),
            t=torch.where(mask, 0, state["t"]),
            key=torch.where(mask[:, None], advance(key), key))

    # ------------------------------------------------------------- dynamics
    def observe(self, state: dict) -> torch.Tensor:
        """(N, *obs_shape) uint8 — the numpy ``_obs`` band: rows
        [band·rpb, (band+1)·rpb) are 255, everything else 0."""
        rpb = self._rows_per_band
        r0 = (state["phase"] % self.action_dim) * rpb            # (N,)
        rows = self._rows[None, :]
        mask = (rows >= r0[:, None]) & (rows < (r0 + rpb)[:, None])
        mask = mask.reshape(mask.shape + (1,) * (len(self.obs_shape) - 1))
        obs = mask.to(torch.uint8) * 255
        return obs.expand(state["phase"].shape[0],
                          *self.obs_shape).contiguous()

    def step(self, state: dict, actions: torch.Tensor
             ) -> Tuple[dict, torch.Tensor, torch.Tensor]:
        """``FakeAtariEnv.step`` for every lane: reward 1.0 on the
        phase-matching action, phase and t advance, truncation at
        ``episode_len`` adds the +2.0 bonus.  No auto-reset."""
        target = state["phase"] % self.action_dim
        reward = (actions.int() == target).float()
        t = state["t"] + 1
        truncated = t >= self.episode_len
        reward = reward + truncated.float() * 2.0
        return (dict(phase=state["phase"] + 1, t=t, key=state["key"]),
                reward, truncated)


class AnakinGridEnv:
    """Batched :class:`~r2d2_tpu_torch.envs.grid.GridWorldEnv` twin.

    State (N = num_lanes, all on ``device``):
      ``agent`` (N,) int32 — the agent's flattened board cell,
      ``goal`` (N,) int32 — the goal's flattened board cell,
      ``t`` (N,) int32 — steps into the current episode,
      ``key`` (N, 2) int64 — the lanes' reset streams.

    In-episode dynamics (moves, goal relocation) are deterministic integer
    arithmetic, so replaying the reset draws covers whole episodes.
    """

    STATE_KEYS = ("agent", "goal", "t", "key")

    def __init__(self, obs_shape: Tuple[int, ...] = (84, 84, 1),
                 action_dim: int = 4, episode_len: int = 32,
                 num_lanes: int = 1, device="cuda"):
        if action_dim != 4:
            raise ValueError(
                f"AnakinGridEnv has exactly 4 move actions, got "
                f"action_dim {action_dim}")
        self.obs_shape = tuple(obs_shape)
        self.action_dim = int(action_dim)
        self.episode_len = int(episode_len)
        self.num_lanes = int(num_lanes)
        self.device = torch.device(device)
        h, w = self.obs_shape[:2]
        self._cell = (max(1, h // GRID), max(1, w // GRID))
        self._rows = torch.arange(h, dtype=torch.int32, device=self.device)
        self._cols = torch.arange(w, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------ lifecycle
    def init_state(self, root,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        n = self.num_lanes
        state = dict(
            agent=torch.zeros(n, dtype=torch.int32, device=self.device),
            goal=torch.ones(n, dtype=torch.int32, device=self.device),
            t=torch.zeros(n, dtype=torch.int32, device=self.device),
            key=lane_keys(root, n, self.device))
        return self.reset_lanes(
            state, torch.ones(n, dtype=torch.bool, device=self.device),
            draws)

    def reset_lanes(self, state: dict, mask: torch.Tensor,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> dict:
        """Redraw agent and goal cells (the goal uniform over the other
        ``GRID**2 - 1`` cells, the numpy env's scheme) and zero the step
        counter for masked lanes.  ``draws["agent"]`` and ``draws["goal"]``
        (N,) replace the stream's cells."""
        key = state["key"]
        if draws is None:
            m = GRID * GRID
            agent = randint(stream_bits(key, 0), m)
            d = randint(stream_bits(key, 1), m - 1)
            goal = d + (d >= agent).int()
        else:
            agent, goal = draws["agent"].int(), draws["goal"].int()
        return dict(
            agent=torch.where(mask, agent, state["agent"]),
            goal=torch.where(mask, goal, state["goal"]),
            t=torch.where(mask, 0, state["t"]),
            key=torch.where(mask[:, None], advance(key), key))

    # ------------------------------------------------------------- dynamics
    def _cell_mask(self, idx: torch.Tensor) -> torch.Tensor:
        """(N,) cells → (N, H, W) bool pixel masks."""
        ch, cw = self._cell
        r, c = idx // GRID, idx % GRID
        rows, cols = self._rows[None, :], self._cols[None, :]
        rm = (rows >= (r * ch)[:, None]) & (rows < ((r + 1) * ch)[:, None])
        cm = (cols >= (c * cw)[:, None]) & (cols < ((c + 1) * cw)[:, None])
        return rm[:, :, None] & cm[:, None, :]

    def observe(self, state: dict) -> torch.Tensor:
        """(N, *obs_shape) uint8 — agent cell 255, goal cell 128."""
        img = self._cell_mask(state["goal"]).to(torch.uint8) * GOAL_PIXEL
        img = torch.where(self._cell_mask(state["agent"]),
                          torch.full_like(img, AGENT_PIXEL), img)
        img = img.reshape(img.shape + (1,) * (len(self.obs_shape) - 2))
        return img.expand(state["agent"].shape[0],
                          *self.obs_shape).contiguous()

    def step(self, state: dict, actions: torch.Tensor
             ) -> Tuple[dict, torch.Tensor, torch.Tensor]:
        """``GridWorldEnv.step`` for every lane: clamped moves (0/1/2/3 =
        up/down/left/right), +1.0 on reaching the goal, the goal's
        deterministic relocation, truncation at ``episode_len``.  No
        randomness, no auto-reset."""
        a = actions.int()
        r, c = state["agent"] // GRID, state["agent"] % GRID
        r = torch.clamp(r + (a == 1).int() - (a == 0).int(), 0, GRID - 1)
        c = torch.clamp(c + (a == 3).int() - (a == 2).int(), 0, GRID - 1)
        agent = r * GRID + c
        reached = agent == state["goal"]
        m = GRID * GRID
        g1 = (state["goal"] + 1) % m              # grid.next_goal, batched
        g1 = torch.where(g1 == agent, (g1 + 1) % m, g1)
        t = state["t"] + 1
        return (dict(agent=agent, goal=torch.where(reached, g1,
                                                   state["goal"]),
                     t=t, key=state["key"]),
                reached.float(), t >= self.episode_len)
