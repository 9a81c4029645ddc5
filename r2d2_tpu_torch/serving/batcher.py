"""Continuous batching over a small set of bucket shapes.

Port of ``r2d2_tpu/serving/batcher.py``.  External sessions have no
lockstep: whatever requests are pending when the batch loop turns is the
batch, and its size is ragged from 1 to ``cfg.serve_max_batch``.  The batch
is **bucket shaped**: its size is rounded up to the next power of two (or
the cap), the tail rows are zero padded (their outputs are discarded and
pad rows never touch session state), and the act runs at one of
``log2(serve_max_batch)+1`` shapes: the retrace guard's ``serving.act``
budget is that count plus one, as the reference's, and a trace is a new
bucket shape (utils/trace.py).  On the card each bucket is one CUDA
graph of the act (actor.py:GraphedAct), and :meth:`warmup` captures all
of them, paying every first-call cost (the kernel build included), before
traffic.  A publish swaps the dict the batch loop acts with; the act
copies it into its own param tensors on the batch loop's thread, before
the next batch's kernels, and captures nothing new.

Transfers: each batch makes exactly ONE host→device put and ONE
device→host fetch.  The four request arrays of a bucket live in one
packed host buffer (pinned on a CUDA device, laid out by
``replay/block.slot_layout``), copied to the device in one transfer and
viewed there; q and the new hidden come back as one concatenated tensor.

Quantized serving (``cfg.serve_dtype="bfloat16"``): publish rounds every
float32 param through bfloat16 and widens it back (the mantissa truncation
IS the quantization), and :meth:`greedy_parity_ok` gates a param set on
greedy-action parity with its full-precision self.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import slot_layout, slot_views
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, TRANSFER_GUARD


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """The batch shapes: powers of two below ``max_batch``, then
    ``max_batch`` itself (so the largest bucket is exactly the configured
    cap, power of two or not)."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(int(max_batch))
    return tuple(sizes)


class _Bucket:
    """One bucket's packed request buffer: numpy views on the host for
    filling, tensor views on the device for the act."""

    def __init__(self, spec, device: torch.device):
        nbytes, offsets = slot_layout(spec)
        pin = device.type == "cuda"
        self.host = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pin)
        self.views = slot_views(self.host.numpy(), spec, offsets, nbytes, 0)
        self.spec = spec
        self.offsets = offsets
        self.device = device

    def put(self) -> Dict[str, torch.Tensor]:
        """The one H2D copy of the whole packed buffer, viewed per field.
        On the CPU the "device" buffer is the host buffer itself."""
        dev = self.host.to(self.device, non_blocking=True)
        out = {}
        for name, shape, dtype in self.spec:
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            off = self.offsets[name]
            out[name] = dev[off:off + n].view(
                _TORCH_DTYPES[np.dtype(dtype)]).reshape(shape)
        return out


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.float32): torch.float32}


class ContinuousBatcher:
    """Ragged-batch act over bucket-shaped batches."""

    def __init__(self, cfg: Config, action_dim: int, device=None):
        from r2d2_tpu_torch.actor import _resolve_act_device, make_act_fn
        from r2d2_tpu_torch.models.network import create_network

        self.cfg = cfg
        self.action_dim = action_dim
        self.buckets = bucket_sizes(cfg.serve_max_batch)
        self.device = _resolve_act_device(cfg.act_device, device)
        # the module supplies the structure; published state dicts supply
        # the values (the act adopts each into its own param tensors)
        self.net = create_network(cfg, action_dim, device=self.device)
        # one act instance; each bucket shape is one deliberate trace, on
        # the card one CUDA graph (+1 slack, the reference's budget)
        self._act = make_act_fn(self.net, retrace_name="serving.act",
                                retrace_budget=len(self.buckets) + 1)
        # the parity gate runs on follow mode's thread while the batch loop
        # acts: it gets its own module (an act swaps the module's
        # parameters while it runs) and act instance, built at its first use
        self._probe_act = None
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self.version = 0
        self._scratch: Dict[int, _Bucket] = {}

    # ------------------------------------------------------------- params
    @staticmethod
    def _quantize(params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The bf16 weights-only round-trip, shared by :meth:`publish` and
        :meth:`greedy_parity_ok` so the gate tests exactly what publish
        ships."""
        return {k: v.to(torch.bfloat16).float()
                if v.dtype == torch.float32 else v
                for k, v in params.items()}

    def _on_device(self, params: Mapping[str, object]
                   ) -> Dict[str, torch.Tensor]:
        want = self.net.state_dict()
        if set(params) != set(want):
            missing = sorted(set(want) - set(params))
            extra = sorted(set(params) - set(want))
            raise ValueError(f"params do not match the network: missing "
                             f"{missing}, unexpected {extra}")
        out = {}
        for k, v in params.items():
            t = torch.as_tensor(v)
            if tuple(t.shape) != tuple(want[k].shape):
                raise ValueError(f"param {k}: shape {tuple(t.shape)}, the "
                                 f"network has {tuple(want[k].shape)}")
            out[k] = t.to(self.device, torch.float32)
        return out

    def publish(self, params: Mapping[str, object]) -> int:
        """Adopt a new param snapshot (a state dict of the port's
        ``R2D2Network``; tensors or numpy arrays — see
        ``models/convert.params_from_flax`` for a flax tree).  Under
        ``serve_dtype="bfloat16"`` every float32 param is quantized
        through bfloat16; the act math stays the compute dtype's."""
        params = self._on_device(params)
        if self.cfg.serve_dtype == "bfloat16":
            params = self._quantize(params)
        self._params = params
        self.version += 1
        return self.version

    def greedy_parity_ok(self, params: Mapping[str, object], probe: int = 32,
                         seed: int = 0) -> bool:
        """On a seeded probe batch, the bf16-quantized params must pick the
        same greedy actions as the full-precision ones.  Trivially True
        when ``serve_dtype`` is float32.  The probe is bucket shaped."""
        if self.cfg.serve_dtype != "bfloat16":
            return True
        cfg = self.cfg
        n = self.bucket(min(probe, self.buckets[-1]))
        rng = np.random.default_rng(seed)
        obs = rng.integers(0, 256, (n, *cfg.stored_obs_shape), np.uint8)
        la = np.zeros((n, self.action_dim), np.float32)
        la[np.arange(n), rng.integers(self.action_dim, size=n)] = 1.0
        lr = rng.normal(size=n).astype(np.float32)
        hid = (rng.normal(size=(n, 2, cfg.lstm_layers, cfg.hidden_dim))
               .astype(np.float32) * 0.1)
        args = [torch.from_numpy(a).to(self.device)
                for a in (obs, la, lr, hid)]
        params = self._on_device(params)
        if self._probe_act is None:
            import copy

            from r2d2_tpu_torch.actor import make_act_fn

            self._probe_act = make_act_fn(
                copy.deepcopy(self.net), retrace_name="serving.act",
                retrace_budget=len(self.buckets) + 1)
        # on the card an act returns its graph's outputs, which the next
        # act overwrites: take the reference's actions before that act
        greedy_ref = self._probe_act(params, *args)[0].argmax(dim=1)
        q_bf16, _ = self._probe_act(self._quantize(params), *args)
        return bool((greedy_ref == q_bf16.argmax(dim=1)).all())

    # ---------------------------------------------------------------- act
    def bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds serve_max_batch="
                         f"{self.buckets[-1]}")

    def _pad(self, b: int) -> _Bucket:
        s = self._scratch.get(b)
        if s is None:
            cfg = self.cfg
            spec = (("obs", (b, *cfg.stored_obs_shape), np.uint8),
                    ("last_action", (b, self.action_dim), np.float32),
                    ("last_reward", (b,), np.float32),
                    ("hidden", (b, 2, cfg.lstm_layers, cfg.hidden_dim),
                     np.float32))
            s = self._scratch[b] = _Bucket(spec, self.device)
        return s

    def _run(self, s: _Bucket, n: int) -> Tuple[np.ndarray, np.ndarray]:
        # the act's guard window: its two declared crossings are the one
        # put of the padded rows and the one fetch of (q, new hidden)
        with TRANSFER_GUARD.disallow("serving.act"):
            with HOST_TRANSFERS.allowed("serving.act_put"):
                x = s.put()
            q, new_hidden = self._act(self._params, x["obs"],
                                      x["last_action"], x["last_reward"],
                                      x["hidden"])
            b = q.shape[0]
            packed = torch.cat([q, new_hidden.reshape(b, -1)], dim=1)
            with HOST_TRANSFERS.allowed("serving.act_fetch"):
                out = packed.cpu().numpy()
        A = self.action_dim
        return out[:n, :A], out[:n, A:].reshape(n, *new_hidden.shape[1:])

    def act(self, obs: np.ndarray, last_action: np.ndarray,
            last_reward: np.ndarray, hidden: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
        """One continuous batch: ``n`` ragged rows in, ``(q, new_hidden)``
        rows out.  Pads to the covering bucket (pad rows carry zeros) and
        pays one put and one fetch per batch regardless of size."""
        if self._params is None:
            raise RuntimeError("no params published yet")
        n = len(obs)
        s = self._pad(self.bucket(n))
        v = s.views
        v["obs"][:n] = obs
        v["last_action"][:n] = last_action
        v["last_reward"][:n] = last_reward
        v["hidden"][:n] = hidden
        for name in ("obs", "last_action", "last_reward", "hidden"):
            v[name][n:] = 0
        return self._run(s, n)

    def warmup(self) -> None:
        """Run every bucket once before traffic (server start-up): the
        first real request must not pay the kernel build, the first
        cuDNN/cuBLAS call of its shape or, on the card, its bucket's
        CUDA-graph capture inside its deadline."""
        if self._params is None:
            raise RuntimeError("no params published yet")
        for b in self.buckets:
            self._run(self._pad(b), b)
