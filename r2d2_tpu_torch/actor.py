"""Acting: batched single-step inference over published params.

Port of ``make_act_fn`` and ``_resolve_act_device`` from
``r2d2_tpu/actor.py``; ``AgentState`` and ``VectorActor`` wait for the
training slice.

One deliberate difference from the reference: there, ``act_device="auto"``
moves acting to the host CPU whenever an accelerator is present and acts
through a scan/float32 twin of the network, so its serving tier never
reaches the fused LSTM kernel.  Here ``"auto"`` and ``"default"`` act on
the CUDA device, through the network as configured (the fused kernel when
``lstm_impl`` resolves to ``"pallas"``), and only ``"cpu"`` (or an explicit
``device="cpu"``) acts on the CPU.  Nothing moves to the CPU silently: with
no CUDA device, ``"auto"`` raises.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch.func import functional_call

from r2d2_tpu_torch.models.network import R2D2Network

ActFn = Callable[..., tuple]


def _resolve_act_device(spec: str, device=None) -> torch.device:
    """The device acting runs on.  An explicit ``device`` wins; otherwise
    ``cfg.act_device``: ``"cpu"`` → the CPU, ``"auto"``/``"default"`` → the
    current CUDA device (raises when there is none)."""
    if device is not None:
        return torch.device(device)
    if spec == "cpu":
        return torch.device("cpu")
    if spec not in ("auto", "default"):
        raise ValueError(f"unknown act_device {spec!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"act_device={spec!r} needs a CUDA device and none is visible; "
            "pass device='cpu' (or act_device='cpu') to act on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_act_fn(net: R2D2Network) -> ActFn:
    """Batched single-step inference:
    ``act(params, obs (B,*obs) u8, last_action (B,A) f32, last_reward (B,)
    f32, hidden (B,2,layers,H) f32) -> (q (B,A) f32, new hidden)``, all
    tensors on ``net``'s device.  ``params`` is a state dict of ``net``
    (what :meth:`ContinuousBatcher.publish` holds), so a new snapshot is a
    new dict, never an in-place write under a running batch."""

    def act(params: Mapping[str, torch.Tensor], obs, last_action,
            last_reward, hidden):
        with torch.inference_mode():
            return functional_call(net, params,
                                   (obs, last_action, last_reward, hidden))

    return act
