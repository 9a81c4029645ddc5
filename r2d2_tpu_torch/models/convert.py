"""Parameter conversion from the JAX package's flax tree to the port's
``R2D2Network`` state dict.

The flax tree (``init_params`` / a checkpoint's ``params``), as numpy
arrays, maps onto the port's modules by name:

- nature torso: ``torso/Conv_{0,1,2}`` → ``torso.conv{1,2,3}``: kernels
  HWIO → OIHW;
- impala torso: ``torso/Conv_0 … Conv_14`` (3 stages × (1 + 2 blocks × 2
  convs), in flax's creation order) → ``torso.convs.{0 … 14}``, kernels
  HWIO → OIHW;
- ``torso/Dense_0`` → ``torso.dense``: kernel (in, out) → weight (out, in);
  its rows are already in NHWC flatten order, which the port's torso keeps;
- ``lstm_i/{wi, wh, b}`` → ``lstm_layers.i.{wi, wh, b}`` as they are: one
  bias, not ``nn.LSTM``'s two;
- ``head/{adv,val}_{hidden,out}`` → ``head.*``: Dense kernels transposed.

:func:`train_state_from_jax` carries a whole JAX ``TrainState`` across
(online and target params, optax Adam's ``mu``/``nu``/``count``, the
step): the moments have the params' tree shape, so they map by the same
rules.  The caller reads the JAX state (e.g. an orbax checkpoint) and
passes numpy; the port itself never imports orbax.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONVS = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3"}
_HEAD = ("adv_hidden", "adv_out", "val_hidden", "val_out")


def _leaf(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _torso_names(layers) -> Dict[str, str]:
    """flax torso layer name → the port's module path under ``torso.``:
    three convs are the nature torso's, more are the impala torso's."""
    convs = sorted((n for n in layers if n.startswith("Conv_")),
                   key=lambda n: int(n[5:]))
    names = {"Dense_0": "dense"}
    if len(convs) <= len(_CONVS):
        names.update((n, _CONVS[n]) for n in convs)
    else:
        names.update((n, f"convs.{int(n[5:])}") for n in convs)
    return names


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state dict (float32 CPU tensors) from a flax param tree
    with or without its top-level ``"params"`` key."""
    p = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    names = _torso_names(p["torso"])
    for name, layer in p["torso"].items():
        if name not in names:
            raise ValueError(f"unknown torso layer {name!r} (the nature, "
                             "impala and mlp torsos are ported)")
        kernel = _leaf(layer["kernel"])
        out[f"torso.{names[name]}.weight"] = (
            kernel.T if name == "Dense_0"
            else kernel.permute(3, 2, 0, 1)).contiguous()
        out[f"torso.{names[name]}.bias"] = _leaf(layer["bias"])
    i = 0
    while f"lstm_{i}" in p:
        for k in ("wi", "wh", "b"):
            out[f"lstm_layers.{i}.{k}"] = _leaf(p[f"lstm_{i}"][k])
        i += 1
    for name in _HEAD:
        layer = p["head"][name]
        out[f"head.{name}.weight"] = _leaf(layer["kernel"]).T.contiguous()
        out[f"head.{name}.bias"] = _leaf(layer["bias"])
    return out


def train_state_from_jax(params: Mapping[str, Any],
                         target_params: Mapping[str, Any],
                         mu: Mapping[str, Any], nu: Mapping[str, Any],
                         count: int, step: int):
    """The port's :class:`~r2d2_tpu_torch.learner.step.TrainState` (CPU
    float32 tensors) from a JAX ``TrainState`` as numpy: the flax params
    and target params, optax ``ScaleByAdamState``'s ``mu``/``nu``/``count``
    (the clip's state is empty) and the step counter."""
    from r2d2_tpu_torch.learner.step import AdamState, TrainState

    return TrainState(
        step=int(step), params=params_from_flax(params),
        target_params=params_from_flax(target_params),
        opt_state=AdamState(count=int(count), mu=params_from_flax(mu),
                            nu=params_from_flax(nu)))
