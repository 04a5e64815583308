"""Carry weights from the JAX models to the PyTorch port.

``params_from_jax(params, batch_stats=None)`` takes the flax ``params``
and ``batch_stats`` trees of any of ``horovod_tpu.models``' CNNs and the
MLP (``ResNet*``, ``VGG*``, ``InceptionV3``, ``MLP``) as nested dicts of
numpy arrays and returns a ``state_dict`` for the port's model of the
same name: conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out,
in), biases and BatchNorm scale/bias/mean/var as they are.  The module
names are the same on both sides, so the mapping is one to one.
``resnet_params_from_jax``, ``inception_params_from_jax``,
``vgg_params_from_jax`` and ``mlp_params_from_jax`` are its names for
each model (VGG and the MLP have no ``batch_stats``).

``transformer_params_from_jax(params, cfg, layout)`` takes the global
parameter tree of ``horovod_tpu.models.transformer`` and returns this
rank's ``state_dict`` for ``horovod_tpu_torch.models.Transformer``: each
array sliced by the model's own ``shard_params`` (the reference's
``param_specs``) and cast to ``cfg.dtype`` (the router ``gate`` stays
float32).  The arrays are plain numpy: nothing of JAX is imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = value
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_jax(params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    state = {}
    for path, value in _flatten(params).items():
        module, leaf = path.rsplit(".", 1)
        a = np.asarray(value)
        if leaf == "kernel" and a.ndim == 4:      # conv HWIO -> OIHW
            state[f"{module}.weight"] = _tensor(a.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and a.ndim == 2:    # Dense (in,out) -> (out,in)
            state[f"{module}.weight"] = _tensor(a.T)
        elif leaf in ("scale", "bias"):
            state[path] = _tensor(a)
        else:
            raise ValueError(f"unexpected flax parameter {path} {a.shape}")
    for path, value in _flatten(batch_stats or {}).items():
        module, leaf = path.rsplit(".", 1)
        if leaf not in ("mean", "var"):
            raise ValueError(f"unexpected flax batch stat {path}")
        state[path] = _tensor(np.asarray(value))
    return state


resnet_params_from_jax = params_from_jax
inception_params_from_jax = params_from_jax
vgg_params_from_jax = params_from_jax
mlp_params_from_jax = params_from_jax


def transformer_params_from_jax(params: Mapping[str, Any], cfg,
                                layout) -> Dict[str, torch.Tensor]:
    from .models.transformer import shard_params

    state = {}
    for name, a in shard_params(params, cfg, layout).items():
        dtype = torch.float32 if name == "blocks.gate" else cfg.dtype
        state[name] = _tensor(np.asarray(a, dtype=np.float32)).to(dtype)
    return state
