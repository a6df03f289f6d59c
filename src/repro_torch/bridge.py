"""Carry ``repro``'s parameters across into the port.

``repro`` initialises with ``jax.random``, which ``torch`` cannot replay, so
the parity tests give both packages the same weights by copying them.
:func:`params_from_numpy` takes ``repro``'s parameter tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and fills a
:class:`~repro_torch.models.Transformer`: the stacked layer axis 0 is split
across the ``ModuleList`` and every other key is the module attribute of the
same name.  The port keeps JAX's weight layouts, so each leaf is a copy, not
a transpose.

bfloat16 crosses as its bit pattern (``arr.view(np.uint16)`` →
``torch.from_numpy(...).view(torch.bfloat16)``), which is exact and needs
neither JAX nor ``ml_dtypes`` on this side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import RMSNorm
from repro_torch.models.transformer import Transformer


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """A copy of ``arr`` as a tensor (bfloat16 bit-exact)."""
    a = np.array(arr, copy=True)  # JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


@torch.no_grad()
def _assign(module: torch.nn.Module, tree: dict, filled: set, layer=None) -> None:
    for name, value in tree.items():
        if name == "layers":
            for i, layer_module in enumerate(module.layers):
                _assign(layer_module, value, filled, layer=i)
            continue
        if isinstance(value, dict):
            _assign(getattr(module, name), value, filled, layer)
            continue
        target = getattr(module, name)
        if isinstance(target, RMSNorm):
            target = target.scale
        arr = value if layer is None else np.asarray(value)[layer]
        src = tensor_from_numpy(arr, target.device)
        if tuple(src.shape) != tuple(target.shape) or src.dtype != target.dtype:
            raise ValueError(
                f"{name}: {tuple(src.shape)} {src.dtype} does not fit "
                f"{tuple(target.shape)} {target.dtype}"
            )
        target.copy_(src)
        filled.add(id(target))


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> Transformer:
    """``repro``'s parameter tree (numpy leaves) → the port's model on ``device``."""
    model = Transformer(cfg, device=device)
    filled: set = set()
    _assign(model, tree, filled)
    missing = [n for n, t in model.named_parameters() if id(t) not in filled]
    if missing:
        raise ValueError(f"parameter tree lacks {missing}")
    return model
