"""Carry ``repro``'s parameters across into the port.

``repro`` initialises with ``jax.random``, which ``torch`` cannot replay, so
the parity tests give both packages the same weights by copying them.
:func:`params_from_numpy` takes ``repro``'s parameter tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and fills a
:class:`~repro_torch.models.Transformer`: the stacked layer axis 0 is split
across the ``ModuleList`` (a hybrid's super-block leaves and tail by the
model's ``leaf_layout``) and every other key is the module attribute of the
same name.  The port keeps JAX's weight layouts, so each leaf is a copy, not
a transpose.

bfloat16 crosses as its bit pattern (``arr.view(np.uint16)`` →
``torch.from_numpy(...).view(torch.bfloat16)``), which is exact and needs
neither JAX nor ``ml_dtypes`` on this side.  Without ``ml_dtypes`` numpy
holds bfloat16 as raw 2-byte records (dtype ``V2``, as ``repro``'s
checkpoints load it): such arrays cross the same way.

:func:`train_state_from_numpy` and :func:`train_state_to_numpy` carry a
whole train state (parameters, optimizer state, step) both ways, so the two
packages' train steps can be compared after any number of steps.  The
optimizer state is keyed as :mod:`repro_torch.optim` keeps it: AdamW's
``m`` / ``v`` by parameter name, Adafactor's by ``repro``'s leaf path with
the layer axis kept.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Transformer, set_trainable
from repro_torch.optim import TrainState, leaf_path, param_leaves

#: numpy's dtype for bfloat16 bits without ``ml_dtypes``: raw 2-byte records
BF16_RAW = np.dtype("V2")


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """A copy of ``arr`` as a tensor (bfloat16 bit-exact, from ``ml_dtypes``'
    bfloat16 or from raw ``V2`` records)."""
    a = np.array(arr, copy=True)  # JAX hands out read-only buffers
    if a.dtype.name == "bfloat16" or a.dtype == BF16_RAW:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _at(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> Transformer:
    """``repro``'s parameter tree (numpy leaves) → the port's model on
    ``device``.  Each parameter is found by its leaf path
    (``optim.leaf_path`` under the model's ``leaf_layout``): a stacked
    leaf gives its layer's slice."""
    model = Transformer(cfg, device=device)
    missing = []
    for name, target in model.named_parameters():
        path, layer = leaf_path(name, model.leaf_layout)
        try:
            arr = _at(tree, path)
        except KeyError:
            missing.append(name)
            continue
        src = tensor_from_numpy(arr if layer is None else np.asarray(arr)[layer], target.device)
        if tuple(src.shape) != tuple(target.shape) or src.dtype != target.dtype:
            raise ValueError(
                f"{name}: {tuple(src.shape)} {src.dtype} does not fit "
                f"{tuple(target.shape)} {target.dtype}"
            )
        target.copy_(src)
    if missing:
        raise ValueError(f"parameter tree lacks {missing}")
    return model


def _put(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for key in head:
        tree = tree.setdefault(key, {})
    tree[last] = value


def train_state_from_numpy(params_tree: dict, opt_tree: dict, step, cfg: ArchConfig,
                           device="cuda") -> TrainState:
    """``repro``'s ``TrainState`` as numpy trees (``jax.tree.map(np.asarray,
    ...)``) → the port's, trainable, on ``device``."""
    model = set_trainable(params_from_numpy(params_tree, cfg, device))
    names = [n for n, _ in model.named_parameters()]
    layout = model.leaf_layout
    if cfg.optimizer == "adamw":
        opt = {}
        for k in ("m", "v"):
            opt[k] = {}
            for n in names:
                path, layer = leaf_path(n, layout)
                arr = _at(opt_tree[k], path)
                opt[k][n] = tensor_from_numpy(arr if layer is None else np.asarray(arr)[layer], device)
    else:
        opt = {
            leaf.path: {k: tensor_from_numpy(v, device) for k, v in _at(opt_tree, leaf.path).items()}
            for leaf in param_leaves(names, layout)
        }
    step_t = torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=model.device)
    return TrainState(step=step_t, params=model, opt=opt)


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t`` (the train step updates
    its state in place), bfloat16 as its raw 2-byte records (``BF16_RAW``)."""
    t = t.detach().to("cpu", copy=True)
    return t.view(torch.int16).numpy().view(BF16_RAW) if t.dtype == torch.bfloat16 else t.numpy()


def train_state_to_numpy(state: TrainState) -> tuple[dict, dict, int]:
    """The port's train state → (params tree, optimizer tree, step) shaped
    as ``repro``'s, with numpy leaves (layer parameters stacked on axis 0;
    bfloat16 as raw ``BF16_RAW`` records, the form a checkpoint stores)."""
    params = dict(state.params.named_parameters())
    leaves = param_leaves(params, state.params.leaf_layout)
    p_tree: dict = {}
    for leaf in leaves:
        parts = [_np(params[n]) for n in leaf.names]
        _put(p_tree, leaf.path, np.stack(parts) if leaf.stacked else parts[0])
    o_tree: dict = {}
    if set(state.opt) == {"m", "v"}:  # adamw; adafactor's keys are leaf paths
        for k in ("m", "v"):
            o_tree[k] = {}
            for leaf in leaves:
                parts = [_np(state.opt[k][n]) for n in leaf.names]
                _put(o_tree[k], leaf.path, np.stack(parts) if leaf.stacked else parts[0])
    else:
        for leaf in leaves:
            _put(o_tree, leaf.path, {k: _np(v) for k, v in state.opt[leaf.path].items()})
    return p_tree, o_tree, int(state.step)
