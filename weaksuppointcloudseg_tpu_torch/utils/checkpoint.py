"""Weights bridge: the JAX package's checkpoint format v2 <-> the port's
modules. Counterpart of weaksuppointcloudseg_tpu/utils/checkpoint.py.

A v2 checkpoint is one ``.npz`` holding the flattened train-state pytree
as ``arr_<i>``, its key paths as strings (``__keypaths__``, e.g.
``['params']['adj_conv1']['w']``) and ``__format__`` = 2. The port reads
it by key path, without JAX: the ``['params']...`` and ``['bn_state']...``
leaves become the model's state_dict (path segments joined with dots,
``adj_conv1.w``, ``adj_conv1.mean``); ``opt_state`` and ``step`` are not
needed at eval and are ignored.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Tuple

import numpy as np
import torch

CHECKPOINT_FORMAT = 2
_PARAM_LEAVES = {"w", "b", "gamma", "beta"}
_STATE_LEAVES = {"mean", "var"}
_DICT_KEY = re.compile(r"\['([^'\]]*)'\]")


def _dict_keys(path: str):
    """['a']['b'] -> ['a', 'b']; raises on any other key-path form."""
    keys = _DICT_KEY.findall(path)
    if not keys or "".join(f"['{k}']" for k in keys) != path:
        raise ValueError(f"unexpected checkpoint key path {path!r}")
    return keys


def params_from_jax(params: dict, bn_state: dict) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (the JAX pytrees) -> a state_dict.

    Raises on a leaf that is not a conv parameter (w/b/gamma/beta) or a
    BN statistic (mean/var).
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix, allowed):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, name, allowed)
            elif key not in allowed:
                raise ValueError(f"unexpected leaf {name!r}")
            else:
                out[name] = torch.tensor(np.asarray(val, np.float32))

    walk(params, "", _PARAM_LEAVES)
    walk(bn_state, "", _STATE_LEAVES)
    return out


def read_jax_checkpoint(path: str) -> Tuple[dict, dict, int]:
    """(params, bn_state, epoch) of a format-v2 ``.npz``, as nested dicts."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        if "__keypaths__" not in data.files:
            raise ValueError(f"{path}: not a format-v2 checkpoint (no key paths)")
        trees = {"params": {}, "bn_state": {}}
        epoch = 0
        for i, p in enumerate(str(p) for p in data["__keypaths__"]):
            if p == "['epoch']":
                epoch = int(data[f"arr_{i}"])
            top = next((t for t in trees if p.startswith(f"['{t}']")), None)
            if top is None:
                continue  # opt_state, step: not needed at eval
            keys = _dict_keys(p)
            node = trees[top]
            for k in keys[1:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.asarray(data[f"arr_{i}"])
    return trees["params"], trees["bn_state"], epoch


def load_jax_checkpoint(path: str, model: torch.nn.Module) -> int:
    """Load a JAX-written (or :func:`save_checkpoint`-written) v2 file
    into ``model``. Raises on a missing or extra layer or leaf and on a
    shape mismatch. Returns the checkpoint's epoch."""
    params, bn_state, epoch = read_jax_checkpoint(path)
    state = params_from_jax(params, bn_state)
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint {path} does not match the model: "
                         f"missing {missing}, extra {extra}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"checkpoint leaf {name}: shape {tuple(t.shape)} "
                             f"!= model {tuple(want[name].shape)}")
    model.load_state_dict(state, strict=True)
    return epoch


def save_checkpoint(path: str, model: torch.nn.Module, *, epoch: int = 0,
                    step: int = 0) -> str:
    """Write the model as a format-v2 ``.npz`` (params, bn_state, epoch,
    step; no optimizer state), leaves in the JAX flatten order."""
    leaves = {("epoch",): np.asarray(epoch), ("step",): np.asarray(step)}
    for name, t in model.state_dict().items():
        keys = tuple(name.split("."))
        top = "bn_state" if keys[-1] in _STATE_LEAVES else "params"
        leaves[(top,) + keys] = t.detach().cpu().numpy()
    order = sorted(leaves)  # JAX flattens dicts in sorted key order
    arrays = {f"arr_{i}": leaves[k] for i, k in enumerate(order)}
    arrays["__format__"] = np.asarray(CHECKPOINT_FORMAT)
    arrays["__keypaths__"] = np.asarray(
        ["".join(f"['{k}']" for k in keys) for keys in order])
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    return path


class CheckpointManager:
    """Rolling ``Checkpoint_epoch-<n>.npz`` files (the newest
    ``max_to_keep``) plus ``Checkpoint_epoch-best.npz``, the copy with the
    best metric so far (utils/checkpoint.py::CheckpointManager)."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._kept = []
        self.best_metric = -np.inf
        os.makedirs(directory, exist_ok=True)

    def save(self, model: torch.nn.Module, epoch: int, metric: float, *,
             step: int = 0) -> str:
        path = save_checkpoint(
            os.path.join(self.directory, f"Checkpoint_epoch-{epoch}.npz"),
            model, epoch=epoch, step=step)
        self._kept.append(path)
        while len(self._kept) > self.max_to_keep:
            old = self._kept.pop(0)
            if os.path.exists(old):
                os.remove(old)
        if metric > self.best_metric:
            self.best_metric = float(metric)
            shutil.copyfile(path, self.best_path())
        return path

    def best_path(self) -> str:
        return os.path.join(self.directory, "Checkpoint_epoch-best.npz")
