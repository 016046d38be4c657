"""Model weights made from the run's seed, on the device, in one call of
the device's generator; the same tensors go to the program and to the
reference.

Kinds (reference/dgcnn.py::param_specs): a conv weight is Glorot-uniform
(the models' own initialiser); biases and BN betas are uniform in +-0.05,
BN gammas in [0.8, 1.2], stored BN means in +-0.05 and variances in [0.5,
1.5]; the transform's output weight is uniform in +-0.01 and its bias the
identity.

A test cell serves a model whose stored BN moments are those of its data,
as a trained model's are: :func:`calibrate` sets them to the batch
moments of a training-mode forward of the reference over a few of the
cell's clouds (dropout masks from the seed), layer by layer in order.
Its BN gammas are drawn in [0.2, 0.3] (``SERVED_GAMMA``): with gammas
near 1 a random network whose BN moments fit its data amplifies any
rounding, so that bfloat16 arithmetic alone (the program, or the
reference rounded to bfloat16) moves one label in four against float32,
as float8 moves two; at gammas near 0.25 bfloat16 moves one in twelve
and float8 still four in ten.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SERVED_GAMMA = (0.2, 0.3)

def make(specs: List[Tuple[str, Tuple[int, ...], str]], seed: int,
         device, gamma: Tuple[float, float] = (0.8, 1.2)) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(specs, sizes):
        v = u[at:at + size].reshape(shape)
        at += size
        if kind == "w":
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            v = (2 * v - 1) * lim
        elif kind in ("b", "beta", "mean"):
            v = (2 * v - 1) * 0.05
        elif kind == "gamma":
            v = gamma[0] + (gamma[1] - gamma[0]) * v
        elif kind == "var":
            v = 0.5 + v
        elif kind == "tw":
            v = (2 * v - 1) * 0.01
        elif kind == "tb":
            side = math.isqrt(size)
            v = torch.eye(side, device=device).reshape(-1)
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = v.contiguous()
    return out


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into a module's parameters and buffers, which must
    carry exactly these names."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    if set(state) != set(weights):
        raise ValueError("the model's tensors and the benchmark's weights "
                         f"differ: {sorted(set(state) ^ set(weights))}")
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(weights[name])


def calibrate(model: dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
              cat_onehot, seed: int) -> None:
    """Set the stored BN moments in ``w`` to the batch moments of the
    reference's training-mode forward of x [B, N, C], in place."""
    from reference import dgcnn

    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    net = dgcnn.Net(model, w, lambda t: t)
    with torch.no_grad():
        net.forward(x, cat_onehot, training=True, generator=gen)
    for name, (mean, var) in net.moments.items():
        w[f"{name}.mean"].copy_(mean)
        w[f"{name}.var"].copy_(var)
