"""Kernel B13: neighbour scatter-add (``ops/csrc/scatter_add.cu``).

Counterpart of weaksuppointcloudseg_tpu/ops/scatter_pallas.py::
scatter_add_pallas: ``out[b, idx[b, p, j], :] += g[b, p, j, :]``, the
backward of ``ops/neighbors.py::gather_neighbors``.

``scatter_add`` launches the CUDA kernel on CUDA tensors and takes the
plain version ``scatter_add_ref`` (``index_add_``) on CPU tensors; any
other device raises. The kernel adds with f32 atomics, so the k
contributions to a row sum in an order that changes from run to run (the
Pallas kernel sums in one-hot-matmul order): results agree with the plain
version to f32 rounding of the sums, not bitwise.
"""

from __future__ import annotations

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build


def _flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [B*P*k] row indices of ``idx`` into the flattened [B*N] rows."""
    base = torch.arange(idx.shape[0], device=idx.device)[:, None, None] * n
    return (idx.long() + base).reshape(-1)


def scatter_add_ref(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add` (same contract)."""
    b, c = g.shape[0], g.shape[-1]
    out = torch.zeros((b * n, c), dtype=torch.float32, device=g.device)
    out.index_add_(0, _flat_rows(idx, n), g.reshape(-1, c).float())
    return out.reshape(b, n, c)


def scatter_add(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """``out[b, idx[b, p, j]] += g[b, p, j]`` -> f32 [B, n, C].

    Args:
      idx: int32 [B, P, k] target rows, each in [0, n).
      g: f32 [B, P, k, C] contributions.
      n: rows of the output.
    """
    if g.device.type == "cpu":
        return scatter_add_ref(idx, g, n)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add: unsupported device {g.device}")
    b, p, k = idx.shape
    c = g.shape[-1]
    dev = g.device
    _build.check_operand(idx, "idx", torch.int32, dev, (b, p, k))
    _build.check_operand(g, "g", torch.float32, dev, (b, p, k, c))
    out = torch.zeros((b, n, c), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.scatter_add_launch(idx.data_ptr(), g.data_ptr(), b, p, k, n,
                                      c, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "scatter_add")
    scatter_add.launches += 1
    return out


scatter_add.launches = 0  # kernel launches since the last reset
