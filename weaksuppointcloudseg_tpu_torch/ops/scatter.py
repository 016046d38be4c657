"""Neighbour scatter kernels, counterparts of weaksuppointcloudseg_tpu/ops/
scatter_pallas.py:

- B13 ``scatter_add`` (``ops/csrc/scatter_add.cu``, scatter_add_pallas):
  ``out[b, idx[b, p, j], :] += g[b, p, j, :]``, the backward of
  ``ops/neighbors.py::gather_neighbors``;
- B4 ``scatter_bn_bwd`` (``ops/csrc/scatter_bn.cu``,
  scatter_bn_bwd_pallas): the same scatter of a batch-norm cotangent
  assembled on the fly from the saved pre-BN activations, the backward of
  the fused EdgeConv stages' first conv (models/layers.py);
- B6 ``scatter_add_weighted`` (``ops/csrc/scatter_w.cu``,
  scatter_add_weighted_pallas): ``out[b, idx[b, p, j]] += w[b, p, j] *
  ct[b, p]``, one cotangent row shared by the k slots, the backward of the
  weighted gathers of the smoothness loss (ops/wgather.py).

Each wrapper launches its CUDA kernel on CUDA tensors and takes its plain
version (``*_ref``) on CPU tensors; any other device raises. The kernels
add with f32 atomics, so the k contributions to a row sum in an order that
changes from run to run (the Pallas kernels sum in one-hot-matmul order):
results agree with the plain versions to f32 rounding of the sums, not
bitwise.
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


def scatter_bn_bwd_ref(idx, y, big, sv, alpha, beta, n: int):
    """Plain PyTorch version of :func:`scatter_bn_bwd` (same contract)."""
    k = idx.shape[2]
    if isinstance(big, tuple):
        q, asel = big
        onek = asel[:, :, None, :] == torch.arange(k, device=y.device)[:, None]
        first = torch.where(onek, q[:, :, None, :], 0.0)
    else:
        first = sv * big.float()
    dy = (first + alpha) + beta * y.float()
    # dv takes the cotangent rounded to y's dtype, as the kernel's bf16
    # one-hot-matmul operands in the reference
    return scatter_add_ref(idx, dy.to(y.dtype), n), dy.sum(dim=2)


def scatter_bn_bwd(idx: torch.Tensor, y: torch.Tensor, big, sv: torch.Tensor,
                   alpha: torch.Tensor, beta: torch.Tensor, n: int):
    """(dv, du) of ``dy = first + alpha + beta * y`` without a dy tensor.

    Args:
      idx: int32 [B, P, k] target rows, each in [0, n).
      y: bf16 [B, P, k, C] saved pre-BN activations.
      big: dense mode dz bf16 [B, P, k, C] (first = sv * dz), or sparse
        mode (q f32 [B, P, C], asel int32 [B, P, C]) (first = q at the
        slot asel, 0 elsewhere).
      sv, alpha, beta: [C] f32 (sv is ignored in sparse mode).
      n: rows of dv.

    Returns:
      (dv f32 [B, n, C] = scatter-add of bf16(dy) into the rows idx,
       du f32 [B, P, C] = sum over the slots of the f32 dy).
    """
    if y.device.type == "cpu":
        return scatter_bn_bwd_ref(idx, y, big, sv, alpha, beta, n)
    if y.device.type != "cuda":
        raise ValueError(f"scatter_bn_bwd: unsupported device {y.device}")
    b, p, k = idx.shape
    c = y.shape[-1]
    dev = y.device
    _build.check_operand(idx, "idx", torch.int32, dev, (b, p, k))
    _build.check_operand(y, "y", torch.bfloat16, dev, (b, p, k, c))
    sparse = isinstance(big, tuple)
    if sparse:
        q, asel = big
        _build.check_operand(q, "q", torch.float32, dev, (b, p, c))
        _build.check_operand(asel, "asel", torch.int32, dev, (b, p, c))
        dz = sv = None
    else:
        dz, q, asel = big, None, None
        _build.check_operand(dz, "dz", torch.bfloat16, dev, (b, p, k, c))
        _build.check_operand(sv, "sv", torch.float32, dev, (c,))
    for t, name in ((alpha, "alpha"), (beta, "beta")):
        _build.check_operand(t, name, torch.float32, dev, (c,))
    dv = torch.zeros((b, n, c), dtype=torch.float32, device=dev)
    du = torch.empty((b, p, c), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.scatter_bn_bwd_launch(
            idx.data_ptr(), y.data_ptr(),
            *map(_build.ptr, (dz, q, asel, sv)), alpha.data_ptr(),
            beta.data_ptr(), b, p, k, n, c, dv.data_ptr(), du.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "scatter_bn_bwd")
    scatter_bn_bwd.launches += 1
    return dv, du


def scatter_add_weighted_ref(idx: torch.Tensor, w: torch.Tensor,
                             ct: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add_weighted` (same
    contract)."""
    return scatter_add_ref(idx, w[..., None] * ct[:, :, None, :].float(), n)


def scatter_add_weighted(idx: torch.Tensor, w: torch.Tensor, ct: torch.Tensor,
                         n: int) -> torch.Tensor:
    """``out[b, idx[b, p, j]] += w[b, p, j] * ct[b, p]`` -> f32 [B, n, C].

    Args:
      idx: int32 [B, P, k] target rows, each in [0, n).
      w: f32 [B, P, k] per-slot weights.
      ct: f32 [B, P, C] contributions, shared by the k slots.
      n: rows of the output.
    """
    if ct.device.type == "cpu":
        return scatter_add_weighted_ref(idx, w, ct, n)
    if ct.device.type != "cuda":
        raise ValueError(f"scatter_add_weighted: unsupported device {ct.device}")
    b, p, k = idx.shape
    c = ct.shape[-1]
    dev = ct.device
    _build.check_operand(idx, "idx", torch.int32, dev, (b, p, k))
    _build.check_operand(w, "w", torch.float32, dev, (b, p, k))
    _build.check_operand(ct, "ct", torch.float32, dev, (b, p, c))
    out = torch.zeros((b, n, c), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.scatter_add_weighted_launch(
            idx.data_ptr(), w.data_ptr(), ct.data_ptr(), b, p, k, n, c,
            out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "scatter_add_weighted")
    scatter_add_weighted.launches += 1
    return out


scatter_add.launches = 0  # kernel launches since the last reset
scatter_bn_bwd.launches = 0
scatter_add_weighted.launches = 0
