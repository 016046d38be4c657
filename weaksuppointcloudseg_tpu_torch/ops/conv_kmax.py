"""The conv + max kernels of the fused blocks.

Counterparts of weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py:

- B7 ``conv_zmax`` / B8 ``conv_znmax`` (``ops/csrc/conv_kmax.cu``), eval:
  the second conv of an EdgeConv stage with its k-max, and the
  global-aggregation conv with its max over points. The BN population
  affine ``z = s*y + t`` is known before launch, so it folds into the
  kernel and one running maximum of z is all that is kept.
- B2 ``conv_minmax`` / B5 ``conv_nmax`` (the same source and designs as
  B7/B8, with a training epilogue): the same convs reduced to the max and
  min over k (or N) with the first winning slot (lowest row) and the batch
  moments; BN's sign picks max or min once the moments are known
  (models/layers.py). B2 always folds BN1: the reference's no-fold mode
  serves only ``_conv_bn_kmax_train``, which no preset reaches (ROADMAP).
- B3 ``conv_kmax_bwd`` (``ops/csrc/conv_kmax_bwd.cu``) and B5
  ``conv_nmax_bwd`` (``ops/csrc/conv_nmax_bwd.cu``): their backwards.

The conv output never reaches memory in any of them, except that B5's
backward keeps bf16(dy) in a scratch buffer between its three products.

Each wrapper launches its CUDA kernel on CUDA tensors and takes the plain
version (``*_ref``) on CPU tensors; any other device raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build

ZMAX_C1 = (64, 128)  # input widths the B7 kernel is instantiated for
_ZN_RT, _ZN_CT, _TARGET_BLOCKS = 32, 128, 1056  # B8 tiling (see the .cu)


def _act(h1, scale1, shift1):
    """Upstream BN1 fold + relu, rounded to bf16 as the stored activations
    of the unfused path would be (conv_kmax_pallas.py:247-249)."""
    if scale1 is None:
        return h1.float()
    return torch.relu(h1.float() * scale1 + shift1).to(h1.dtype).float()


def conv_zmax_ref(h1, w2, b2, s2, t2, scale1=None, shift1=None):
    """Plain PyTorch version of :func:`conv_zmax` (same contract)."""
    y = torch.matmul(_act(h1, scale1, shift1), w2.float()) + b2
    z = y.to(h1.dtype).float() * s2 + t2  # bf16 rounding before BN2
    return torch.relu(z.amax(dim=2)).to(h1.dtype)


def conv_znmax_ref(h, w, b, s2, t2, n_valid: Optional[int] = None):
    """Plain PyTorch version of :func:`conv_znmax` (same contract)."""
    n = h.shape[1]
    nv = n if n_valid is None else min(n_valid, n)
    y = torch.matmul(h.float(), w.float()) + b
    z = y.to(h.dtype).float() * s2 + t2
    z[:, nv:] = -torch.inf
    return torch.relu(z.amax(dim=1))


def conv_minmax_ref(h1, w2, b2, scale1, shift1):
    """Plain PyTorch version of :func:`conv_minmax` (same contract)."""
    y = (torch.matmul(_act(h1, scale1, shift1), w2.float()) + b2).to(h1.dtype)
    y32 = y.float()
    # argmax/argmin return the first extremal slot, the kernel's rule
    amax = torch.argmax(y32, dim=2, keepdim=True)
    amin = torch.argmin(y32, dim=2, keepdim=True)
    mom = torch.stack([y32.sum(dim=(0, 1, 2)), (y32 * y32).sum(dim=(0, 1, 2))])
    return (torch.gather(y, 2, amax)[:, :, 0], amax[:, :, 0].int(),
            torch.gather(y, 2, amin)[:, :, 0], amin[:, :, 0].int(), mom)


def conv_nmax_ref(h, w, b):
    """Plain PyTorch version of :func:`conv_nmax` (same contract)."""
    y = (torch.matmul(h.float(), w.float()) + b).to(h.dtype).float()
    amax = torch.argmax(y, dim=1, keepdim=True)  # the lowest row on ties
    amin = torch.argmin(y, dim=1, keepdim=True)
    mom = torch.stack([y.sum(dim=(0, 1)), (y * y).sum(dim=(0, 1))])
    return (torch.gather(y, 1, amax)[:, 0], amax[:, 0].int(),
            torch.gather(y, 1, amin)[:, 0], amin[:, 0].int(), mom)


def conv_kmax_bwd_ref(h1, q, asel, w2t, m, row0, scale1, shift1, mean1, inv1):
    """Plain PyTorch version of :func:`conv_kmax_bwd` (same contract)."""
    k = h1.shape[2]
    h = _act(h1, scale1, shift1)
    onek = asel[:, :, None, :] == torch.arange(k, device=h1.device)[:, None]
    # the routed gradient, rounded to bf16 as the kernel's dot operand
    dq = torch.where(onek, q[:, :, None, :], 0.0).to(h1.dtype).float()
    tsp = torch.einsum("bnji,bnjc->ic", h, dq)
    gram = torch.einsum("bnji,bnjl->il", h, h)
    s1 = h.sum(dim=(0, 1, 2))
    dh = (torch.matmul(dq, w2t.float()) + torch.matmul(h, m.float())) + row0
    dz = torch.where(h > 0, dh, 0.0)
    xhat = (h1.float() - mean1) * inv1
    ab = torch.stack([dz.sum(dim=(0, 1, 2)), (dz * xhat).sum(dim=(0, 1, 2))])
    return dz.to(h1.dtype), tsp, gram, s1, ab


def nmax_bwd_cotangent(h, q, asel, w, b, alpha, beta):
    """B5 backward's cotangent of y = bf16(h @ w + b): (dy f32, bf16(dy)
    as f32), with dy = q * 1[n == asel] + alpha + beta * y."""
    n = h.shape[1]
    y = (torch.matmul(h.float(), w.float()) + b).to(h.dtype).float()
    rows = torch.arange(n, device=h.device)[None, :, None]
    first = torch.where(rows == asel[:, None, :], q[:, None, :], 0.0)
    dy = (first + alpha) + beta * y
    return dy, dy.to(h.dtype).float()


def conv_nmax_bwd_ref(h, q, asel, w, b, alpha, beta):
    """Plain PyTorch version of :func:`conv_nmax_bwd` (same contract)."""
    dy, dyc = nmax_bwd_cotangent(h, q, asel, w, b, alpha, beta)
    dh = torch.matmul(dyc, w.float().t()).to(h.dtype)
    dw = torch.einsum("bni,bno->io", h.float(), dyc)
    return dh, dw, dy.sum(dim=(0, 1))


def _check_vec(t, name, n, dev):
    _build.check_operand(t, name, torch.float32, dev, (n,))


def conv_zmax(h1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              s2: torch.Tensor, t2: torch.Tensor,
              scale1: Optional[torch.Tensor] = None,
              shift1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(max_j(s2 * bf16(act(h1_j) @ w2 + b2) + t2)), eval only.

    Args:
      h1: [B, N, k, C1] bf16: the raw first-conv output y1 when the BN1
        fold (scale1, shift1) is given, else activations.
      w2: [C1, C2] bf16. b2, s2, t2: [C2] f32 (bias, BN2 affine).
      scale1, shift1: optional [C1] f32 BN1 affine, folded with a relu.

    Returns:
      [B, N, C2] bf16.
    """
    if h1.device.type == "cpu":
        return conv_zmax_ref(h1, w2, b2, s2, t2, scale1, shift1)
    if h1.device.type != "cuda":
        raise ValueError(f"conv_zmax: unsupported device {h1.device}")
    b, n, k, c1 = h1.shape
    c2 = w2.shape[1]
    dev = h1.device
    _build.check_operand(h1, "h1", torch.bfloat16, dev)
    _build.check_operand(w2, "w2", torch.bfloat16, dev, (c1, c2))
    for t, name in ((b2, "b2"), (s2, "s2"), (t2, "t2")):
        _check_vec(t, name, c2, dev)
    if (scale1 is None) != (shift1 is None):
        raise ValueError("conv_zmax: scale1 and shift1 come together")
    if scale1 is not None:
        _check_vec(scale1, "scale1", c1, dev)
        _check_vec(shift1, "shift1", c1, dev)
    if c1 not in ZMAX_C1:
        raise ValueError(f"conv_zmax: C1={c1} not in {ZMAX_C1}")
    if c2 % 32 or c2 > 1024:
        raise ValueError(f"conv_zmax: C2={c2} must be a multiple of 32 <= 1024")
    if k * c1 * 4 > 48 * 1024:
        raise ValueError(f"conv_zmax: a row of k={k} x C1={c1} exceeds the tile")
    out = torch.empty((b, n, c2), dtype=torch.bfloat16, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.conv_zmax_launch(
            h1.data_ptr(), w2.data_ptr(), b2.data_ptr(), s2.data_ptr(),
            t2.data_ptr(), _build.ptr(scale1), _build.ptr(shift1), b * n, k,
            c1, c2, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "conv_zmax")
    conv_zmax.launches += 1
    return out


def conv_znmax(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               s2: torch.Tensor, t2: torch.Tensor,
               n_valid: Optional[int] = None) -> torch.Tensor:
    """relu(max_{n < n_valid}(s2 * bf16(h_n @ w + b) + t2)), eval only.

    Args:
      h: [B, N, C1] bf16. w: [C1, C2] bf16. b, s2, t2: [C2] f32.
      n_valid: rows >= n_valid never enter the max (default: all rows).

    Returns:
      [B, C2] f32 (the caller casts it to the compute dtype).
    """
    if h.device.type == "cpu":
        return conv_znmax_ref(h, w, b, s2, t2, n_valid)
    if h.device.type != "cuda":
        raise ValueError(f"conv_znmax: unsupported device {h.device}")
    bsz, n, c1 = h.shape
    c2 = w.shape[1]
    dev = h.device
    _build.check_operand(h, "h", torch.bfloat16, dev)
    _build.check_operand(w, "w", torch.bfloat16, dev, (c1, c2))
    for t, name in ((b, "b"), (s2, "s2"), (t2, "t2")):
        _check_vec(t, name, c2, dev)
    if bsz > 65535:
        raise ValueError(f"conv_znmax: batch {bsz} exceeds the grid limit")
    nv = n if n_valid is None else max(0, min(n_valid, n))
    # split N so the grid holds about eight blocks per SM
    c_blocks = -(-c2 // _ZN_CT)
    nsplit = max(1, min(-(-n // _ZN_RT), -(-_TARGET_BLOCKS // (bsz * c_blocks))))
    part = torch.empty((bsz, nsplit, c2), dtype=torch.float32, device=dev)
    out = torch.empty((bsz, c2), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.conv_znmax_launch(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), s2.data_ptr(),
            t2.data_ptr(), bsz, n, c1, c2, nv, nsplit, part.data_ptr(),
            out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "conv_znmax")
    conv_znmax.launches += 1
    return out


def conv_minmax(h1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                scale1: torch.Tensor, shift1: torch.Tensor):
    """y = bf16(bf16(relu(h1 * scale1 + shift1)) @ w2 + b2) reduced over
    the k slots (training).

    Args:
      h1: [B, N, k, C1] bf16: the raw first-conv output y1.
      w2: [C1, C2] bf16. b2: [C2] f32.
      scale1, shift1: [C1] f32 BN1 affine, folded with a relu.

    Returns:
      (ymax bf16 [B,N,C2], amax int32 [B,N,C2], ymin bf16, amin int32,
       mom f32 [2, C2]): the k-extrema of y with the first winning slot,
      and sum(y), sum(y^2) over all (b, n, j).
    """
    if h1.device.type == "cpu":
        return conv_minmax_ref(h1, w2, b2, scale1, shift1)
    if h1.device.type != "cuda":
        raise ValueError(f"conv_minmax: unsupported device {h1.device}")
    b, n, k, c1 = h1.shape
    c2 = w2.shape[1]
    dev = h1.device
    _build.check_operand(h1, "h1", torch.bfloat16, dev)
    _build.check_operand(w2, "w2", torch.bfloat16, dev, (c1, c2))
    for t, name, width in ((b2, "b2", c2), (scale1, "scale1", c1),
                           (shift1, "shift1", c1)):
        _check_vec(t, name, width, dev)
    if c1 != 64:
        raise ValueError(f"conv_minmax: C1={c1}: the kernel takes C1=64")
    if c2 % 32 or c2 > 1024:
        raise ValueError(f"conv_minmax: C2={c2} must be a multiple of 32 <= 1024")
    if k * c1 * 4 > 48 * 1024:
        raise ValueError(f"conv_minmax: a row of k={k} x C1={c1} exceeds the tile")
    ymax = torch.empty((b, n, c2), dtype=torch.bfloat16, device=dev)
    amax = torch.empty((b, n, c2), dtype=torch.int32, device=dev)
    ymin = torch.empty_like(ymax)
    amin = torch.empty_like(amax)
    mom = torch.zeros((2, c2), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.conv_minmax_launch(
            h1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scale1.data_ptr(),
            shift1.data_ptr(), b * n, k, c2, ymax.data_ptr(),
            amax.data_ptr(), ymin.data_ptr(), amin.data_ptr(), mom.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "conv_minmax")
    conv_minmax.launches += 1
    return ymax, amax, ymin, amin, mom


def conv_nmax(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """y = bf16(h @ w + b) reduced over the points (training).

    Args:
      h: [B, N, C1] bf16. w: [C1, C2] bf16. b: [C2] f32.

    Returns:
      (ymax f32 [B, C2], amax int32 [B, C2] (the lowest winning row),
       ymin f32, amin int32, mom f32 [2, C2]).
    """
    if h.device.type == "cpu":
        return conv_nmax_ref(h, w, b)
    if h.device.type != "cuda":
        raise ValueError(f"conv_nmax: unsupported device {h.device}")
    bsz, n, c1 = h.shape
    c2 = w.shape[1]
    dev = h.device
    _build.check_operand(h, "h", torch.bfloat16, dev)
    _build.check_operand(w, "w", torch.bfloat16, dev, (c1, c2))
    _check_vec(b, "b", c2, dev)
    if bsz > 65535 or n < 1:
        raise ValueError(f"conv_nmax: batch {bsz} or N={n} out of range")
    c_blocks = -(-c2 // _ZN_CT)
    nsplit = max(1, min(-(-n // _ZN_RT), -(-_TARGET_BLOCKS // (bsz * c_blocks))))
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    part = [torch.empty((bsz, nsplit, c2), **kw) for kw in (f32, i32, f32, i32)]
    out = [torch.empty((bsz, c2), **kw) for kw in (f32, i32, f32, i32)]
    mom = torch.zeros((2, c2), **f32)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.conv_nmax_launch(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), bsz, n, c1, c2, nsplit,
            *[t.data_ptr() for t in part], *[t.data_ptr() for t in out],
            mom.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "conv_nmax")
    conv_nmax.launches += 1
    return (*out, mom)


def conv_kmax_bwd(h1: torch.Tensor, q: torch.Tensor, asel: torch.Tensor,
                  w2t: torch.Tensor, m: torch.Tensor, row0: torch.Tensor,
                  scale1: torch.Tensor, shift1: torch.Tensor,
                  mean1: torch.Tensor, inv1: torch.Tensor):
    """One-pass backward of the BN1 fold + conv2 + BN2 + relu + k-max
    block.

    Args:
      h1: [B, N, k, C1] bf16: the raw first-conv output y1.
      q: [B, N, C2] f32 k-max-routed gradient. asel: [B, N, C2] int32
        winning slot.
      w2t: [C2, C1] bf16 (W2 transposed). m: [C1, C1] bf16 dense BN
        correction W2 diag(Bv) W2^T. row0: [C1] f32 constant row.
      scale1, shift1, mean1, inv1: [C1] f32 BN1 fold constants.

    Returns:
      (dz1 bf16 [B,N,k,C1] (the relu-masked dh), T_sp f32 [C1,C2], G f32
       [C1,C1], S1 f32 [C1], ab f32 [2, C1] = (sum dz1, sum dz1 * xhat1)
       from the f32 dz1).
    """
    if h1.device.type == "cpu":
        return conv_kmax_bwd_ref(h1, q, asel, w2t, m, row0, scale1, shift1,
                                 mean1, inv1)
    if h1.device.type != "cuda":
        raise ValueError(f"conv_kmax_bwd: unsupported device {h1.device}")
    b, n, k, c1 = h1.shape
    c2 = q.shape[-1]
    dev = h1.device
    _build.check_operand(h1, "h1", torch.bfloat16, dev)
    _build.check_operand(q, "q", torch.float32, dev, (b, n, c2))
    _build.check_operand(asel, "asel", torch.int32, dev, (b, n, c2))
    _build.check_operand(w2t, "w2t", torch.bfloat16, dev, (c2, c1))
    _build.check_operand(m, "m", torch.bfloat16, dev, (c1, c1))
    for t, name in ((row0, "row0"), (scale1, "scale1"), (shift1, "shift1"),
                    (mean1, "mean1"), (inv1, "inv1")):
        _check_vec(t, name, c1, dev)
    if c1 != 64 or c2 not in (64, 128):
        raise ValueError(f"conv_kmax_bwd: C1={c1}, C2={c2}: the kernel takes "
                         "C1=64 and C2 in (64, 128)")
    dz = torch.empty_like(h1)
    tsp = torch.zeros((c1, c2), dtype=torch.float32, device=dev)
    gram = torch.zeros((c1, c1), dtype=torch.float32, device=dev)
    s1ab = torch.zeros((3, c1), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.conv_kmax_bwd_launch(
            h1.data_ptr(), q.data_ptr(), asel.data_ptr(), w2t.data_ptr(),
            m.data_ptr(), row0.data_ptr(), scale1.data_ptr(), shift1.data_ptr(),
            mean1.data_ptr(), inv1.data_ptr(),
            b * n, k, c1, c2, dz.data_ptr(), tsp.data_ptr(), gram.data_ptr(),
            s1ab.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "conv_kmax_bwd")
    conv_kmax_bwd.launches += 1
    return dz, tsp, gram, s1ab[0], s1ab[1:]


_BWD_TARGET_BLOCKS = 528  # four blocks per SM for the dW split


def conv_nmax_bwd(h: torch.Tensor, q: torch.Tensor, asel: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor,
                  beta: torch.Tensor):
    """Backward of conv + BN + relu + max over the points.

    Args:
      h: [B, N, C1] bf16. q: [B, C2] f32 routed gradient. asel: [B, C2]
        int32 winning row. w: [C1, C2] bf16. b, alpha, beta: [C2] f32
        (bias and the BN dense correction dy = sparse + alpha + beta*y).

    Returns:
      (dh bf16 [B, N, C1], dW f32 [C1, C2], db f32 [C2]).
    """
    if h.device.type == "cpu":
        return conv_nmax_bwd_ref(h, q, asel, w, b, alpha, beta)
    if h.device.type != "cuda":
        raise ValueError(f"conv_nmax_bwd: unsupported device {h.device}")
    bsz, n, c1 = h.shape
    c2 = w.shape[1]
    dev = h.device
    _build.check_operand(h, "h", torch.bfloat16, dev)
    _build.check_operand(q, "q", torch.float32, dev, (bsz, c2))
    _build.check_operand(asel, "asel", torch.int32, dev, (bsz, c2))
    _build.check_operand(w, "w", torch.bfloat16, dev, (c1, c2))
    for t, name in ((b, "b"), (alpha, "alpha"), (beta, "beta")):
        _check_vec(t, name, c2, dev)
    if c1 % 64 or c2 % 64:
        raise ValueError(f"conv_nmax_bwd: C1={c1} and C2={c2} must be "
                         "multiples of 64")
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv_nmax_bwd: h and w must be 16-byte aligned")
    rows = bsz * n
    tiles = (c1 // 64) * (c2 // 64)
    ksplit = max(1, min(-(-rows // 64), -(-_BWD_TARGET_BLOCKS // tiles)))
    dyc = torch.empty((rows, c2), dtype=torch.bfloat16, device=dev)
    dh = torch.empty_like(h)
    dw = torch.zeros((c1, c2), dtype=torch.float32, device=dev)
    db = torch.zeros((c2,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.conv_nmax_bwd_launch(
            h.data_ptr(), q.data_ptr(), asel.data_ptr(), w.data_ptr(),
            b.data_ptr(), alpha.data_ptr(), beta.data_ptr(), bsz, n, c1, c2,
            ksplit, dyc.data_ptr(), dh.data_ptr(), dw.data_ptr(),
            db.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "conv_nmax_bwd")
    conv_nmax_bwd.launches += 1
    return dh, dw, db


conv_zmax.launches = 0  # kernel launches since the last reset
conv_znmax.launches = 0
conv_minmax.launches = 0
conv_nmax.launches = 0
conv_kmax_bwd.launches = 0
conv_nmax_bwd.launches = 0
