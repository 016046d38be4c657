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

On the card the three are gathers over the graph's inverse
(:func:`inverse_graph`, built by ``scatter_add.cu``: one cluster launch
per batch where a cloud's build fits in its cluster's shared memory, three
launches over a global workspace past that, :func:`inverse_route`): every
destination row sums its sources in ascending flat slot order ``p*k + j``
and is written once, with no float atomics. That is the order in which
``index_add_`` sums on the CPU, so the kernels equal their plain versions
(``*_ref``) bit for bit, and every launch gives the same bits. Each
launch builds the inverse of its own graph first.

Each wrapper launches its CUDA kernels on CUDA tensors and takes its plain
version on CPU tensors; any other device raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build


class InverseGraph(NamedTuple):
    """The CSR of a [B, P, k] kNN graph by destination row.

    offsets: int32 [B, N + 1]; the sources of row t of cloud b are
      ``src[b, offsets[b, t]:offsets[b, t + 1]]``.
    src: int32 [B, P * k] flat source slots ``p * k + j``, ascending within
      each row; the slots whose target lies outside [0, N) are skipped and
      the places past ``offsets[b, N]`` hold -1.
    k: the graph's slots per point.
    """

    offsets: torch.Tensor
    src: torch.Tensor
    k: int


def _flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [B*P*k] row indices of ``idx`` into the flattened [B*N] rows."""
    base = torch.arange(idx.shape[0], device=idx.device)[:, None, None] * n
    return (idx.long() + base).reshape(-1)


def inverse_graph_ref(idx: torch.Tensor, n: int) -> InverseGraph:
    """Plain PyTorch version of :func:`inverse_graph`: a stable sort of the
    flat destination keys (targets outside [0, n) sort last)."""
    b, p, k = idx.shape
    t = idx.reshape(b, p * k).long()
    key = torch.where((t >= 0) & (t < n), t, n)
    src = torch.sort(key, dim=1, stable=True).indices.int()
    counts = torch.zeros((b, n + 1), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.zeros((b, n + 1), dtype=torch.long, device=idx.device)
    offsets[:, 1:] = torch.cumsum(counts[:, :n], dim=1)
    skipped = torch.arange(p * k, device=idx.device)[None] >= offsets[:, n:]
    return InverseGraph(offsets.int(), torch.where(skipped, -1, src), k)


# the build's constants (scatter_add.cu)
_INV_CHUNK = 4096  # slots of a block of the three-launch build
_CLUSTER, _CLUSTER_WARPS = 8, 8  # blocks of a cloud's cluster, warps a block
_CLUSTER_MISC = 36  # ints of a cluster block's scan sums and scalars
_PLACE_WARPS = 8  # at most, of a place block of the three-launch build
_SMEM_CAP = 227 * 1024  # shared memory a block can use


@functools.lru_cache(maxsize=256)
def inverse_route(p: int, k: int, n: int):
    """(route, shared bytes, workspace ints per cloud) of the inverse build
    of a [B, p, k] graph with ``n`` rows, by shape alone, as
    ``scatter_add.cu::inverse_graph_route`` picks it: "cluster" (one
    launch, one 8-block cluster per cloud) where a block's shared memory,
    4 ((4 + 1) n + ceil(p k / 8) + ceil(n / 8) + 36) bytes, fits in 227
    KB; else "chunks" (three launches over a global workspace of
    ceil(p k / 4096) n ints per cloud) where n ints fit (n <= 58,112);
    else None."""
    s = p * k
    if p < 0 or k < 0 or n < 1 or s >= 2**31:
        return None, 0, 0
    seg = max(1, -(-s // _CLUSTER))
    words = (_CLUSTER_WARPS + 1) // 2  # the warps' cursors, two a word
    cluster = 4 * ((words + 1) * n + seg + -(-n // _CLUSTER) + _CLUSTER_MISC)
    if cluster <= _SMEM_CAP:
        return "cluster", cluster, 0
    if 4 * n > _SMEM_CAP:
        return None, 0, 0
    w = _PLACE_WARPS
    while w > 1 and 4 * w * n > _SMEM_CAP:
        w -= 1
    return "chunks", 4 * w * n, -(-s // _INV_CHUNK) * n


def inverse_graph(idx: torch.Tensor, n: int) -> InverseGraph:
    """The inverse of the kNN graph ``idx`` (int32 [B, P, k]) with ``n``
    destination rows: on CUDA the build :func:`inverse_route` picks (a
    stable counting sort; n up to 58,112), on the CPU the plain
    version."""
    if idx.device.type == "cpu":
        return inverse_graph_ref(idx, n)
    if idx.device.type != "cuda":
        raise ValueError(f"inverse_graph: unsupported device {idx.device}")
    return _build_inverse(idx, n, None)


def _build_inverse(idx: torch.Tensor, n: int, route) -> InverseGraph:
    """The inverse on CUDA by ``route`` ("cluster" or "chunks", each where
    it takes the shape), or by the route the launcher picks (None)."""
    b, p, k = idx.shape
    dev = idx.device
    _build.check_operand(idx, "idx", torch.int32, dev, (b, p, k))
    buf, args = _inverse_args(idx, n, route)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        if route == "cluster":
            code = lib.inverse_graph_cluster_launch(args[0], b, p, k, n,
                                                    *args[1:3], stream)
        elif route == "chunks":
            code = lib.inverse_graph_chunks_launch(args[0], b, p, k, n,
                                                   *args[1:], stream)
        else:
            code = lib.inverse_graph_launch(args[0], b, p, k, n, *args[1:],
                                            stream)
    _build.check(code, "inverse_graph")
    inverse_graph.launches += 1
    n_off = b * (n + 1)
    return InverseGraph(buf[:n_off].view(b, n + 1),
                        buf[n_off:n_off + b * p * k].view(b, p * k), k)


def _inverse_args(idx: torch.Tensor, n: int, route=None):
    """(one buffer for the inverse of ``idx`` (int32 [B, P, k] on CUDA):
    offsets [B, n+1], src [B, P*k] and ``route``'s workspace (the
    three-launch build's counts and then cursors per chunk of slots and
    row; none for the cluster build; None: the route the shape picks),
    and the launch arguments idx, offsets, src, workspace and its length
    as pointers into it). The caller holds the buffer until it has
    launched (freed earlier, its memory could pass to its output)."""
    b, p, k = idx.shape
    n_off, n_src = b * (n + 1), b * p * k
    if route is None:
        n_work = b * inverse_route(p, k, n)[2]
    else:
        n_work = b * -(-(p * k) // _INV_CHUNK) * n if route == "chunks" else 0
    buf = torch.empty(n_off + n_src + n_work, dtype=torch.int32,
                      device=idx.device)
    ptr = buf.data_ptr()
    return buf, (idx.data_ptr(), ptr, ptr + 4 * n_off,
                 ptr + 4 * (n_off + n_src), n_work)


def gather_sum_ref(inv: InverseGraph, vals: torch.Tensor) -> torch.Tensor:
    """The kernels' sum written out in plain PyTorch: out [B, N, C] f32,
    each row adding ``vals[b, s]`` ([B, S, C] at the flat slots s of the
    inverse's graph) over its sources in CSR order, one position of every
    row at a time. A test's independent check of the order."""
    b, n1 = inv.offsets.shape
    n, c = n1 - 1, vals.shape[-1]
    offs = inv.offsets.long()
    deg = offs[:, 1:] - offs[:, :-1]
    out = torch.zeros((b, n, c), dtype=torch.float32, device=vals.device)
    bi = torch.arange(b, device=vals.device)[:, None].expand(b, n)
    for r in range(int(deg.max()) if deg.numel() else 0):
        live = deg > r
        s = inv.src.long()[bi[live], offs[:, :-1][live] + r]
        out[live] = out[live] + vals[bi[live], s].float()
    return out


def scatter_add_ref(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add` (same contract)."""
    b, c = g.shape[0], g.shape[-1]
    out = torch.zeros((b * n, c), dtype=torch.float32, device=g.device)
    valid = ((idx >= 0) & (idx < n)).reshape(-1)
    out.index_add_(0, _flat_rows(idx, n)[valid], g.reshape(-1, c).float()[valid])
    return out.reshape(b, n, c)


def scatter_add(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """``out[b, idx[b, p, j]] += g[b, p, j]`` -> f32 [B, n, C].

    Args:
      idx: int32 [B, P, k] target rows; rows outside [0, n) are skipped.
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
    held, inv_args = _inverse_args(idx, n)
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.scatter_add_launch(g.data_ptr(), *inv_args, b, p, k, n, c,
                                      out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "scatter_add")
    inverse_graph.launches += 1
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
    du = torch.zeros_like(dy[:, :, 0])
    for j in range(k):  # the slots in order, as the kernel sums them
        du = du + dy[:, :, j]
    # dv takes the cotangent rounded to y's dtype, as the kernel's bf16
    # one-hot-matmul operands in the reference
    return scatter_add_ref(idx, dy.to(y.dtype), n), du


def scatter_bn_bwd(idx: torch.Tensor, y: torch.Tensor, big, sv: torch.Tensor,
                   alpha: torch.Tensor, beta: torch.Tensor, n: int):
    """(dv, du) of ``dy = first + alpha + beta * y`` without a dy tensor.

    Args:
      idx: int32 [B, P, k] target rows; rows outside [0, n) are skipped.
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
    held, inv_args = _inverse_args(idx, n)
    dv = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    du = torch.empty((b, p, c), dtype=torch.float32, device=dev)
    dyb = torch.empty_like(y)  # scratch: bf16(dy), the gather's rows
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.scatter_bn_bwd_launch(
            *inv_args, y.data_ptr(), *map(_build.ptr, (dz, q, asel, sv)),
            alpha.data_ptr(), beta.data_ptr(), b, p, k, n, c, dyb.data_ptr(),
            dv.data_ptr(), du.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "scatter_bn_bwd")
    inverse_graph.launches += 1
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
      idx: int32 [B, P, k] target rows; rows outside [0, n) are skipped.
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
    held, inv_args = _inverse_args(idx, n)
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.scatter_add_weighted_launch(
            w.data_ptr(), ct.data_ptr(), *inv_args, b, p, k, n, c,
            out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "scatter_add_weighted")
    inverse_graph.launches += 1
    scatter_add_weighted.launches += 1
    return out


inverse_graph.launches = 0  # inverse builds (alone or in a scatter) since the last reset
scatter_add.launches = 0
scatter_bn_bwd.launches = 0
scatter_add_weighted.launches = 0
