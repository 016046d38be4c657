"""Kernel B14: the bf16 neighbour-row gather (``ops/csrc/gather_rows.cu``).

Counterpart of weaksuppointcloudseg_tpu/ops/gather_pallas.py::
gather_rows_pallas: ``out[b, p, j] = f[b, idx[b, p, j]]``, bit for bit. The
reference gathers bf16 rows this way on its accelerator and leaves f32 to
XLA's gather (ops/neighbors.py:65-81); ops/neighbors.py routes the same way.

``gather_rows`` launches the CUDA kernel on CUDA tensors and takes the
plain version ``gather_rows_ref`` (indexing) on CPU tensors; any other
device raises.
"""

from __future__ import annotations

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build


def gather_rows_ref(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_rows` (same contract)."""
    b = torch.arange(f.shape[0], device=f.device)[:, None, None]
    return f[b, idx.long()]


def gather_rows(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, p, j] = f[b, idx[b, p, j]]`` -> bf16 [B, P, k, C].

    Args:
      f: bf16 [B, N, C] source rows.
      idx: int32 [B, P, k] row indices, each in [0, N). The kernel does not
        clamp: an index outside the range stops it with a device trap.
    """
    if f.device.type == "cpu":
        return gather_rows_ref(f, idx)
    if f.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {f.device}")
    b, n, c = f.shape
    p, k = idx.shape[1], idx.shape[2]
    dev = f.device
    _build.check_operand(f, "f", torch.bfloat16, dev, (b, n, c))
    _build.check_operand(idx, "idx", torch.int32, dev, (b, p, k))
    out = torch.empty((b, p, k, c), dtype=torch.bfloat16, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.gather_rows_launch(f.data_ptr(), idx.data_ptr(), b, n, p, k,
                                      c, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0  # kernel launches since the last reset
