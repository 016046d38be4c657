"""Precision of the reference: float32 with TF32 off, or the control.

The control is the reference with every matmul operand (weights,
activations, kNN coordinates) rounded to float8 e4m3 with one scale per
tensor (its largest magnitude maps to 448), the next precision below the
bfloat16 that the configurations state. Gradients pass the rounding
unchanged (straight through). ``tf32`` turns TF32 on for the label
propagation's f32 arithmetic, the next precision below its float32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, back in float32."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def e5m2_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e5m2 with a per-tensor scale, back in float32."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / 57344.0
    q = (x.detach() / scale).to(torch.float8_e5m2).float() * scale
    return x + (q - x).detach()


def int8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to int8 with a per-tensor symmetric scale, back in float32."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / 127.0
    q = torch.round(x.detach() / scale).clamp(-127, 127) * scale
    return x + (q - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in float32."""
    return x + (x.detach().to(torch.bfloat16).float() - x).detach()


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


QUANT = {"f32": identity, "fp8": fp8_round, "bf16": bf16_round, "e5m2": e5m2_round,
         "int8": int8_round}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for matmuls inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
