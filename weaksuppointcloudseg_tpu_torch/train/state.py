"""Adam with the learning rate written in every step, and the step counter.

Counterpart of weaksuppointcloudseg_tpu/train/state.py: ``optax.adam(b1=0.9,
b2=0.999, eps=1e-8)`` under ``inject_hyperparams``, TF1's AdamOptimizer
defaults (ShapeNet_DGCNN_trainer.py:105). The update is optax's:

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2,   t += 1
    p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

The moments update in place (the reference donates its state buffers to
the same effect). The model's BN statistics are buffers of the model.
"""

from __future__ import annotations

from typing import Iterable

import torch


class Adam:
    """Adam over ``params``; ``step`` counts the updates applied."""

    def __init__(self, params: Iterable[torch.nn.Parameter], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def apply_gradients(self, learning_rate: float) -> None:
        """One update with the gradients in ``p.grad`` (a missing gradient
        counts as zero, as a pytree leaf the loss does not reach)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        t = self.step + 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** t)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** t)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        torch._foreach_addcdiv_(self.params, mu_hat, denom,
                                value=-learning_rate)
        self.step = t
