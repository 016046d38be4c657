"""How well-conditioned the f32 Full-style train step is at the tiny test
size, against how far the port's gradients lie from the JAX package's.

    JAX_PLATFORMS=cpu python scripts/torch_step_sensitivity.py

For seeds 0-4 (tests/test_torch_train.py's tiny config, weights with an
active input transform): the largest gradient difference, over all
leaves, as a share of the largest gradient entry, (a) port against JAX on
the same input and (b) the port against itself with the input scaled by
1 + 1e-7. Where (b) is large the step is ill-conditioned and (a) can be no
smaller; the tests' tolerances after the first update follow from it.
CPU only.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_train as t  # noqa: E402


def port_grads(params, state, batch, scale=1.0):
    cfg = t.jax_cfg()
    model = t.port_model(cfg, params, state)
    tb = t.to_torch(batch)
    tb["data"] = tb["data"] * scale
    total, _, _ = t.loss_fn(model, tb, cfg=t.port_cfg(cfg), style="Full",
                            bn_decay=0.5, gate=1.0)
    total.backward()
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def worst(a, b):
    scale = max(np.abs(v).max() for v in b.values())
    return max(np.abs(a[n] - b[n]).max() for n in b) / scale


def main() -> None:
    for seed in range(5):
        params, state = t.jax_weights(t.jax_cfg(), seed=seed, transform=True)
        batch = t.make_batch(7 + seed)
        (_, _), grads = t._jax_grad(
            t.to_jax(params), t.to_jax(state), t.to_jax(batch),
            cfg=t.jax_cfg(), style="Full", bn_decay=jnp.float32(0.5),
            gate=jnp.float32(1.0), rng=jax.random.PRNGKey(1))
        want = {k: v.numpy() for k, v in t.params_from_jax(
            jax.tree.map(np.asarray, grads), {}).items()}
        got = port_grads(params, state, batch)
        moved = port_grads(params, state, batch, scale=1.0 + 1e-7)
        print(f"seed {seed}: port vs JAX {worst(got, want):.1e}, port vs "
              f"port at input x (1 + 1e-7) {worst(moved, got):.1e} "
              f"(of the largest gradient entry)")


if __name__ == "__main__":
    main()
