"""The unfused routes (``ModelConfig.use_fused_knn=False``) of the port
against the JAX package on the CPU: the plain distance + stable-sort kNN,
the eval forward and one Full-style training step of small ShapeNet- and
S3DIS-shaped models in f32 and bf16. On the card these routes run the same
composition with the gathers of bf16 rows through kernel B14 (its plain
version here) and their backward through B13; the JAX package runs its
plain composition on the CPU (its TPU-only bf16 guard does not fire).

Tolerances. f32: the same products summed in another order, as
tests/test_torch_model.py and tests/test_torch_train.py state (forward
logits rtol/atol 1e-4; loss components rtol 1e-4; each gradient leaf
within 2e-4 of its largest entry plus 1e-5 of the largest over all leaves;
BN state rtol 1e-4, atol 1e-5); the step's logits within 1e-4 of their
largest (measured 5.5e-6 to 3.6e-5 over five seed pairs, with or without
the fused kNN: the tiny f32 step is ill-conditioned, tests/test_torch_
train.py). bf16 forward: argmax agreement >= 99% and |dprob| <= 1e-2, as
tests/test_torch_model.py holds the bf16 forwards. bf16 step: both
packages round at the same points (ROADMAP C6), but their f32 sums run in
other orders. bf16 features make mathematically equal distances common,
which the two orders break differently, so later kNN graphs pick other
neighbours; and one f32 ulp of a batch moment flips bf16 roundings that
every later batch-moment BN spreads (measured without a replay: logits 6%
to 15% of their largest apart, loss terms up to 3%). So the JAX step
records its plain kNN graphs and batch moments and the port replays them
(utils/replay.py's plain tape). What is left is a conv output whose f32
sum, in another order, rounds to the other bf16 neighbour: measured, the
ShapeNet step's logits bitwise equal, the S3DIS step's within 1.7e-2 of
their largest (one such flip in a cloud's global feature moves that
cloud's logits; bitwise for five other weight seeds), the worst gradient
leaf at 0.61 of its tolerance. The step is held to
tests/test_torch_fused_step.py's bf16 tolerances (loss rtol 1e-3, logits
2e-2 of their largest, each leaf 0.1 of its largest entry plus 1e-2 of the
largest overall, BN state two bf16 ulps).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_blocks import assert_grads_close, np32, to_jax
from test_torch_model import both_models, inputs, jax_logits, small_cfg
from test_torch_s3dis import narrow_jax_cfg, s3dis_batch
from test_torch_train import jax_cfg, jax_weights, make_batch, port_cfg, to_torch
from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu.ops import neighbors as jnbr
from weaksuppointcloudseg_tpu.train.steps import _loss_fn
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import neighbors
from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn
from weaksuppointcloudseg_tpu_torch.utils import replay
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_graph_indices_exact(dtype):
    """The plain distance + stable sort against the JAX package's
    pairwise_sqdist + lax.top_k on tie-free random points (their bf16
    rounding too): the same indices, nearest first."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 150, 5)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jnbr.knn_graph(jnp.asarray(x, jdt), 12))
    got = neighbors.knn_graph(torch.from_numpy(x).to(getattr(torch, dtype)),
                              12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_graph_breaks_ties_by_lowest_index():
    """Exact ties (duplicate points) go to the lowest index, as
    lax.top_k orders them (ROADMAP C2)."""
    x = np.repeat(np.arange(5, dtype=np.float32), 4)[None, :, None]
    want = np.asarray(jnbr.knn_graph(jnp.asarray(x), 6))
    got = neighbors.knn_graph(torch.from_numpy(x), 6).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[0, 5]) == [4, 5, 6, 7, 0, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_forward_matches_jax(dtype):
    """The eval forward of a small ShapeNet model without the fused kNN,
    with a non-identity input transform."""
    cfg = small_cfg(compute_dtype=dtype, use_fused_knn=False)
    params, state, model = both_models(cfg, seed=6)
    x, cat = inputs(7)
    want = jax_logits(params, state, x, cat, cfg)
    with torch.inference_mode():
        got = model(torch.tensor(x), torch.tensor(cat))
    assert got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        return
    want = np.asarray(jax.nn.softmax(want, axis=-1))
    got = torch.softmax(got, -1).numpy()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.99
    assert np.abs(got - want).max() <= 1e-2


def unfused(cfg, dtype):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=dtype, use_fused_knn=False))


def recording(monkeypatch):
    """Patch the JAX package's plain kNN graph and batch norm to record,
    in the order the step runs them, utils/replay.py's plain tape: the
    graphs, and the batch moments of every training BN. The BN computes
    its moments by the reference formula (layers.py:93-110), records them,
    and normalizes with the JAX package's own _batch_norm given them as
    its statistics, so the recorded moments are the ones the step used
    and the gradient flows through them as in the original."""
    tape = []
    knn_graph, batch_norm = jnbr.knn_graph, jlayers._batch_norm

    def t(a):
        return torch.from_numpy(np.array(a))

    def graph(x, k):
        idx = knn_graph(x, k)
        jax.debug.callback(lambda i: tape.append(("knn_graph", t(i).long())),
                           idx, ordered=True)
        return idx

    def bn(x, params, state, *, training, decay, eps=jlayers.BN_EPS,
           axis_name=None):
        if not training:
            return batch_norm(x, params, state, training=False, decay=decay,
                              eps=eps)
        x32 = x.astype(jnp.float32)
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x32, axis=axes)
        var = jnp.maximum(jnp.mean(jnp.square(x32), axis=axes)
                          - jnp.square(mean), 0.0)
        jax.debug.callback(
            lambda m, v: tape.append(("moments", (t(m), t(v)))), mean, var,
            ordered=True)
        y, _ = batch_norm(x, params, {"mean": mean, "var": var},
                          training=False, decay=None, eps=eps)
        return y, {"mean": state["mean"] * decay + mean * (1.0 - decay),
                   "var": state["var"] * decay + var * (1.0 - decay)}

    monkeypatch.setattr(jnbr, "knn_graph", graph)
    monkeypatch.setattr(jlayers, "_batch_norm", bn)
    return tape


PRESETS = {"shapenet": (jax_cfg, lambda: make_batch(11)),
           "s3dis": (narrow_jax_cfg, lambda: s3dis_batch(12))}


@pytest.mark.parametrize("preset,dtype", [("shapenet", "float32"),
                                          ("shapenet", "bfloat16"),
                                          ("s3dis", "bfloat16")])
def test_unfused_step_matches_jax(monkeypatch, preset, dtype):
    """One Full-style training step (all four losses, gate on) without the
    fused kNN: loss components, logits, every gradient leaf and the new BN
    state against jax.value_and_grad of _loss_fn, at the tolerances the
    module docstring states (bf16: the port replays the JAX step's kNN
    graphs and batch moments)."""
    make_cfg, make = PRESETS[preset]
    cfg = unfused(make_cfg(), dtype)
    f32 = dtype == "float32"
    tape = None if f32 else recording(monkeypatch)
    params, state = jax_weights(cfg, seed=3)
    batch = make()
    grad_fn = jax.jit(jax.value_and_grad(_loss_fn, has_aux=True),
                      static_argnames=("cfg", "style"))
    (_, (want_c, want_s, want_l)), want_g = grad_fn(
        to_jax(params), to_jax(state), to_jax(batch), cfg=cfg, style="Full",
        bn_decay=jnp.float32(0.5), gate=jnp.float32(1.0),
        rng=jax.random.PRNGKey(1))
    jax.effects_barrier()
    want_g = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, want_g), {}).items()}
    want_s = {k: v.numpy() for k, v in params_from_jax(
        {}, jax.tree.map(np.asarray, want_s)).items()}
    model = DGCNNSeg(port_cfg(cfg).model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    with (contextlib.nullcontext() if f32 else replay.replay_plain(tape)):
        total, got_c, logits = loss_fn(model, to_torch(batch),
                                       cfg=port_cfg(cfg), style="Full",
                                       bn_decay=0.5, gate=1.0)
    total.backward()
    if not f32:  # a graph per stage (and the transform net), every BN
        assert [n for n, _ in tape].count("knn_graph") == (
            4 if preset == "shapenet" else 3)
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in got_g.values())
    for k in want_c:
        np.testing.assert_allclose(float(got_c[k].detach()), float(want_c[k]),
                                   rtol=1e-4 if f32 else 1e-3, err_msg=k)
    lmax = np.abs(np32(want_l)).max()
    np.testing.assert_allclose(np32(logits), np32(want_l), rtol=0,
                               atol=(1e-4 if f32 else 2e-2) * lmax)
    assert_grads_close(got_g, want_g, rtol=2e-4 if f32 else 0.1,
                       atol_frac=1e-5 if f32 else 1e-2)
    for name, v in want_s.items():
        np.testing.assert_allclose(
            model.state_dict()[name].numpy(), v, err_msg=name,
            rtol=1e-4 if f32 else 2.0 ** -6, atol=1e-5 if f32 else 2.0 ** -7)


def test_replay_plain_reproduces_and_overrides_a_step():
    """utils/replay.py's plain pair on the CPU: a bf16 unfused step replayed
    from its own tape gives the same loss and gradients bitwise; a tape
    whose graphs point elsewhere changes the step, so the replay is what
    the run used."""
    cfg = port_cfg(unfused(jax_cfg(), "bfloat16"))
    batch = to_torch(make_batch(13))

    def step(ctx):
        torch.manual_seed(0)
        model = DGCNNSeg(cfg.model, seed=2)
        with ctx as tape:
            total, _, _ = loss_fn(model, batch, cfg=cfg, style="Full",
                                  bn_decay=0.5, gate=1.0)
            total.backward()
        return tape, float(total.detach()), [p.grad for p in model.parameters()]

    tape, loss, grads = step(replay.record_plain())
    kinds = [n for n, _ in tape]
    assert kinds.count("knn_graph") == 4 and kinds.count("moments") > 4
    _, again, grads2 = step(replay.replay_plain(tape))
    assert again == loss and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    moved = [(n, v.roll(1, dims=1) if n == "knn_graph" else v) for n, v in tape]
    _, other, _ = step(replay.replay_plain(moved))
    assert other != loss
    with pytest.raises(RuntimeError, match="fewer calls"):
        step(replay.replay_plain(tape + tape[:1]))
