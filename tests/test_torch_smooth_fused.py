"""The fused smoothness loss of the port against the JAX package on the CPU.

Kernels B6 (the weighted gather ``_wgather_pre_impl`` and its scatter
``scatter_add_weighted_pallas``) and B9 (``_knn_wgather_impl``) run in
interpret mode; the port's plain versions take the same numpy inputs. The
loss and one bf16 Full-style ShapeNet step, which reuses the transform
stage's kNN graph, run against the JAX fused branches with the backend
gates of ``losses/weaksup.py``, ``train/steps.py`` and ``models/dgcnn.py``
patched to claim a TPU and the Pallas kernels in interpret mode (in that
mode the JAX gathers' backward is XLA's scatter-add, in the features' bf16).
Nothing in the JAX package changes.

Tolerances, each with its reason:
- B6's gather: the Pallas kernel splits the f32 weights into bf16 hi + lo
  inside a one-hot matmul; the port sums the exact f32 products. 2^-16 of
  the sum of magnitudes sum_j |w_j| |f_j| (measured <= 4.5e-6).
- B6's scatter (an f32 one-hot matmul against f32 sums in another order):
  1e-6 of the sum of magnitudes (measured 2.0e-7).
- B9: indices bitwise in exact mode (tie-free points, and a block whose
  second half repeats the first, where distance-0 ties go to the lowest
  index), >= 98% agreement in fast mode; w within the change a distance
  error of 1e-5 of the squared-norm scale (exact; fast: the dropped
  idx_bits) makes in exp(-d / gamma) (measured <= 7.6e-5 relative); s
  within that plus 2^-16 of its sum of magnitudes.
- The loss and d loss / d prob: the JAX backward adds the k weighted
  cotangents into the bf16 features one bf16 rounding at a time, the
  port's kernel B6 in f32 and rounds once, as the Pallas kernel does:
  loss rtol 1e-5; the gradient within 2^-5 of its largest entry.
- The whole step: the tolerances of tests/test_torch_fused_step.py.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeTpuJax
from test_torch_fused_blocks import DECAY, assert_grads_close, np32, to_jax
from test_torch_fused_step import fused_jax  # noqa: F401 (a fixture)
from test_torch_fused_step import jax_cfg as plain_jax_cfg
from test_torch_train import jax_weights, port_cfg
from weaksuppointcloudseg_tpu.losses import weaksup as jweaksup
from weaksuppointcloudseg_tpu.ops import edgeconv_pallas as jep
from weaksuppointcloudseg_tpu.ops import scatter_pallas as jsp
from weaksuppointcloudseg_tpu.train import steps as jsteps
from weaksuppointcloudseg_tpu_torch.losses import weaksup
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import knn, scatter, wgather
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

B, N, K = 2, 100, 10


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf16_np(rng, shape, scale=1.0, positive=False):
    """bf16-exact f32 values."""
    x = rng.standard_normal(shape) * scale
    if positive:
        x = np.abs(x)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("cf", [51, 14])
def test_wgather_pre_plain_matches_pallas(cf):
    rng = np.random.default_rng(cf)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    w = rng.random((B, N, K)).astype(np.float32)
    f = bf16_np(rng, (B, N, cf))
    want = np.asarray(jep._wgather_pre_impl(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(f, jnp.bfloat16), 256,
        True))
    ti, tw = t(idx), t(w)
    got = wgather.wgather_pre_ref(ti, tw, t(f).bfloat16()).numpy()
    mags = wgather.wgather_pre_ref(ti, tw, t(np.abs(f)).bfloat16()).numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 2.0 ** -16 * mags)


@pytest.mark.parametrize("cf", [51, 14])
def test_scatter_add_weighted_plain_matches_pallas(cf):
    rng = np.random.default_rng(cf + 1)
    n = N + 3  # more rows than points: untouched rows stay 0
    idx = rng.integers(0, n, (B, N, K)).astype(np.int32)
    w = rng.random((B, N, K)).astype(np.float32)
    ct = rng.standard_normal((B, N, cf)).astype(np.float32)
    want = np.asarray(jsp.scatter_add_weighted_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(ct), n, interpret=True))
    got = scatter.scatter_add_weighted_ref(t(idx), t(w), t(ct), n).numpy()
    mags = scatter.scatter_add_weighted_ref(t(idx), t(w), t(np.abs(ct)), n).numpy()
    assert got.shape == want.shape == (B, n, cf)
    assert np.all(np.abs(got - want) <= 1e-6 * mags)


def s3dis_like_points(rng, ties):
    """xyzrgb-like points in a unit block; with ``ties`` the second half of
    every block repeats the first (S3DIS pads small blocks so)."""
    g = rng.random((B, N, 6)).astype(np.float32)
    if ties:
        g[:, N - N // 2:] = g[:, :N // 2]
    return g


@pytest.mark.parametrize("fast,ties", [(False, False), (False, True),
                                       (True, False), (True, True)])
def test_knn_wgather_plain_matches_pallas(fast, ties):
    gamma = 0.1
    rng = np.random.default_rng(int(fast) * 2 + int(ties))
    g = s3dis_like_points(rng, ties)
    f = bf16_np(rng, (B, N, 14), positive=True)
    want = [np.asarray(a) for a in jep._knn_wgather_impl(
        jnp.asarray(g), jnp.asarray(f, jnp.bfloat16), K, gamma, 256, True, fast)]
    got = [a.numpy() for a in wgather.knn_wgather_ref(
        t(g), t(f).bfloat16(), K, gamma, fast=fast)]
    agree = (got[0] == want[0]).mean()
    if fast:
        assert agree >= 0.98
    else:
        np.testing.assert_array_equal(got[0], want[0])
    if ties and not fast:  # the repeated points: their originals come first
        np.testing.assert_array_equal(got[0][:, N - N // 2:, 0],
                                      np.broadcast_to(np.arange(N // 2),
                                                      (B, N // 2)))
    same = np.all(got[0] == want[0], axis=-1)  # rows with the same neighbours
    scale = float((g.astype(np.float64) ** 2).sum(-1).max())
    tol_d = scale * (2.0 ** (knn.idx_bits(N) - 23) if fast else 1e-5)
    w_tol = tol_d / gamma
    assert np.all(np.abs(got[2] - want[2])[same] <= w_tol * want[2][same])
    # f >= 0, so s is its own sum of magnitudes
    assert np.all(np.abs(got[1] - want[1])[same]
                  <= (w_tol + 2.0 ** -16) * want[1][same])


# ------------------------------------------------------------------ loss

@pytest.fixture
def fused_loss_jax(monkeypatch):
    """The JAX loss on its fused branch: weaksup's backend gate claims a
    TPU, and B6/B9 run in interpret mode."""
    monkeypatch.setattr(jweaksup, "jax", FakeTpuJax())
    pre = jep.weighted_gather_pre
    knn_wg = jep.knn_weighted_gather
    monkeypatch.setattr(jep, "weighted_gather_pre",
                        lambda idx, w, f, row_tile: pre(idx, w, f, row_tile, True))
    monkeypatch.setattr(
        jep, "knn_weighted_gather",
        lambda g, f, k, gamma, row_tile, interpret, fast:
        knn_wg(g, f, k, gamma, row_tile, True, fast))


def smooth_inputs(seed, n_cls, cin):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, N, n_cls)) * 2).astype(np.float32)
    x = rng.random((B, N, cin)).astype(np.float32)
    return logits, x


@pytest.mark.parametrize("case", ["graph", "graph_fast", "knn", "knn_fast"])
def test_fused_smooth_loss_and_grad_match_jax(fused_loss_jax, case):
    """The fused smoothness loss and its gradient with respect to the
    logits, with a reused graph (ShapeNet: xyz, 50 classes, a k'=20 graph
    on the bf16 coordinates, as the transform stage builds it) and with
    its own kNN (S3DIS: xyzrgb channels 0:6 of 9, 13 classes)."""
    fast = case.endswith("fast")
    reuse = case.startswith("graph")
    n_cls, cin = (50, 3) if reuse else (13, 9)
    logits, x = smooth_inputs(len(case), n_cls, cin)
    kw = dict(gamma=0.1, k=K, fast=fast,
              channels=None if reuse else (0, 6))
    graph = None
    if reuse:
        gb = t(x).bfloat16().float()
        idx, sqd = knn.select_ref(knn.distances(gb), 20, fast=fast)
        graph = (idx.numpy(), sqd.numpy())

    def jloss(lg):
        prob = jax.nn.softmax(lg, axis=-1)
        return jweaksup.smooth_knn_laplacian(
            prob, jnp.asarray(x), fused_bf16=True,
            graph=None if graph is None else tuple(map(jnp.asarray, graph)),
            **kw)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = t(logits).requires_grad_()
    got = weaksup.smooth_knn_laplacian_fused(
        torch.softmax(tl, -1), t(x),
        graph=None if graph is None else tuple(map(t, graph)), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    assert np.abs(np32(tl.grad) - want_g).max() <= 2.0 ** -5 * np.abs(want_g).max()


def test_fused_smooth_loss_checks_the_graph_width():
    logits, x = smooth_inputs(0, 5, 3)
    idx, sqd = knn.select_ref(knn.distances(t(x)), 4, fast=False)
    with pytest.raises(ValueError, match="k'=4"):
        weaksup.smooth_knn_laplacian_fused(torch.softmax(t(logits), -1), t(x),
                                           k=K, graph=(idx, sqd))
    with pytest.raises(ValueError, match="smooth_fused_bf16"):
        weaksup.total_weaksup_loss(
            t(logits), torch.zeros((B, N, 5)), torch.ones((B, N)), t(x),
            gate=1.0, smooth_knn=K, smooth_graph=(idx, sqd))


# ---------------------------------------------------- the ShapeNet step

def full_jax_cfg(fast):
    """The narrow bf16 ShapeNet config of tests/test_torch_fused_step.py in
    Full style, its smoothness k within the transform stage's k=6."""
    cfg = plain_jax_cfg(fast)
    return dataclasses.replace(
        cfg, weaksup=dataclasses.replace(cfg.weaksup, smooth_knn=4),
        train=dataclasses.replace(cfg.train, style="Full"))


def full_batch(seed, n_cls, num_cats, cin, b=4, n=64):
    """A Full-style batch of b clouds, b/2 interleaved pairs, each cloud
    drawn on its own (a pair of near-copies would make the Siamese term's
    gradient bf16 rounding noise)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_cls, (b, n))
    out = {"data": (rng.standard_normal((b, n, cin)) * 0.5).astype(np.float32),
           "seg": seg.astype(np.int32),
           "seg_onehot": np.eye(n_cls, dtype=np.float32)[seg],
           "mask": (rng.random((b, n)) < 0.3).astype(np.float32)}
    if num_cats:
        out["cat_onehot"] = np.eye(num_cats, dtype=np.float32)[
            rng.integers(0, num_cats, b)]
    return out


@pytest.fixture
def fused_full_jax(fused_jax, fused_loss_jax, monkeypatch):  # noqa: F811
    """The JAX Full-style step on its fused branches: the model (as
    tests/test_torch_fused_step.py), the loss, and steps.py's graph-reuse
    gate."""
    monkeypatch.setattr(jsteps, "jax", FakeTpuJax())
    return fused_jax


def run_full_step(cfg, batch, want_graph, port_ctx=contextlib.nullcontext):
    """The JAX _loss_fn and its gradient, and the port's forward_fused +
    total_weaksup_loss(smooth_fused_bf16=True) and backward, on the same
    weights and batch (gate on), the port's forward inside ``port_ctx()``.
    Returns both sides' (components, logits, gradients, new BN state) and
    the port model."""
    params, state = jax_weights(cfg)
    grad_fn = jax.jit(jax.value_and_grad(jsteps._loss_fn, has_aux=True),
                      static_argnames=("cfg", "style"))
    (_, (comps, new_state, logits)), grads = grad_fn(
        to_jax(params), to_jax(state), to_jax(batch), cfg=cfg, style="Full",
        bn_decay=jnp.float32(DECAY), gate=jnp.float32(1.0),
        rng=jax.random.PRNGKey(0))
    want = ({k: float(v) for k, v in comps.items()}, np32(logits),
            {k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, grads), {}).items()},
            params_from_jax({}, jax.tree.map(np.asarray, new_state)))

    pcfg = port_cfg(cfg)
    model = DGCNNSeg(pcfg.model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    tb = {k: t(v) for k, v in batch.items()}
    with port_ctx():
        out = model.forward_fused(tb["data"], tb.get("cat_onehot"),
                                  training=True, bn_decay=DECAY,
                                  want_smooth_graph=want_graph)
    lg, graph = out if want_graph else (out, None)
    w = pcfg.weaksup
    total, comps = weaksup.total_weaksup_loss(
        lg, tb["seg_onehot"], tb["mask"], tb["data"], gate=1.0,
        siamese_weight=w.siamese_weight, smooth_gamma=w.smooth_gamma,
        smooth_knn=w.smooth_knn, smooth_channels=w.smooth_channels,
        smooth_fast=pcfg.model.knn_fast, smooth_fused_bf16=True,
        smooth_graph=graph)
    comps["total"] = total
    total.backward()
    got = ({k: float(v.detach()) for k, v in comps.items()}, np32(lg),
           {n: p.grad for n, p in model.named_parameters()},
           model.state_dict())
    return got, want, graph


def assert_step_close(got, want):
    """tests/test_torch_fused_step.py's tolerances for the whole step."""
    (gc, gl, gg, gs), (wc, wl, wg, ws) = got, want
    assert set(gc) == set(wc)
    for k in wc:
        np.testing.assert_allclose(gc[k], wc[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(gl, wl, rtol=0, atol=2e-2 * np.abs(wl).max())
    assert all(g is not None for g in gg.values())
    assert_grads_close(gg, wg, rtol=0.1, atol_frac=1e-2)
    for name, v in ws.items():
        np.testing.assert_allclose(gs[name].numpy(), v.numpy(), rtol=2.0 ** -6,
                                   atol=2.0 ** -7, err_msg=name)


@pytest.mark.parametrize("fast", [False, True])
def test_full_bf16_shapenet_step_matches_jax(fused_full_jax, fast):
    """One bf16 Full-style ShapeNet step, the smoothness loss over the
    transform stage's reused graph (kernel B6, no selection of its own):
    components, logits, gradients and new BN state against _loss_fn on the
    fake-TPU fused branch."""
    cfg = full_jax_cfg(fast)
    got, want, graph = run_full_step(cfg, full_batch(11, 12, 4, 3), True)
    assert fused_full_jax["stage"] == 3
    idx, sqd = graph
    assert idx.shape == sqd.shape == (4, 64, cfg.model.k)
    assert not sqd.requires_grad
    assert bool((sqd[..., 1:] >= sqd[..., :-1]).all())  # nearest first
    assert_step_close(got, want)
