"""Static-graph mode (``ModelConfig.static_graph``, ``--StaticGraph``) of
the port against the JAX package on the CPU.

- Kernel B11 (``ops/edgeconv.py::knn_edge_pre``, its plain version here)
  against ``_knn_edge_pre_impl`` in interpret mode, and its VJP
  ``knn_edge_gather_pre`` against the JAX ``custom_vjp``.
- The fused stages with ``reuse_idx`` against the JAX stages (interpret
  mode) and against the port's own selecting stages fed the same graph,
  in training and at eval; the eval graph producer.
- Whole models: the plain route against the JAX CPU path, exactly one
  graph built per forward, static differing from dynamic, and a bf16
  Full-style step of the fused route against the JAX fused branch.
- The four CLIs with ``--StaticGraph --device cpu``.

Tolerances. B11's y1 and extrema are one f32 add and one bf16 rounding:
bitwise. Its moments are f32 sums in another order: within 1e-5 of the
sums of magnitudes. The VJP: ``du`` sums the same bf16 dy_eff in f32 in
another order, then rounds to bf16: within one bf16 ulp. The JAX ``dv``
on the CPU scatter-adds bf16 values into a bf16 buffer, rounding after
each add; the port sums in f32 (B13) and rounds once, as the TPU path
does: the two differ by at most (m + 1) half-ulps of the scattered
magnitudes, m the largest number of contributions to one row. The
stages and steps carry the tolerances of tests/test_torch_fused_blocks.py,
tests/test_torch_smooth_fused.py and tests/test_torch_train.py, which
state their reasons; against the port's own selecting stage a reusing
stage runs the same arithmetic on the same values: bitwise.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_blocks import (
    DECAY,
    EPS,
    assert_grads_close,
    assert_out_close,
    assert_state_close,
    bf16_exact,
    conv_values,
    jax_param_grads,
    np32,
    param_grads,
    port_conv,
    to_jax,
)
from test_torch_s3dis import narrow_jax_cfg, s3dis_batch
from test_torch_smooth_fused import (  # noqa: F401 (fixtures)
    assert_step_close,
    full_batch,
    full_jax_cfg,
    fused_full_jax,
    fused_jax,
    fused_loss_jax,
    run_full_step,
)
from test_torch_train import jax_cfg, jax_weights, make_batch, port_cfg, to_torch
from weaksuppointcloudseg_tpu import configs as jc
from weaksuppointcloudseg_tpu.data import s3dis as js3dis
from weaksuppointcloudseg_tpu.data import shapenet as jshapenet
from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu.ops import edgeconv_pallas as jep
from weaksuppointcloudseg_tpu.train.steps import _loss_fn
from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.cli import test_s3dis, test_shapenet
from weaksuppointcloudseg_tpu_torch.cli import train_s3dis, train_shapenet
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import edgeconv, knn, neighbors
from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

B, N, K = 2, 64, 6


def graph(rng, b=B, n=N, k=K, n_valid=None):
    """A kNN graph (int32 [b, n, k], the point itself first) of random
    points; with n_valid only the first n_valid points are neighbours."""
    g = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    d = knn.distances(g)
    idx, _ = knn.select_ref(d, k, fast=False, n_valid=n_valid)
    return idx


def b11_inputs(seed, c=16, n_valid=None):
    rng = np.random.default_rng(seed)
    idx = graph(rng, n_valid=n_valid)
    v = bf16_exact(rng, (B, N, c))
    u = bf16_exact(rng, (B, N, c))
    return idx, v, u


def assert_b11_close(got, want, rows):
    """y1 and the extrema bitwise, moments within 1e-5 of the sums of
    magnitudes, over the first ``rows`` rows (``want``: the Pallas
    kernel's outputs on those rows)."""
    got = [np32(t) for t in got]
    want = [np.asarray(jnp.asarray(w, jnp.float32)) for w in want]
    y = want[0].astype(np.float64)
    mags = np.stack([np.abs(y).sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
    assert np.all(np.abs(got[1] - want[1]) <= 1e-5 * mags + 1e-7)
    for i in (0, 2, 3, 4, 5)[:len(want) - 1]:
        assert np.array_equal(got[i][:, :rows], want[i]), i


# ---------------------------------------------------------------- B11

@pytest.mark.parametrize("minmax", [False, True])
def test_b11_plain_matches_pallas(minmax):
    """knn_edge_pre on the CPU against _knn_edge_pre_impl(interpret=True)
    on the same graph: y1 and extrema bitwise, moments 1e-5."""
    idx, v, u = b11_inputs(0)
    vt, ut = (torch.from_numpy(a).bfloat16() for a in (v, u))
    got = edgeconv.knn_edge_pre(idx, vt, ut, K, with_minmax=minmax)
    want = jep._knn_edge_pre_impl(
        jnp.asarray(idx.numpy()), jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(u, jnp.bfloat16), K, 32, True, with_minmax=minmax)
    assert len(got) == len(want) == (6 if minmax else 2)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert_b11_close(got, want, N)


def test_b11_n_valid_matches_pallas():
    """With n_valid < N (a producer's graph at eval: every index < n_valid)
    rows < n_valid match the Pallas kernel run on those rows, rows past it
    hold zeros (extrema 0 at slot 0) and stay out of the moments."""
    nv = 40
    idx, v, u = b11_inputs(1, n_valid=nv)
    assert int(idx.max()) < nv
    vt, ut = (torch.from_numpy(a).bfloat16() for a in (v, u))
    got = edgeconv.knn_edge_pre(idx, vt, ut, K, with_minmax=True, n_valid=nv)
    want = jep._knn_edge_pre_impl(
        jnp.asarray(idx.numpy()[:, :nv]), jnp.asarray(v[:, :nv], jnp.bfloat16),
        jnp.asarray(u[:, :nv], jnp.bfloat16), K, 32, True, with_minmax=True)
    assert_b11_close(got, want, nv)
    for t in got[:1] + got[2:]:
        assert not bool(t[:, nv:].any())


def test_b11_equals_b1_at_b1s_indices():
    """Fed B1's own indices, B11 returns B1's y1 and extrema (the plain
    versions here; tests/test_torch_cuda.py holds the kernels)."""
    idx, v, u = b11_inputs(2)
    rng = np.random.default_rng(3)
    g = torch.from_numpy(bf16_exact(rng, (B, N, 3))).bfloat16()
    vt, ut = (torch.from_numpy(a).bfloat16() for a in (v, u))
    for fast in (False, True):
        b1 = edgeconv.knn_edge(g, vt, ut, K, fast=fast, with_minmax=True,
                               n_valid=50)
        pre = edgeconv.knn_edge_pre(b1[0], vt, ut, K, with_minmax=True,
                                    n_valid=50)
        for a, b_ in zip(pre, b1[1:]):
            assert torch.equal(a, b_)


def test_knn_edge_gather_pre_matches_jax():
    """B11's VJP against the JAX custom_vjp under a random cotangent of
    (y1, mom), with the tolerances the module docstring derives."""
    idx, v, u = b11_inputs(4)
    rng = np.random.default_rng(5)
    dy = bf16_exact(rng, (B, N, K, v.shape[-1]))
    dmom = (rng.standard_normal((2, v.shape[-1])) * 0.1).astype(np.float32)
    ij = jnp.asarray(idx.numpy())
    (yj, mj), vjp = jax.vjp(
        lambda a, c: jep.knn_edge_gather_pre(ij, a, c, K, 32, True),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16))
    dvj, duj = vjp((jnp.asarray(dy, jnp.bfloat16), jnp.asarray(dmom)))
    vt = torch.from_numpy(v).bfloat16().requires_grad_()
    ut = torch.from_numpy(u).bfloat16().requires_grad_()
    y, mom = edgeconv.knn_edge_gather_pre(idx, vt, ut, K)
    torch.autograd.backward((y, mom), (torch.from_numpy(dy).bfloat16(),
                                       torch.from_numpy(dmom)))
    assert vt.grad.dtype == ut.grad.dtype == torch.bfloat16
    assert np.array_equal(np32(y), np32(yj))
    y64 = np32(yj).astype(np.float64)
    mags = np.stack([np.abs(y64).sum((0, 1, 2)), (y64 * y64).sum((0, 1, 2))])
    assert np.all(np.abs(np32(mom) - np32(mj)) <= 1e-5 * mags)
    dy_eff = np32(torch.from_numpy(
        dy + dmom[0] + 2.0 * np32(y) * dmom[1]).bfloat16()).astype(np.float64)
    du_want = np32(duj)
    assert np.all(np.abs(np32(ut.grad) - du_want) <=
                  2.0 ** -7 * np.abs(du_want) + 1e-5 * np.abs(dy_eff).sum(2))
    flat = (idx.numpy() + np.arange(B)[:, None, None] * N).reshape(-1)
    mags = np.zeros((B * N, v.shape[-1]))
    np.add.at(mags, flat, np.abs(dy_eff).reshape(-1, v.shape[-1]))
    m = np.bincount(flat, minlength=B * N).max()
    err = np.abs(np32(vt.grad) - np32(dvj)).reshape(B * N, -1)
    assert np.all(err <= (m + 1) * 2.0 ** -9 * mags + 1e-6)


# --------------------------------------------------------------- stages

def stage_setup(seed, cin, c1, c2=None):
    rng = np.random.default_rng(seed)
    p1, s1 = conv_values(rng, 2 * cin, c1)
    p2, s2 = conv_values(rng, c1, c2) if c2 else (None, None)
    f = bf16_exact(rng, (B, N, cin))
    ct = bf16_exact(rng, (B, N, c2 or c1))
    return rng, p1, s1, p2, s2, f, ct, graph(rng)


@pytest.mark.parametrize("training", [True, False])
def test_two_conv_stage_reuse_matches_jax(training):
    """apply_edge_conv_stage_fused(reuse_idx=...) against the JAX stage on
    the same graph: the output, the new BN state and the gradients of w,
    b, gamma, beta of both convs and of f (training), the output (eval)."""
    _, p1, s1, p2, s2, f, ct, idx = stage_setup(0, 16, 16, 24)
    fj = jnp.asarray(f, jnp.bfloat16)
    ij = jnp.asarray(idx.numpy())
    conv1, conv2 = port_conv(p1, s1), port_conv(p2, s2)
    ft = torch.tensor(f).bfloat16().requires_grad_(training)
    kw = dict(eps=EPS, training=training, decay=DECAY)
    got = layers.apply_edge_conv_stage_fused(conv1, conv2, ft, None, K,
                                             reuse_idx=idx, **kw)

    def block(q1, q2, x):
        out, n1, n2 = jlayers.apply_edge_conv_stage_fused(
            q1, to_jax(s1), q2, to_jax(s2), x, None, K, training=training,
            bn_decay=jnp.float32(DECAY), eps=EPS, interpret=True,
            reuse_idx=ij)
        return out, (n1, n2)

    if not training:
        assert_out_close(got, block(to_jax(p1), to_jax(p2), fj)[0])
        return
    want, vjp, new = jax.vjp(block, to_jax(p1), to_jax(p2), fj, has_aux=True)
    g1, g2, gf = vjp(jnp.asarray(ct, jnp.bfloat16))
    got.backward(torch.tensor(ct).bfloat16())
    assert_out_close(got, want)
    assert_state_close((conv1, conv2), new)
    grads = {**param_grads("c1", conv1), **param_grads("c2", conv2),
             "f": ft.grad}
    assert_grads_close(grads, {**jax_param_grads("c1", g1),
                               **jax_param_grads("c2", g2), "f": gf})


@pytest.mark.parametrize("training", [True, False])
def test_single_conv_stage_reuse_matches_jax(training):
    """apply_edge_conv_stage1_fused(reuse_idx=...) (B11 with its extrema)
    against the JAX stage: output, BN state, gradients."""
    _, p1, s1, _, _, f, ct, idx = stage_setup(1, 16, 24)
    fj = jnp.asarray(f, jnp.bfloat16)
    ij = jnp.asarray(idx.numpy())
    conv = port_conv(p1, s1)
    ft = torch.tensor(f).bfloat16().requires_grad_(training)
    got = layers.apply_edge_conv_stage1_fused(
        conv, ft, None, K, eps=EPS, training=training, decay=DECAY,
        reuse_idx=idx)

    def block(q, x):
        out, ns = jlayers.apply_edge_conv_stage1_fused(
            q, to_jax(s1), x, None, K, training=training,
            bn_decay=jnp.float32(DECAY), eps=EPS, interpret=True,
            reuse_idx=ij)
        return out, ns

    if not training:
        assert_out_close(got, block(to_jax(p1), fj)[0])
        return
    want, vjp, new = jax.vjp(block, to_jax(p1), fj, has_aux=True)
    g, gf = vjp(jnp.asarray(ct, jnp.bfloat16))
    got.backward(torch.tensor(ct).bfloat16())
    assert_out_close(got, want)
    assert_state_close((conv,), (new,))
    assert_grads_close({**param_grads("c", conv), "f": ft.grad},
                       {**jax_param_grads("c", g), "f": gf})


def _run_stage(two_conv, values, f, g, training, **kw):
    """One stage on fresh convs: (output, BN buffers, gradients of every
    parameter and of f, and the graph if one was asked for)."""
    convs = [port_conv(p, s) for p, s in values]
    ft = torch.tensor(f).bfloat16().requires_grad_(training)
    gt = torch.tensor(g).bfloat16()
    common = dict(eps=EPS, training=training, decay=DECAY, fast=True)
    if two_conv:
        out = layers.apply_edge_conv_stage_fused(convs[0], convs[1], ft, gt, K,
                                                 **common, **kw)
    else:
        out = layers.apply_edge_conv_stage1_fused(convs[0], ft, gt, K,
                                                  **common, **kw)
    out, graph_ = out if kw.get("want_graph") else (out, None)
    grads = {}
    if training:
        out.backward(torch.ones_like(out))
        grads = {f"{i}.{n}": p.grad for i, c in enumerate(convs)
                 for n, p in c.named_parameters()}
        grads["f"] = ft.grad
    bufs = [t.clone() for c in convs for t in (c.mean, c.var)]
    return out.detach(), bufs, grads, graph_


@pytest.mark.parametrize("two_conv,training,n_valid", [
    (True, True, None), (True, False, None), (True, False, 40),
    (False, True, None), (False, False, 40)])
def test_reuse_stage_equals_selecting_stage(two_conv, training, n_valid):
    """Fed the graph the selecting stage chose, a reusing stage gives the
    selecting stage's output, BN buffers and gradients bit for bit, in
    training and at eval (with n_valid: rows past it zero in both). The
    two-conv stage emits that graph at eval too, every index < n_valid."""
    rng = np.random.default_rng(7)
    values = [conv_values(rng, 32, 16)]
    if two_conv:
        values.append(conv_values(rng, 16, 24))
    f = bf16_exact(rng, (B, N, 16))
    g = bf16_exact(rng, (B, N, 3))
    nkw = {} if n_valid is None else {"n_valid": n_valid}
    if two_conv:
        sel = _run_stage(True, values, f, g, training, want_graph=True, **nkw)
        idx, sqd = sel[3]
        assert idx.dtype == torch.int32 and sqd.dtype == torch.float32
        assert not sqd.requires_grad
        plain = _run_stage(True, values, f, g, training, **nkw)
        assert torch.equal(plain[0], sel[0])
    else:
        sel = _run_stage(False, values, f, g, training, **nkw)
        idx, _ = knn.select_ref(knn.distances(torch.tensor(g).bfloat16()), K,
                                fast=True, n_valid=n_valid)
    assert int(idx.min()) >= 0 and int(idx.max()) < (n_valid or N)
    pre = _run_stage(two_conv, values, f, g, training, reuse_idx=idx, **nkw)
    assert torch.equal(pre[0], sel[0])
    for a, b_ in zip(pre[1], sel[1]):
        assert torch.equal(a, b_)
    assert pre[2].keys() == sel[2].keys()
    for name in sel[2]:
        assert torch.equal(pre[2][name], sel[2][name]), name


def test_reuse_stage_refuses_to_emit_a_graph():
    rng = np.random.default_rng(8)
    (p1, s1), (p2, s2) = conv_values(rng, 32, 16), conv_values(rng, 16, 16)
    f = torch.tensor(bf16_exact(rng, (B, N, 16))).bfloat16()
    with pytest.raises(ValueError, match="no graph"):
        layers.apply_edge_conv_stage_fused(
            port_conv(p1, s1), port_conv(p2, s2), f, None, K,
            want_graph=True, reuse_idx=graph(rng))


# ---------------------------------------------------------------- models

def static(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, static_graph=True))


def shapenet_f32():
    return static(jax_cfg())


def s3dis_f32():
    return static(narrow_jax_cfg())


PRESETS = {"shapenet": (shapenet_f32, lambda: make_batch(7)),
           "s3dis": (s3dis_f32, lambda: s3dis_batch(8))}

_jax_grad = jax.jit(jax.value_and_grad(_loss_fn, has_aux=True),
                    static_argnames=("cfg", "style"))


@pytest.mark.parametrize("preset", ["shapenet", "s3dis"])
def test_static_plain_step_matches_jax(preset):
    """One f32 Full-style static-graph step of the plain composition (the
    CPU route; B12 and B13 on the card) against jax.value_and_grad of
    _loss_fn on the JAX CPU path: loss components, logits, every gradient
    leaf and the new BN state, at tests/test_torch_train.py's tolerances
    (identity input transform, as there)."""
    make_cfg, make = PRESETS[preset]
    cfg = make_cfg()
    params, state = jax_weights(cfg)
    batch = make()
    (_, (want_c, want_s, want_l)), want_g = _jax_grad(
        to_jax(params), to_jax(state), to_jax(batch), cfg=cfg, style="Full",
        bn_decay=jnp.float32(0.5), gate=jnp.float32(1.0),
        rng=jax.random.PRNGKey(1))
    want_g = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, want_g), {}).items()}
    want_s = {k: v.numpy() for k, v in params_from_jax(
        {}, jax.tree.map(np.asarray, want_s)).items()}
    model = DGCNNSeg(port_cfg(cfg).model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    total, got_c, logits = loss_fn(model, to_torch(batch), cfg=port_cfg(cfg),
                                   style="Full", bn_decay=0.5, gate=1.0)
    total.backward()
    for k in want_c:
        np.testing.assert_allclose(float(got_c[k].detach()), float(want_c[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(np32(logits), np32(want_l), rtol=1e-4,
                               atol=1e-5 * np.abs(np32(want_l)).max())
    scale = max(np.abs(v).max() for v in want_g.values())
    for name, p in model.named_parameters():
        w = want_g[name]
        err = np.abs(np32(p.grad) - w).max()
        assert err <= 2e-4 * np.abs(w).max() + 1e-5 * scale, (name, err)
    for name, v in want_s.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), v,
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("preset", ["shapenet", "s3dis"])
def test_static_gradients_reach_every_parameter(preset):
    """With the input transform active (a non-zero transform_out), a
    static-graph training step gives every parameter a non-zero gradient
    (transform_out itself may legally be 0 at its zero init), and the
    eval forward is finite."""
    make_cfg, make = PRESETS[preset]
    cfg = make_cfg()
    params, state = jax_weights(cfg, transform=preset == "shapenet")
    model = DGCNNSeg(port_cfg(cfg).model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    tb = to_torch(make())
    if "cat_onehot" in tb:  # four categories: the category BN sees a spread
        tb["cat_onehot"] = torch.eye(4)[[0, 1, 2, 3]]
    logits = model(tb["data"], tb.get("cat_onehot"), training=True,
                   bn_decay=0.9)
    (logits.square().sum() * 1e-4).backward()
    for name, p in model.named_parameters():
        if "transform_out" not in name:
            assert float(p.grad.abs().sum()) > 0.0, name
    with torch.no_grad():
        assert bool(torch.isfinite(model(tb["data"], tb.get("cat_onehot"))).all())


@pytest.mark.parametrize("preset", ["shapenet", "s3dis"])
def test_one_graph_on_the_input_coordinates(preset, monkeypatch):
    """On the plain route the ONLY kNN is one on the input's kNN channels
    (raw xyz on ShapeNet, channels 6:9 on S3DIS), and every stage (and the
    transform net) gathers along exactly that graph; the static model's
    logits differ from the dynamic model's on the same weights."""
    make_cfg, make = PRESETS[preset]
    cfg = port_cfg(make_cfg()).model
    model = DGCNNSeg(cfg, seed=3).eval()
    tb = to_torch(make())
    graphs, gathers = [], []
    real_fused, real_graph = neighbors.knn_graph_fused, neighbors.knn_graph
    real_gather = neighbors.gather_neighbors

    def spy_fused(g, k, fast=False):
        idx = real_fused(g, k, fast=fast)
        graphs.append((g.clone(), idx))
        return idx

    def spy_graph(g, k):
        idx = real_graph(g, k)
        graphs.append((g.clone(), idx))
        return idx

    def spy_gather(f, idx):
        gathers.append(idx)
        return real_gather(f, idx)

    monkeypatch.setattr(neighbors, "knn_graph_fused", spy_fused)
    monkeypatch.setattr(neighbors, "knn_graph", spy_graph)
    monkeypatch.setattr(neighbors, "gather_neighbors", spy_gather)
    with torch.no_grad():
        got = model(tb["data"], tb.get("cat_onehot"))
    assert len(graphs) == 1, f"{len(graphs)} graphs built"
    g_src, idx = graphs[0]
    lo, hi = cfg.knn_channels or (0, cfg.in_channels)
    assert torch.equal(g_src, tb["data"][..., lo:hi])
    assert 0 <= int(idx.min()) and int(idx.max()) < tb["data"].shape[1]
    assert len(gathers) == len(cfg.edge_channels) + cfg.use_transform_net
    for gi in gathers:
        assert torch.equal(gi, idx)
    monkeypatch.undo()
    dynamic = DGCNNSeg(dataclasses.replace(cfg, static_graph=False), seed=3)
    with torch.no_grad():
        want = dynamic.eval()(tb["data"], tb.get("cat_onehot"))
    assert float((got - want).abs().max()) > 1e-6


@pytest.mark.parametrize("preset,b11_calls", [("shapenet", 3), ("s3dis", 2)])
def test_fused_route_builds_one_graph(preset, b11_calls, monkeypatch):
    """The fused route (on the CPU over the plain versions): per forward,
    in training and at eval, B1 once (the transform stage on ShapeNet,
    stage 0 on S3DIS) and B11 in every other EdgeConv stage, along B1's
    graph; B12 never."""
    cfg = (full_jax_cfg(True) if preset == "shapenet"
           else narrow_jax_cfg("bfloat16", True))
    cfg = port_cfg(static(cfg)).model
    model = DGCNNSeg(cfg, seed=1)
    tb = to_torch(full_batch(3, cfg.num_classes, cfg.num_categories,
                             cfg.in_channels))
    calls = []
    for name in ("knn_edge", "knn_edge_pre"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append((_n, a[0])) or _r(*a, **kw))
    monkeypatch.setattr(neighbors, "knn_graph_fused", None)
    for training in (True, False):
        calls.clear()
        out = model.forward_fused(tb["data"], tb.get("cat_onehot"),
                                  training=training, bn_decay=DECAY)
        assert bool(torch.isfinite(out).all())
        names = [n for n, _ in calls]
        assert names == ["knn_edge"] + ["knn_edge_pre"] * b11_calls
    lo, hi = cfg.knn_channels or (0, cfg.in_channels)
    assert torch.equal(calls[0][1].float(),
                       tb["data"][..., lo:hi].bfloat16().float())


def replayed_full_step(cfg, batch, want_graph, monkeypatch):
    """tests/test_torch_smooth_fused.py::run_full_step with the JAX step
    run op by op, its fused kernels' BN moments (and B1's indices)
    recorded in the form of the port's ``utils/replay.py`` tape, and the
    port's step replaying them."""
    from weaksuppointcloudseg_tpu.ops import conv_kmax_pallas as jck
    from weaksuppointcloudseg_tpu_torch.utils import replay

    tape = []
    for mod, name, port_name, at in (
            (jep, "_knn_edge_impl", "knn_edge", 2),
            (jep, "_knn_edge_pre_impl", "knn_edge_pre", 1),
            (jck, "conv_minmax_pallas", "conv_minmax", 4),
            (jck, "conv_nmax_pallas", "conv_nmax", 4)):
        def recorded(*a, _fn=getattr(mod, name), _name=port_name, _at=at,
                     **kw):
            out = _fn(*a, **kw)
            idx = torch.tensor(np.asarray(out[0])) if _at == 2 else None
            tape.append((_name, idx, torch.tensor(np.asarray(out[_at]))))
            return out
        monkeypatch.setattr(mod, name, recorded)
    with jax.disable_jit():
        got, want, graph_ = run_full_step(cfg, batch, want_graph,
                                          port_ctx=lambda: replay.replay(tape))
    return got, want, graph_, tape


@pytest.mark.parametrize("preset,fast", [("shapenet", False), ("shapenet", True),
                                         ("s3dis", False), ("s3dis", True)])
def test_static_fused_step_matches_jax(fused_full_jax, monkeypatch, preset,
                                       fast):
    """One bf16 Full-style static-graph step through forward_fused (B1 once,
    B11 in the reusing stages; the ShapeNet smoothness loss over the same
    transform graph, S3DIS's over B9) against _loss_fn on the JAX fused
    branch, exact and fast selection, at the whole-step tolerances of
    tests/test_torch_fused_step.py. The JAX side runs one graph-producing
    stage. The port replays the JAX step's kNN indices and BN moments
    (utils/replay.py): the two packages sum the moments in other orders,
    and on the ShapeNet batch one f32 ulp of a moment flips one bf16
    rounding of a stage's output and moves this narrow step's Siamese term
    by ~1%, far past the arithmetic under test."""
    producers = []
    stage = jlayers.apply_edge_conv_stage_fused

    def counted(*a, **kw):
        producers.append(kw.get("reuse_idx") is None)
        return stage(*a, **kw)

    monkeypatch.setattr(jlayers, "apply_edge_conv_stage_fused", counted)
    if preset == "shapenet":
        cfg = static(full_jax_cfg(fast))
        batch = full_batch(11, 12, 4, 3)
    else:
        cfg = static(narrow_jax_cfg("bfloat16", fast))
        batch = s3dis_batch(9)
    got, want, graph_, tape = replayed_full_step(
        cfg, batch, preset == "shapenet", monkeypatch)
    assert sum(producers) == 1 and len(producers) == (
        3 if preset == "shapenet" else 2)
    assert [n for n, _, _ in tape if n.startswith("knn")] == (
        ["knn_edge"] + ["knn_edge_pre"] * (3 if preset == "shapenet" else 2))
    assert_step_close(got, want)
    if graph_ is not None:
        assert int(graph_[0].max()) < batch["data"].shape[1]


# ------------------------------------------------------------------- CLIs

SN_CATS, SN_POINTS = 4, 64


def test_shapenet_clis_static_graph_on_cpu(tmp_path, monkeypatch, capsys):
    """cli.train_shapenet --StaticGraph --device cpu trains one epoch and
    checkpoints; cli.test_shapenet --StaticGraph restores it into a static
    model (no parameters of its own) and tests it."""
    data = str(tmp_path / "shapenet")
    jshapenet.write_synthetic(data, num_categories=SN_CATS, parts_per_category=3,
                              train_samples=4, val_samples=2, test_samples=2,
                              num_points=SN_POINTS, seed=0)
    monkeypatch.chdir(tmp_path)
    out = train_shapenet.main([
        "--DataPath", data, "-m", "0.1", "-sty", "Full", "-bs", "2",
        "--Epoch", "1", "--Rampup", "0", "--ExpRslt", "1", "--StaticGraph",
        "--device", "cpu"])
    assert "Epoch 0 Train loss" in capsys.readouterr().out
    for key in ("seg", "siamese", "smooth", "total"):
        assert np.isfinite(out["train"][key]), key
    (run,) = glob.glob(str(tmp_path / "Results/ShapeNet/DGCNN_sty-Full_m-0.1_*"))
    best = os.path.join(run, "Checkpoint", "Checkpoint_epoch-best.npz")
    built = []
    real = DGCNNSeg.__init__

    def spy(self, cfg, **kw):
        built.append(cfg.static_graph)
        real(self, cfg, **kw)

    monkeypatch.setattr(DGCNNSeg, "__init__", spy)
    res = test_shapenet.main(["--DataPath", data, "--Checkpoint", best,
                              "--batchsize", "2", "--num_points", "40",
                              "--StaticGraph", "--device", "cpu"])
    assert built == [True]
    assert np.isfinite(res["perdata_miou"]) and 0 <= res["accuracy"] <= 1


def test_s3dis_clis_static_graph_on_cpu(tmp_path, monkeypatch, capsys):
    """cli.train_s3dis --StaticGraph --device cpu (bf16, the CPU's plain
    composition) trains one epoch and checkpoints; cli.test_s3dis
    --StaticGraph tests the checkpoint on the raw Area 5 rooms."""
    data = str(tmp_path / "s3dis")
    js3dis.write_synthetic(data, num_rooms_per_area=2, areas=(1, 5),
                           blocks_per_room=2, num_points=SN_POINTS, seed=1)
    preset = configs.s3dis_config

    def small():
        cfg = preset()
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_points=SN_POINTS))

    monkeypatch.setattr(configs, "s3dis_config", small)
    monkeypatch.chdir(tmp_path)
    out = train_s3dis.main([
        "--DataPath", data, "-m", "0", "-sty", "Full", "-bs", "2",
        "--Epoch", "1", "--Rampup", "0", "--Precision", "bfloat16",
        "--FastKNN", "-ta", "5", "--ExpRslt", "1", "--StaticGraph",
        "--device", "cpu"])
    assert "Epoch 0 Train loss" in capsys.readouterr().out
    for key in ("seg", "siamese", "inexact", "smooth", "total"):
        assert np.isfinite(out["train"][key]), key
    (run,) = glob.glob(str(tmp_path / "Results/S3DIS/DGCNN_sty-Full_m-0.0_*"))
    best = os.path.join(run, "Checkpoint", "Checkpoint_epoch-best.npz")
    res = test_s3dis.main(["--DataPath", data, "--Checkpoint", best,
                           "-sty", "Full", "--batchsize", "2", "--Precision",
                           "bfloat16", "--FastKNN", "--StaticGraph",
                           "--device", "cpu"])
    assert capsys.readouterr().out.startswith("Test Area 5  mIoU ")
    assert np.isfinite(res["miou"]) and 0 <= res["accuracy"] <= 1


def test_static_graph_flag_reaches_the_config():
    """--StaticGraph sets ModelConfig.static_graph on all four CLIs, as the
    reference's build_config does; without it the model stays dynamic."""
    from weaksuppointcloudseg_tpu.cli import common as jax_common
    from weaksuppointcloudseg_tpu_torch.cli import common

    for dataset, train in (("ShapeNet", True), ("ShapeNet", False),
                           ("S3DIS", True), ("S3DIS", False)):
        p = common.base_parser(dataset, train=train)
        for argv, want in (([], False), (["--StaticGraph"], True)):
            cfg = common.build_config(p.parse_args(argv), dataset)
            assert cfg.model.static_graph is want
            jargs = jax_common.base_parser(dataset, train=train).parse_args(argv)
            assert jax_common.build_config(jargs, dataset).model.static_graph is want
    assert jc.ModelConfig().static_graph is configs.ModelConfig().static_graph
