"""Replay one run's kNN indices and BN moments in another run.

A bf16 training step of the fused blocks on the card and the same step
over the plain versions on the CPU sum in other orders. The BN moments'
last bits differ, later features round differently, and the kNN of a later
stage picks other near-tied neighbours, which moves the gradients by
discrete amounts. To compare the two steps leaf by leaf, record the card
step's kNN indices and in-kernel moments and make the CPU step use them;
what differs then is each kernel's own summation order::

    with replay.record() as tape:
        ...  # the step on the card
    with replay.replay(tape):
        ...  # the same step on the CPU

Both runs must make the same calls of the fused blocks in the same order.

Through a whole step, one-ulp differences still pass through the
batch-moment BNs of the later layers and grow; :func:`record_blocks` and
:func:`block_errors` compare each fused block on its own instead, at the
inputs and output cotangent it had in a recorded step.

The plain composition (``forward_plain``: the unfused routes) has its own
pair, :func:`record_plain` and :func:`replay_plain`: they record and
replay the plain kNN graphs (``neighbors.knn_graph``) and the batch
moments of every batch-norm layer (``layers.batch_moments``). In bf16 the
distances have exact ties, which the two devices may order differently.
"""

from __future__ import annotations

import contextlib
import inspect

import torch

from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.ops import edgeconv, knn, neighbors

# the kernels of the fused training blocks that emit BN moments, with the
# position of the moments in their outputs (knn_edge_pre: a static-graph
# stage, whose indices come from a replayed knn_edge)
_MOMENTS_AT = {"knn_edge": 2, "knn_edge_pre": 1, "conv_minmax": 4,
               "conv_nmax": 4}


@contextlib.contextmanager
def _patched(wrap):
    saved = {name: getattr(layers, name) for name in _MOMENTS_AT}
    try:
        for name, fn in saved.items():
            setattr(layers, name, wrap(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(layers, name, fn)


@contextlib.contextmanager
def record():
    """Yield a list that collects (kernel, kNN indices or None, moments),
    on the CPU, for every call of the fused blocks' kernels."""
    tape = []

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            idx = out[0].cpu() if name == "knn_edge" else None
            tape.append((name, idx, out[_MOMENTS_AT[name]].cpu()))
            return out
        return recorded

    with _patched(wrap):
        yield tape


@contextlib.contextmanager
def replay(tape):
    """Run the fused blocks with the recorded indices and moments: kNN
    returns the recorded neighbours (y1, its extrema and, when asked, the
    squared distances computed at them by the plain formulas) and every
    kernel's moments are the recorded ones."""
    calls = iter(tape)

    def wrap(name, fn):
        def replayed(*args, **kwargs):
            recorded, idx, mom = next(calls)
            if recorded != name:
                raise RuntimeError(f"replay: {name} called where {recorded} ran")
            if idx is None:
                out = list(fn(*args, **kwargs))
            else:
                g, v, u, _ = args
                idx = idx.to(v.device)
                out = list(edgeconv.edge_outputs_ref(
                    idx, v, u, with_minmax=kwargs.get("with_minmax", False)))
                if kwargs.get("with_values"):
                    out.append(_distances_at(g, idx, kwargs["fast"]))
            out[_MOMENTS_AT[name]] = mom.to(out[_MOMENTS_AT[name]].device)
            return tuple(out)
        return replayed

    with _patched(wrap):
        yield
    if next(calls, None) is not None:
        raise RuntimeError("replay: the run made fewer calls than were recorded")


@contextlib.contextmanager
def _patched_plain(knn_graph, batch_moments):
    saved = neighbors.knn_graph, layers.batch_moments
    neighbors.knn_graph, layers.batch_moments = knn_graph, batch_moments
    try:
        yield
    finally:
        neighbors.knn_graph, layers.batch_moments = saved


@contextlib.contextmanager
def record_plain():
    """Yield a list that collects, on the CPU, ("knn_graph", indices) for
    every plain kNN graph and ("moments", (mean, var)) for every
    batch-moment BN of the plain composition."""
    tape = []
    knn_graph, batch_moments = neighbors.knn_graph, layers.batch_moments

    def graph(x, k):
        idx = knn_graph(x, k)
        tape.append(("knn_graph", idx.cpu()))
        return idx

    def moments(y32):
        out = batch_moments(y32)
        tape.append(("moments", tuple(t.detach().cpu() for t in out)))
        return out

    with _patched_plain(graph, moments):
        yield tape


@contextlib.contextmanager
def replay_plain(tape):
    """Run the plain composition with the recorded kNN graphs and batch
    moments. A replayed moment takes the recorded value and keeps the
    gradient of the one computed here (``m + (recorded - m).detach()``)."""
    calls = iter(tape)
    batch_moments = layers.batch_moments

    def expect(name):
        recorded, value = next(calls)
        if recorded != name:
            raise RuntimeError(f"replay: {name} called where {recorded} ran")
        return value

    def graph(x, k):
        return expect("knn_graph").to(x.device)

    def moments(y32):
        got = batch_moments(y32)
        want = expect("moments")
        return tuple(m + (w.to(m.device) - m).detach()
                     for m, w in zip(got, want))

    with _patched_plain(graph, moments):
        yield
    if next(calls, None) is not None:
        raise RuntimeError("replay: the run made fewer calls than were recorded")


def _distances_at(g, idx, fast: bool):
    """The squared distances B1 returns with its graph, at the given
    indices: in fast mode clamped at 0 with the packed index bits dropped
    (ops/knn.py::select_ref)."""
    d = torch.gather(knn.distances(g), 2, idx.long())
    if fast:
        keep = ~((1 << knn.idx_bits(g.shape[1])) - 1)
        d = (torch.clamp_min(d, 0.0).view(torch.int32) & keep).view(torch.float32)
    return d


def grad_errors(model, got, want):
    """Per gradient leaf, the norm of got - want over the norm of want;
    for the biases of convs in front of a batch norm, whose true gradient
    is zero and whose computed one is rounding noise, over the largest
    leaf norm instead. Returns ({name: error}, the names of those biases)."""
    null = {f"{name}.b" for name, m in model.named_modules()
            if isinstance(m, layers.Conv) and m.bn}
    top = max(float(w.double().norm()) for w in want.values())
    errs = {}
    for name, w in want.items():
        diff = float((got[name].double() - w.double()).norm())
        errs[name] = diff / (top if name in null else float(w.double().norm()) + 1e-30)
    return errs, null


# the fused training blocks, and their inputs whose true gradient is zero
# (conv biases in front of a batch norm)
_BLOCKS = ("_EdgeConvStageTrain", "_EdgeConvStage1Train", "_ConvBnNmaxTrain",
           "_EdgeConvBnReluTrain")
_NULL_INPUTS = ("b1", "b2", "b")


@contextlib.contextmanager
def record_blocks():
    """Yield a list that collects every fused training block the run
    calls: {"block": its autograd.Function, "args": its inputs, detached
    copies, "needs": which of them need a gradient, "dout": the cotangent
    of its output once the backward has run}."""
    calls = []

    def wrap(block):
        apply = block.apply

        def recorded(*args):
            entry = {"block": block, "dout": None,
                     "args": [a.detach().clone() if torch.is_tensor(a) else a
                              for a in args],
                     "needs": [torch.is_tensor(a) and a.requires_grad
                               for a in args]}
            outs = apply(*args)
            if outs[0].requires_grad:
                outs[0].register_hook(
                    lambda g: entry.__setitem__("dout", g.detach().clone()))
            calls.append(entry)
            return outs
        return recorded

    blocks = [getattr(layers, name) for name in _BLOCKS]
    try:
        for block in blocks:
            block.apply = wrap(block)
        yield calls
    finally:
        for block in blocks:
            del block.apply  # the inherited Function.apply again


def _run_block(entry, device, ctx):
    args = [a.detach().to(device, copy=True).requires_grad_(need)
            if torch.is_tensor(a) else a
            for a, need in zip(entry["args"], entry["needs"])]
    with ctx:
        out = entry["block"].apply(*args)[0]
    out.backward(entry["dout"].to(device))
    return out.detach().cpu(), [a.grad.cpu() if need and a.grad is not None
                                else None
                                for a, need in zip(args, entry["needs"])]


def block_errors(entry, device="cuda"):
    """One recorded block's forward and backward on ``device`` and over
    the plain versions on the CPU (replaying the device's kNN indices and
    moments), at the recorded inputs and cotangent. Returns {name: error}
    with name "out" or an input's name: the norm of the difference over
    the CPU value's norm; for the conv biases in front of a BN (true
    gradient zero) over the largest gradient norm of the block instead."""
    with record() as tape:
        got = _run_block(entry, device, contextlib.nullcontext())
    want = _run_block(entry, "cpu", replay(tape))
    names = list(inspect.signature(entry["block"].forward).parameters)[1:]

    def rel(a, b, scale=None):
        diff = float((a.double() - b.double()).norm())
        return diff / ((float(b.double().norm()) if scale is None else scale)
                       + 1e-30)

    grads = [(n, g, w) for n, g, w in zip(names, got[1], want[1])
             if w is not None]
    top = max(float(w.double().norm()) for _, _, w in grads)
    errs = {"out": rel(got[0], want[0])}
    for name, g, w in grads:
        errs[name] = rel(g, w, top if name in _NULL_INPUTS else None)
    return errs
