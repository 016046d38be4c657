"""Seeded synthetic-data convergence runs of the port. Counterpart of
weaksuppointcloudseg_tpu/utils/synth_convergence.py: the same learnable
sets from the same numpy seeds, trained through the port's steps and
trainer.

- ShapeNet-style part segmentation: per-category Gaussian clusters with
  z-split part labels, driven through ``make_train_step`` /
  ``make_eval_step`` (no filesystem).
- S3DIS-style block segmentation: the blocks of the JAX package's
  ``data/s3dis.py::write_synthetic`` (height-correlated labels), built in
  memory with numpy (``data/s3dis.py::synthetic_blocks``: the GPU machine
  has no h5py), driven through ``S3DISTrainer``.

The two packages draw init, dropout and label masks from different random
streams, so a run is held to the reference's calibrated bars (mIoU > 0.5,
bf16 + ``knn_fast`` within 0.11 of f32; S3DIS mIoU > 0.35, accuracy >
0.5: tests/test_tpu_kernels.py), not to equality with a JAX run. The bars
were calibrated at 1024 points, batch 8, 24 epochs; ``n_points`` and
``bs`` below those are for CPU smoke runs only.

The runs take the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.data import s3dis
from weaksuppointcloudseg_tpu_torch.metrics.iou import eval_iou
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer
from weaksuppointcloudseg_tpu_torch.train.state import Adam
from weaksuppointcloudseg_tpu_torch.train.steps import make_eval_step, make_train_step
from weaksuppointcloudseg_tpu_torch.utils.tools import onehot_encode, resolve_device


def learnable_shapenet(rng, n_samples, n_points, n_cat=4, parts_per=3,
                       centers=None):
    """In-memory learnable part-seg set: (xs [S, n, 3] f32, segs [S, n]
    i32, cats [S] i32, centers). ``centers`` continues a draw around the
    first draw's category centres (a fresh call places them anew)."""
    xs, segs, cats = [], [], []
    if centers is None:
        centers = rng.standard_normal((n_cat, 3)) * 2.0
    for _ in range(n_samples):
        c = int(rng.integers(0, n_cat))
        pts = centers[c] + rng.standard_normal((n_points, 3)) * 0.5
        z = pts[:, 2]
        q = np.quantile(z, np.linspace(0, 1, parts_per + 1)[1:-1])
        part = np.searchsorted(q, z)
        xs.append(pts.astype(np.float32))
        segs.append((c * parts_per + part).astype(np.int32))
        cats.append(c)
    return np.stack(xs), np.stack(segs), np.asarray(cats, np.int32), centers


def shapenet_train_and_eval_miou(compute_dtype, knn_fast, *, seed=0,
                                 epochs=24, static_graph=False,
                                 data_seed=None, eval_tail=1,
                                 n_points=1024, bs=8, device="cuda"):
    """Seeded ShapeNet-style training run -> the final val per-shape mIoU.

    ``seed`` drives init, batch order, label masks and dropout;
    ``data_seed`` (default: ``seed``'s stream) the dataset draw: 64 shapes,
    48 for training, 16 for validation, extended by 80 more around the
    same centres (drawn after training, or before it with ``eval_tail >
    1``, which then averages the val mIoU over the last ``eval_tail``
    epochs and needs ``data_seed``, so that the training stream stays
    untouched)."""
    n_cat, parts_per = 4, 3
    n_cls = n_cat * parts_per
    cfg = configs.shapenet_config()
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, num_points=n_points, num_classes=n_cls,
            num_categories=n_cat, compute_dtype=compute_dtype,
            knn_fast=knn_fast, static_graph=static_graph),
        train=dataclasses.replace(cfg.train, batch_size=bs, style="Full"))
    rng = np.random.default_rng(seed)
    data_rng = rng if data_seed is None else np.random.default_rng(data_seed)
    xs_all, segs_all, cats_all, centers = learnable_shapenet(
        data_rng, 64, n_points, n_cat, parts_per)
    xs, segs, cats = xs_all[:48], segs_all[:48], cats_all[:48]
    vx, vseg, vcat = xs_all[48:], segs_all[48:], cats_all[48:]
    if eval_tail > 1 and data_seed is None:
        raise ValueError("eval_tail > 1 requires data_seed (decoupled "
                         "draw): the val extension must be drawn before "
                         "training starts")

    def extend_val():
        exs, esegs, ecats, _ = learnable_shapenet(
            data_rng, 80, n_points, n_cat, parts_per, centers=centers)
        return (np.concatenate([vx, exs]), np.concatenate([vseg, esegs]),
                np.concatenate([vcat, ecats]))

    if eval_tail > 1:
        vx, vseg, vcat = extend_val()

    dev = resolve_device(device)
    model = DGCNNSeg(cfg.model, seed=seed).to(dev)
    step = make_train_step(cfg, model, Adam(model.parameters()))
    eval_step = make_eval_step(model)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed + 1)

    def put(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}

    def eval_miou():
        ious = []
        for lo in range(0, len(vx), bs):
            vb = put({
                "data": vx[lo:lo + bs],
                "seg_onehot": onehot_encode(vseg[lo:lo + bs], n_cls),
                "mask": np.ones(vseg[lo:lo + bs].shape, np.float32),
                "cat_onehot": onehot_encode(vcat[lo:lo + bs], n_cat),
            })
            prob, _ = eval_step(vb)
            pred = prob.argmax(-1).cpu().numpy()
            for i in range(pred.shape[0]):
                oids = list(range(vcat[lo + i] * parts_per,
                                  (vcat[lo + i] + 1) * parts_per))
                ious.append(eval_iou(pred[i], vseg[lo + i], oids))
        return float(np.mean(ious))

    tail_mious = []
    for ep in range(epochs):
        order = rng.permutation(len(xs))
        for lo in range(0, len(xs) - bs + 1, bs):
            # Siamese duplication (each sample twice, interleaved)
            dup = np.repeat(order[lo:lo + bs], 2)
            seg = segs[dup]
            metrics = step(put({
                "data": xs[dup],
                "seg": seg.astype(np.int64),
                "seg_onehot": onehot_encode(seg, n_cls),
                "mask": (rng.uniform(size=seg.shape) < 0.2).astype(np.float32),
                "cat_onehot": onehot_encode(cats[dup], n_cat),
                "valid": np.ones((2 * bs,), np.float32),
            }), 1.0, generator)
        if eval_tail > 1 and ep >= epochs - eval_tail:
            tail_mious.append(eval_miou())
    float(metrics["total"])  # the last step has finished
    if eval_tail > 1:
        return float(np.mean(tail_mious))
    vx, vseg, vcat = extend_val()
    return eval_miou()


def s3dis_train_and_eval_miou(compute_dtype, knn_fast, *, seed=0, epochs=24,
                              static_graph=False, n_points=1024, bs=8,
                              device="cuda"):
    """Seeded S3DIS-style trainer run -> (val mIoU, val accuracy): the
    13-fold recipe scaled down (6 rooms per area, Area 1 for training,
    Area 5 for validation, 1024-point blocks, batch 8, rampup 2), the
    trainer's masks, dihedral augmentation and x10 Siamese included."""
    data, label, rooms = s3dis.synthetic_blocks(
        num_rooms_per_area=6, blocks_per_room=8, num_points=n_points,
        areas=(1, 5), seed=0)
    cfg = configs.s3dis_config()
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, num_points=n_points, compute_dtype=compute_dtype,
            knn_fast=knn_fast, static_graph=static_graph),
        train=dataclasses.replace(cfg.train, batch_size=bs, style="Full",
                                  rampup=2),
        weaksup=dataclasses.replace(cfg.weaksup, rampup=2))
    trainer = S3DISTrainer(cfg, s3dis.S3DISDataset.from_arrays(data, label, rooms),
                           None, test_area=5, seed=seed, device=device)
    for ep in range(epochs):
        trainer.train_epoch(ep)
    _, acc, miou, _ = trainer.evaluate()
    return float(miou), float(acc)
