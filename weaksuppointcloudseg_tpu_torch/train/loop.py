"""Trainers for ShapeNet and S3DIS. Counterpart of weaksuppointcloudseg_tpu/
train/loop.py (ShapeNet_DGCNN_trainer.py and S3DIS_DGCNN_trainer.py:
TrainOneEpoch_Full, EvalOneEpoch_Full, Test, SaveCheckPoint,
RestoreCheckPoint): host-side batch assembly in numpy (SampIndex masks,
Siamese pairs, one-hot labels), the train and eval steps on the device,
per-shape IoU (ShapeNet) or the global confusion mIoU (S3DIS) on the host.

The model runs on ``device``, the card by default; a caller that wants the
CPU says so (``device="cpu"``). Not ported yet: the background prefetch
thread, resuming Adam state and data parallelism (ROADMAP).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from weaksuppointcloudseg_tpu_torch.configs import ExperimentConfig
from weaksuppointcloudseg_tpu_torch.data import augment, sampling
from weaksuppointcloudseg_tpu_torch.data import s3dis as s3dis_data
from weaksuppointcloudseg_tpu_torch.data import shapenet as shapenet_data
from weaksuppointcloudseg_tpu_torch.metrics.iou import (
    ConfusionAccumulator,
    category_biased_argmax,
    eval_iou,
)
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.propagate.label_prop import propagate_batch
from weaksuppointcloudseg_tpu_torch.train.state import Adam
from weaksuppointcloudseg_tpu_torch.train.steps import (
    make_eval_logits_fn,
    make_eval_step,
    make_train_step,
)
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_jax_checkpoint,
)
from weaksuppointcloudseg_tpu_torch.utils.profiling import span
from weaksuppointcloudseg_tpu_torch.utils.tools import onehot_encode, resolve_device


class _TrainerBase:
    """Model, optimizer, steps, random streams, the epoch loop and
    checkpoints, shared by the two trainers. A subclass sets ``pts_idx``
    (the labelled points, None: all) and provides ``_assemble``."""

    def __init__(self, cfg: ExperimentConfig, *, seed: int = 0,
                 device="cuda", ckpt_dir: Optional[str] = None):
        self.cfg = cfg
        self.style = cfg.train.style
        self.rampup = cfg.train.rampup
        self.device = resolve_device(device)
        self.model = DGCNNSeg(cfg.model, seed=seed).to(self.device)
        self.opt = Adam(self.model.parameters())
        self.train_step = make_train_step(cfg, self.model, self.opt)
        self.eval_step = make_eval_step(self.model)
        # same stream as the reference trainer's: shuffles, Siamese
        # augmentation and the test views are drawn from it
        self.np_rng = np.random.default_rng(seed)
        # dropout masks (the reference's per-step key stream)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.num_classes = cfg.model.num_classes
        self.epoch = 0

    def _mask(self, b, full_mask: bool) -> Tuple[np.ndarray, np.ndarray]:
        """(mask [B, N], valid [B]): the labelled points of the batch's real
        samples; padded tail rows must not enter the masked-CE
        denominator."""
        n = b.data.shape[1]
        if full_mask or self.pts_idx is None:
            mask = np.ones((b.data.shape[0], n), np.float32)
        else:
            mask = sampling.indices_to_mask(self.pts_idx, b.sample_ids, n)
        valid = np.zeros(b.data.shape[0], np.float32)
        valid[:b.valid] = 1.0
        return mask * valid[:, None], valid

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device; to the card through pinned memory without
        blocking the host (the copy is ordered on the current stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run_train_epoch(self, batches, epoch: int) -> Dict[str, float]:
        """The steps of one epoch over ``batches`` (the gate and the pair
        augmentation on from the rampup epoch); returns the metrics averaged
        over steps, weighted by real samples. The per-step metrics stay on
        the device until the epoch ends and are fetched in one transfer.

        Spans (utils/profiling.py::span): ``train.epoch`` around it all; per
        step ``train.assemble`` (``_assemble``), ``train.upload``
        (``_to_device``: pageable copies, so the host waits there for the
        stream) and ``train.step`` (forward, backward and Adam enqueued);
        ``train.fetch``, the one fetch of the metrics."""
        with span("train.epoch"):
            siamese = self.style == "Full"
            gate = 1.0 if epoch >= self.rampup else 0.0
            augment_pairs = siamese and epoch >= self.rampup
            steps, counts = [], []
            for b in batches:
                with span("train.assemble"):
                    batch = self._assemble(b, siamese=siamese,
                                           augment_pairs=augment_pairs,
                                           full_mask=False)
                with span("train.upload"):
                    batch = self._to_device(batch)
                with span("train.step"):
                    steps.append(self.train_step(batch, gate, self.generator))
                counts.append(b.valid)
            self.epoch = epoch + 1
            if not steps:
                return {}
            dev_keys = [k for k, v in steps[0].items() if torch.is_tensor(v)]
            with span("train.fetch"):
                stacked = torch.stack([torch.stack([m[k] for k in dev_keys])
                                       for m in steps]).cpu().numpy()  # one sync
            w = np.asarray(counts, np.float64)
            out = {k: float(np.sum(stacked[:, i] * w) / w.sum())
                   for i, k in enumerate(dev_keys)}
            for k in steps[0]:
                if k not in out:
                    out[k] = float(np.sum(np.asarray([m[k] for m in steps]) * w)
                                   / w.sum())
            return out

    # -- checkpoints --------------------------------------------------------

    def save_checkpoint(self, metric: float) -> Optional[str]:
        """Format-v2 ``.npz`` of the parameters and BN stats (what the test
        CLI restores); Adam's moments are not written."""
        if self.ckpt is None:
            return None
        return self.ckpt.save(self.model, self.epoch, metric, step=self.opt.step)

    def restore_checkpoint(self, path: str) -> None:
        """Load a format-v2 ``.npz`` written by either package."""
        self.epoch = load_jax_checkpoint(path, self.model)


class ShapeNetTrainer(_TrainerBase):
    """ShapeNet part segmentation: training, validation and test.

    ``dataset`` provides ``meta`` (the category/part maps) and, for
    training and validation, ``batches`` (data/shapenet.py::
    ShapeNetDataset); the test path needs only ``meta``, so a
    ShapeNetTestSet will do. ``pts_idx_list`` [num_train_samples,
    n_labelled] are the labelled points (None: every point labelled).
    """

    def __init__(self, cfg: ExperimentConfig, dataset, pts_idx_list=None,
                 **kw):
        super().__init__(cfg, **kw)
        self.ds = dataset
        self.meta = dataset.meta
        self.pts_idx = pts_idx_list
        self.num_categories = cfg.model.num_categories
        # category -> its part ids, [num_categories, num_classes], for the
        # reference's category-biased train argmax
        self._cat_part_mask = np.zeros(
            (self.num_categories, self.num_classes), np.float32)
        for c in range(min(self.num_categories, len(self.meta.objcats))):
            self._cat_part_mask[c, self.meta.iou_oids(c)] = 1.0

    # -- batches ------------------------------------------------------------

    def _assemble(self, b: shapenet_data.Batch, *, siamese: bool,
                  augment_pairs: bool, full_mask: bool) -> Dict[str, np.ndarray]:
        """Host-side batch (loop.py:185-216), on the reference's draws."""
        mask, valid = self._mask(b, full_mask)
        data = b.data
        if siamese:
            aug = augment.shapenet_augment if augment_pairs else None
            data = augment.make_siamese_batch(data, self.np_rng, aug)
            mask = augment.interleave_duplicate(mask)
            seg = augment.interleave_duplicate(b.seg)
            label = augment.interleave_duplicate(b.label)
            valid = augment.interleave_duplicate(valid)
        else:
            seg, label = b.seg, b.label
        cat_onehot = onehot_encode(label, self.num_categories)
        return {
            "data": data.astype(np.float32),
            "seg": seg.astype(np.int64),
            "seg_onehot": onehot_encode(seg, self.num_classes),
            "mask": mask,
            "cat_onehot": cat_onehot,
            "part_bias": cat_onehot @ self._cat_part_mask,
            "valid": valid,
        }

    # -- epochs -------------------------------------------------------------

    def train_epoch(self, epoch: Optional[int] = None) -> Dict[str, float]:
        """One training epoch over the shuffled train split (drop-last);
        returns the metrics averaged over steps, weighted by real samples."""
        epoch = self.epoch if epoch is None else epoch
        return self._run_train_epoch(
            self.ds.batches("train", self.cfg.train.batch_size, shuffle=True,
                            drop_last=True, rng=self.np_rng), epoch)

    def evaluate(self) -> Tuple[float, float, float, np.ndarray]:
        """Validation pass with population BN stats: (loss, acc,
        perdata_miou, pershape_miou [num_categories]), as
        EvalOneEpoch_Full (:421-507)."""
        losses, loss_w, accs, ious = [], [], [], []
        shape_cnt = np.zeros(self.num_categories)
        pershape = np.zeros(self.num_categories)
        for b in self.ds.batches("val", self.cfg.train.batch_size):
            batch = self._assemble(b, siamese=False, augment_pairs=False,
                                   full_mask=True)
            prob, loss = self.eval_step(self._to_device(batch))
            prob = prob.cpu().numpy()[:b.valid]
            losses.append(float(loss))
            loss_w.append(b.valid)
            for b_i in range(b.valid):
                cat = int(b.label[b_i])
                oids = self.meta.iou_oids(cat)
                pred = category_biased_argmax(prob[b_i], oids)
                iou = eval_iou(pred, b.seg[b_i], oids)
                ious.append(iou)
                accs.append(float(np.mean(pred == b.seg[b_i])))
                pershape[cat] = (pershape[cat] * shape_cnt[cat] + iou) / (shape_cnt[cat] + 1)
                shape_cnt[cat] += 1
        return (
            float(np.average(losses, weights=loss_w)) if losses else 0.0,
            float(np.mean(accs)) if accs else 0.0,
            float(np.mean(ious)) if ious else 0.0,
            pershape,
        )

    def test(self, testset: shapenet_data.ShapeNetTestSet, *,
             use_label_prop: Optional[bool] = None, num_points: int = 3000,
             batch_size: Optional[int] = None) -> Dict[str, float]:
        """Held-out test with fixed-size views + optional LP
        (reference loop.py:262-383).

        Every shape becomes one or more ``num_points``-point views that
        together cover all its points (cover_partition); views run in
        batches of ``batch_size``, the last batch padded with copies of its
        first view (LP's CG norms span the whole batch, so the padding
        matches the reference's); the first estimate of each point wins,
        and IoU/accuracy score every original point.

        One-batch lag (reference loop.py:310-360): batch i's probabilities
        are copied to pinned host memory without blocking, behind an event,
        and scattered back on the host while the card runs batch i+1's
        forward. The drain comes after that forward is launched and before
        its LP, whose CG syncs the host once per iteration. The inputs go
        up without blocking too. The order of the scatter-backs, and so
        every result, is the synchronous loop's.
        """
        if use_label_prop is None:
            use_label_prop = self.style == "Full"
        if batch_size is None:
            batch_size = max(self.cfg.train.batch_size, 1)
        lp = self.cfg.labelprop
        logits_fn = make_eval_logits_fn(self.model)
        per_data_iou, accs = [], []
        shape_cnt = np.zeros(self.num_categories)
        pershape = np.zeros(self.num_categories)
        shapes: Dict[int, dict] = {}  # shape id -> in-flight buffers
        queue = []  # (shape_id, view index array)

        def finish(sid):
            e = shapes.pop(sid)
            seg, cat = e["seg"], e["cat"]
            oids = self.meta.iou_oids(cat)
            pred = category_biased_argmax(e["prob"], oids)
            iou = eval_iou(pred, seg, oids)
            per_data_iou.append(iou)
            accs.append(float(np.mean(pred == seg)))
            pershape[cat] = (pershape[cat] * shape_cnt[cat] + iou) / (shape_cnt[cat] + 1)
            shape_cnt[cat] += 1

        pending = []  # the lagged batch: (views, valid, host prob, event)

        def fetch(prob):
            """(host prob, event its copy completes at): on the card a
            non-blocking copy into pinned memory; on the CPU prob itself."""
            if prob.device.type != "cuda":
                return prob, None
            host = torch.empty(prob.shape, dtype=prob.dtype, pin_memory=True)
            host.copy_(prob, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            return host, ready

        def drain():
            views, valid, prob, ready = pending.pop()
            if ready is not None:
                ready.synchronize()
            scatter_back(views, valid, prob.numpy())

        def scatter_back(views, valid, prob):
            for v_i in range(valid):
                sid, sel = views[v_i]
                e = shapes[sid]
                # first estimate wins: original positions beat duplicate
                # padding, earlier views beat pad repeats
                uniq, first = np.unique(sel, return_index=True)
                fresh = first[~e["written"][uniq]]
                e["prob"][sel[fresh]] = prob[v_i][fresh]
                e["written"][sel[fresh]] = True
                e["left"] -= 1
                if e["left"] == 0:
                    finish(sid)

        def flush(force=False):
            while queue and (len(queue) >= batch_size or force):
                views = queue[:batch_size]
                del queue[:batch_size]
                valid = len(views)
                xs = [shapes[sid]["pts"][sel] for sid, sel in views]
                cats = [shapes[sid]["cat"] for sid, _ in views]
                while len(xs) < batch_size:  # pad the last batch
                    xs.append(xs[0])
                    cats.append(cats[0])
                x = self._upload(np.stack(xs).astype(np.float32))
                cat_onehot = self._upload(onehot_encode(
                    np.asarray(cats), self.num_categories))
                with torch.inference_mode():
                    prob = torch.softmax(logits_fn(x, cat_onehot), dim=-1)
                    if pending:  # overlaps this batch's forward
                        drain()
                    if use_label_prop:
                        prob = propagate_batch(
                            x, prob, alpha=lp.alpha, beta=lp.beta,
                            xyz_bandwidth=lp.xyz_bandwidth,
                            rgb_bandwidth=lp.rgb_bandwidth, ridge=lp.ridge,
                            solver=lp.solver, cg_iters=lp.cg_iters,
                            cg_tol=lp.cg_tol)
                    pending.append((views, valid, *fetch(prob)))

        for i in range(len(testset)):
            pts, seg, cat = testset[i]
            sels = shapenet_data.cover_partition(len(pts), num_points, self.np_rng)
            shapes[i] = {
                "pts": pts, "seg": seg, "cat": cat,
                "prob": np.zeros((len(pts), self.num_classes), np.float32),
                "written": np.zeros(len(pts), bool),
                "left": len(sels),
            }
            queue.extend((i, sel) for sel in sels)
            flush()
        flush(force=True)
        if pending:
            drain()
        seen = shape_cnt > 0
        return {
            "perdata_miou": float(np.mean(per_data_iou)),
            "pershape_miou": float(np.mean(pershape[seen])) if seen.any() else 0.0,
            "accuracy": float(np.mean(accs)),
            "per_category_iou": np.where(seen, pershape, np.nan),
        }


class S3DISTrainer(_TrainerBase):
    """S3DIS semantic segmentation: training, validation and the room-wise
    test (S3DIS_DGCNN_trainer.py). ``dataset`` is a data/s3dis.py::S3DISDataset;
    the blocks of rooms in Area ``test_area`` are the validation split.
    ``pts_idx_list`` holds each block's labelled points (a [blocks, n]
    array, or one index array per block for the one-point-per-class
    scheme; None: every point labelled)."""

    def __init__(self, cfg: ExperimentConfig, dataset: s3dis_data.S3DISDataset,
                 pts_idx_list=None, test_area: int = 5, **kw):
        super().__init__(cfg, **kw)
        self.ds = dataset
        self.pts_idx = pts_idx_list
        self.test_area = test_area
        self.train_idx, self.val_idx = dataset.split_indices(test_area)

    def _assemble(self, b: s3dis_data.Batch, *, siamese: bool,
                  augment_pairs: bool, full_mask: bool) -> Dict[str, np.ndarray]:
        """Host-side batch (loop.py:397-424), on the reference's draws."""
        mask, valid = self._mask(b, full_mask)
        data, seg = b.data, b.seg
        if siamese:
            aug = augment.s3dis_augment if augment_pairs else None
            data = augment.make_siamese_batch(data, self.np_rng, aug)
            mask = augment.interleave_duplicate(mask)
            seg = augment.interleave_duplicate(seg)
            valid = augment.interleave_duplicate(valid)
        return {
            "data": data.astype(np.float32),
            "seg": seg.astype(np.int64),
            "seg_onehot": onehot_encode(seg, self.num_classes),
            "mask": mask,
            "valid": valid,
        }

    def train_epoch(self, epoch: Optional[int] = None) -> Dict[str, float]:
        """One training epoch over the shuffled train blocks (drop-last)."""
        epoch = self.epoch if epoch is None else epoch
        return self._run_train_epoch(
            self.ds.batches(self.train_idx, self.cfg.train.batch_size,
                            shuffle=True, drop_last=True, rng=self.np_rng),
            epoch)

    def evaluate(self) -> Tuple[float, float, float, np.ndarray]:
        """Validation over the held-out area with population BN stats:
        (loss, acc, mIoU, per-class IoU [num_classes]) from one global
        confusion count (S3DIS_DGCNN_trainer.py:412-481)."""
        acc = ConfusionAccumulator(self.num_classes)
        losses, loss_w = [], []
        for b in self.ds.batches(self.val_idx, self.cfg.train.batch_size):
            batch = self._assemble(b, siamese=False, augment_pairs=False,
                                   full_mask=True)
            prob, loss = self.eval_step(self._to_device(batch))
            losses.append(float(loss))
            loss_w.append(b.valid)
            acc.update(prob.argmax(-1).cpu().numpy()[:b.valid],
                       b.seg[:b.valid])
        return (float(np.average(losses, weights=loss_w)) if losses else 0.0,
                acc.accuracy, acc.miou, acc.iou)

    def test(self, rooms: s3dis_data.S3DISTestRooms, *,
             use_label_prop: Optional[bool] = None,
             pred_dir: Optional[str] = None,
             room_lp: bool = False) -> Dict[str, float]:
        """Room-by-room block inference with label propagation and optional
        per-room .mat dumps (S3DIS_DGCNN_trainer.py:499-584); returns the
        confusion mIoU, accuracy and per-class IoU over every block point.

        Each room's blocks run in chunks of ``batch_size``. The per-block
        LP (the reference's) refines each chunk's blocks as one CG, whose
        norms span the chunk, so the chunking is part of the result. With
        ``room_lp``, one matrix-free LP over every block point of the room
        in room coordinates (:meth:`room_label_prop`) replaces it.

        Each room is swept on the trainer's device and its blocks stay
        there: a chunk is a slice of them, and the labels reach the host
        once, for the confusion count.

        Spans (utils/profiling.py::span): ``test.room`` per room, holding
        ``room.read`` and ``room.sweep`` (:meth:`S3DISTestRooms.load_room`),
        a ``room.forward`` per chunk (eval forward, softmax, the per-block
        LP where on, the fetch to the host) and ``lp.room``.
        """
        if use_label_prop is None:
            use_label_prop = self.style == "Full"
        if room_lp and not use_label_prop:
            warnings.warn(
                "room_lp=True has no effect when use_label_prop is False "
                "(label propagation only runs for the Full style): falling "
                "back to plain per-block argmax", stacklevel=2)
        lp = self.cfg.labelprop
        conf = ConfusionAccumulator(self.num_classes)
        bs = max(self.cfg.train.batch_size, 1)
        logits_fn = make_eval_logits_fn(self.model)
        for r in range(len(rooms)):
            with span("test.room"):
                blocks, labels, path, room_max = rooms.load_room(
                    r, rng=self.np_rng, device=self.device)
                room_prob = []
                for start in range(0, len(blocks), bs):
                    with span("room.forward"):
                        # the eval forward is per block: the reference pads
                        # the last chunk to its compiled shape, which
                        # changes no real block
                        chunk = blocks[start:start + bs]
                        with torch.inference_mode():
                            prob = torch.softmax(logits_fn(chunk), dim=-1)
                            if use_label_prop and not room_lp:
                                prob = propagate_batch(
                                    chunk[..., 0:3], prob, chunk[..., 3:6],
                                    alpha=lp.alpha, beta=lp.beta,
                                    xyz_bandwidth=lp.xyz_bandwidth,
                                    rgb_bandwidth=lp.rgb_bandwidth,
                                    ridge=lp.ridge, solver=lp.solver,
                                    cg_iters=lp.cg_iters, cg_tol=lp.cg_tol)
                        room_prob.append(prob.cpu().numpy())
                if not room_prob:
                    continue
                prob = np.concatenate(room_prob)
                if room_lp and use_label_prop:
                    pred = self.room_label_prop(blocks, prob, room_max)
                else:
                    pred = prob.argmax(-1)
                labels = labels.cpu().numpy()
                conf.update(pred, labels)
                if pred_dir is not None:
                    self._dump_room(pred_dir, path, blocks.cpu().numpy(), pred,
                                    labels)
        return {"miou": conf.miou, "accuracy": conf.accuracy,
                "per_class_iou": conf.iou}

    def room_label_prop(self, blocks, prob: np.ndarray,
                        room_max: np.ndarray) -> np.ndarray:
        """One label propagation across all blocks of a room.

        Every block point joins one cloud in room coordinates (channels 6:9
        times ``room_max``) for one matrix-free CG (solver "cg_matfree"),
        so label mass flows across block boundaries. The blocks are padded
        to a multiple of 8 with blocks of uniform probabilities 2 m beyond
        the room on every axis, as the reference pads them: there the
        affinity to any room point underflows to 0, but the pads sit in the
        CG's batch-global vector, so they are kept for parity. They must
        stay near the room (the centred Gram's cancellation,
        propagate/label_prop.py::check_gram_cancellation).

        Args:
          blocks: [K, N, 9] room blocks (room_to_blocks layout), a tensor
            (on any device: the cloud is built where it lies) or an array.
          prob: [K, N, C] per-block softmax probabilities.
          room_max: [3] room extent in metres (load_room's scale).

        Returns:
          [K, N] predictions.
        """
        with span("lp.room"):
            lp = self.cfg.labelprop
            k_blocks, n, c = prob.shape
            k_pad = -(-k_blocks // 8) * 8
            blocks = torch.as_tensor(blocks).to(self.device, torch.float32)
            scale = torch.from_numpy(np.asarray(room_max, np.float32)).to(self.device)
            xyz = blocks[:, :, 6:9] * scale
            rgb = blocks[:, :, 3:6]
            prob = torch.from_numpy(np.asarray(prob, np.float32)).to(self.device)
            if k_pad > k_blocks:
                extra = k_pad - k_blocks
                xyz = torch.cat([xyz, (scale + 2.0).expand(extra, n, 3)])
                rgb = torch.cat([rgb, rgb.new_zeros((extra, n, 3))])
                prob = torch.cat([prob, prob.new_full((extra, n, c), 1.0 / c)])
            put = lambda t: t.reshape(1, -1, t.shape[-1])  # noqa: E731
            # the dense [N_room, N_room] affinity would not fit: only the
            # matrix-free and point-sharded solvers reach room scale
            solver = "sharded" if lp.solver == "sharded" else "cg_matfree"
            with torch.inference_mode():
                y = propagate_batch(
                    put(xyz), put(prob), put(rgb), alpha=lp.alpha, beta=lp.beta,
                    xyz_bandwidth=lp.xyz_bandwidth, rgb_bandwidth=lp.rgb_bandwidth,
                    ridge=lp.ridge, solver=solver, cg_iters=lp.cg_iters,
                    cg_tol=lp.cg_tol)
            pred = y[0].cpu().numpy().argmax(-1).reshape(k_pad, n)
            return pred[:k_blocks]

    @staticmethod
    def _dump_room(pred_dir: str, room_path: str, data, pred, gt) -> None:
        """Per-room {data, pred, gt} .mat file (S3DIS_DGCNN_trainer.py:
        573-580), named after the room file."""
        import scipy.io

        os.makedirs(pred_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(room_path))[0]
        scipy.io.savemat(os.path.join(pred_dir, f"{name}_pred_gt.mat"),
                         {"data": data, "pred": pred, "gt": gt})
