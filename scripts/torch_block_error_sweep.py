"""The distribution of chip_smoke.py phase 5's per-block error over weight
seeds, and where the worst reading comes from.

    python scripts/torch_block_error_sweep.py [--seeds 16]   # needs a CUDA device

Phase 5 runs one fused bf16 Plain-style step of the full-width ShapeNet
model (2 clouds of 2048 points from its training split, dropout off) on
the card and over the plain versions on the CPU, the CPU replaying the
card's kNN indices and BN moments, then reruns each fused block on its own
on both devices at its recorded inputs and output cotangent; it requires
every block's output and input gradients within 1e-2 (the relative norm
of the difference, ``utils/replay.py::block_errors``). Here the same step
and blocks run for weight seeds 1..seeds. The script prints each seed's
worst block, the distribution of the worst readings, and for every
reading above 3e-3 the element that differs most (its index, both
values, their difference in bf16 ulps of the CPU value) and the share of
the squared error norm in the ten largest differences: a few elements
holding the whole error point to a bf16 rounding that flipped at a relu
or k-max boundary, a spread error to a kernel fault.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from weaksuppointcloudseg_tpu_torch import configs  # noqa: E402
from weaksuppointcloudseg_tpu_torch.data import sampling  # noqa: E402
from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce  # noqa: E402
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg  # noqa: E402
from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer  # noqa: E402
from weaksuppointcloudseg_tpu_torch.utils import replay  # noqa: E402


def phase5_inputs():
    """Phase 5's model configuration (dropout off) and its 2-cloud batch."""
    rng = np.random.default_rng(1)
    splits = {"train": cs.synthetic_split(3 * cs.PB, rng),
              "val": cs.synthetic_split(24, rng)}
    base = configs.shapenet_config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, compute_dtype="bfloat16",
                                        knn_fast=True),
        train=dataclasses.replace(base.train, batch_size=cs.PB, style="Plain"))
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.in_memory_dataset(tmp, splits)
        trainer = ShapeNetTrainer(cfg, ds, sampling.generate_sample_index(
            3 * cs.PB, cs.PN, 0.1), seed=0, device="cuda")
        b = next(ds.batches("train", cs.PB))
        batch = trainer._to_device(trainer._assemble(
            b, siamese=False, augment_pairs=False, full_mask=False))
    small = dataclasses.replace(cfg.model, head_keep_prob=(None, None, None))
    return small, {k: v[:2] for k, v in batch.items()}


def card_blocks(model_cfg, sub, seed):
    """The recorded fused blocks of one card step (phase 5's
    fused_step_vs_cpu, card side)."""
    model = DGCNNSeg(model_cfg, seed=seed).cuda()
    with replay.record(), replay.record_blocks() as blocks:
        logits = model.forward_fused(sub["data"], sub["cat_onehot"],
                                     training=True, bn_decay=0.5)
    masked_softmax_ce(logits, sub["seg_onehot"], sub["mask"]).backward()
    return blocks


def worst_element(entry, name):
    """The element of ``name`` (the output or an input's gradient) where
    the block's card and CPU runs differ most."""
    with replay.record() as tape:
        got = replay._run_block(entry, "cuda", contextlib.nullcontext())
    want = replay._run_block(entry, "cpu", replay.replay(tape))
    names = list(inspect.signature(entry["block"].forward).parameters)[1:]
    if name == "out":
        a, b = got[0], want[0]
    else:
        i = names.index(name)
        a, b = got[1][i], want[1][i]
    diff = (a.double() - b.double()).abs()
    flat = int(diff.argmax())
    where = np.unravel_index(flat, tuple(diff.shape))
    sq = diff.flatten() ** 2
    top10 = float(torch.topk(sq, min(10, sq.numel())).values.sum()
                  / (sq.sum() + 1e-300))
    av, bv = float(a.flatten()[flat]), float(b.flatten()[flat])
    ulp = 2.0 ** (np.floor(np.log2(abs(bv) + 1e-30)) - 7)
    return where, av, bv, abs(av - bv) / ulp, top10


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=16)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_block_error_sweep: needs a CUDA device")
    card = cs.card_line()
    model_cfg, sub = phase5_inputs()
    worst = []
    for seed in range(1, args.seeds + 1):
        blocks = card_blocks(model_cfg, sub, seed)
        readings = [(e, f"{entry['block'].__name__.strip('_')}.{k}", entry, k)
                    for entry in blocks
                    for k, e in replay.block_errors(entry).items()]
        readings.sort(key=lambda r: -r[0])
        e, label, entry, name = readings[0]
        worst.append(e)
        print(f"seed {seed:2d}: block_worst {e:.4e} at {label}; next "
              + ", ".join(f"{r[1]} {r[0]:.2e}" for r in readings[1:3]))
        for e, label, entry, name in readings:
            if e <= 3e-3:
                break
            where, av, bv, ulps, top10 = worst_element(entry, name)
            print(f"    {label} {e:.4e}: largest difference at {where}: card "
                  f"{av:.6e}, CPU {bv:.6e} ({ulps:.1f} bf16 ulps of the CPU "
                  f"value); the ten largest differences hold {100 * top10:.1f}% "
                  f"of the squared error")
        torch.cuda.empty_cache()
    w = np.array(worst)
    print(f"block_worst over {len(w)} seeds [{card}]: min {w.min():.3e}, "
          f"median {np.median(w):.3e}, 90th percentile "
          f"{np.percentile(w, 90):.3e}, max {w.max():.3e}; above 3e-3: "
          f"{int((w > 3e-3).sum())}, above 1e-2: {int((w > 1e-2).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
