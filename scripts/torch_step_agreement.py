"""How far one fused bf16 Plain-style training step on the card lies from
the same step over the plain versions on the CPU, and why.

    python scripts/torch_step_agreement.py          # needs a CUDA device

For full ShapeNet width at 2 and 4 clouds of 2048 points and for
tests/test_torch_cuda.py's narrow model at 2 clouds of 300, over several
seeds of random weights: chip_smoke.py's ``fused_step_vs_cpu`` (the CPU
replaying the card's kNN indices and BN moments), printing the loss and
logits errors, the six worst gradient leaves, and each fused block rerun
on its own at its recorded inputs and cotangent. Then, on the CPU only,
the same step against itself at another thread count (8 against 1; only
the summation order differs): how far one-ulp differences grow through
the batch-moment BNs without any kernel involved. The limits of
chip_smoke.py phase 5 and tests/test_torch_cuda.py follow from these
readings.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from weaksuppointcloudseg_tpu_torch import configs  # noqa: E402
from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce  # noqa: E402
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg  # noqa: E402
from weaksuppointcloudseg_tpu_torch.utils import replay  # noqa: E402


def full_batch(clouds, seed):
    data, label, seg = cs.synthetic_split(clouds, np.random.default_rng(seed))
    gen = torch.Generator().manual_seed(0)
    return {"data": torch.from_numpy(data),
            "cat_onehot": torch.eye(16)[torch.from_numpy(label).long()],
            "seg_onehot": torch.eye(50)[torch.from_numpy(seg).long()],
            "mask": (torch.rand(clouds, cs.TN, generator=gen) < 0.1).float()}


def narrow_batch():
    """tests/test_torch_cuda.py::test_fused_train_step_on_cuda_matches_cpu."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 300, 3), generator=g) * 0.5
    onehot = torch.eye(12)[torch.randint(0, 12, (2, 300), generator=g)]
    mask = (torch.rand((2, 300), generator=g) < 0.3).float()
    return {"data": x, "cat_onehot": torch.eye(4)[[0, 2]],
            "seg_onehot": onehot, "mask": mask}


def show(tag, loss_err, lg_err, errs, null, block_errs=()):
    print(f"{tag}: loss rel err {loss_err:.3e}, logits rel RMS {lg_err:.3e}")
    for name, e in sorted(errs.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {name:36s} {e:.3e}{' (null gradient)' if name in null else ''}")
    print(f"    null-gradient biases, worst {max(errs[n] for n in null):.3e}")
    for name, be in block_errs:
        print(f"    block {name}: " + ", ".join(f"{k} {v:.2e}" for k, v in be.items()))


def cpu_against_itself(model_cfg, sub, seed):
    """The step over the plain versions at 8 threads and at 1, the second
    replaying the first's kNN indices and moments."""
    outs, tape = [], None
    for threads in (8, 1):
        torch.set_num_threads(threads)
        model = DGCNNSeg(model_cfg, seed=seed)
        with (replay.record() if tape is None else replay.replay(tape)) as t:
            logits = model.forward_fused(sub["data"], sub["cat_onehot"],
                                         training=True, bn_decay=0.5)
        tape = tape or t
        loss = masked_softmax_ce(logits, sub["seg_onehot"], sub["mask"])
        loss.backward()
        outs.append((float(loss.detach()), logits.detach(),
                     {n: p.grad for n, p in model.named_parameters()}))
    (l8, lg8, g8), (l1, lg1, g1) = outs
    errs, null = replay.grad_errors(model, g8, g1)
    return (abs(l8 - l1) / abs(l1), float((lg8 - lg1).norm() / lg1.norm()),
            errs, null)


def main() -> int:
    base = configs.shapenet_config().model
    full = dataclasses.replace(base, compute_dtype="bfloat16", knn_fast=True,
                               head_keep_prob=(None, None, None))
    narrow = dataclasses.replace(
        full, num_classes=12, num_categories=4, global_channels=128,
        category_embed_channels=8, head_channels=(32, 32, 16))
    print(f"[{cs.card_line()}]")
    sub2 = full_batch(2, 1)
    for seed in (1, 2, 3):
        show(f"full width, 2 x 2048, seed {seed}", *cs.fused_step_vs_cpu(full, sub2, seed))
    show("full width, 4 x 2048, seed 1",
         *cs.fused_step_vs_cpu(full, full_batch(4, 2), 1))
    for seed in (1, 2):
        show(f"narrow, 2 x 300, seed {seed}",
             *cs.fused_step_vs_cpu(narrow, narrow_batch(), seed))
    show("the CPU against itself (8 threads vs 1), full width, 2 x 2048, seed 1",
         *cpu_against_itself(full, sub2, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
