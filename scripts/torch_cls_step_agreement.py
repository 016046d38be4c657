"""How far one fused bf16 training step of the DGCNN classifier on the
card lies from the same step over the plain versions on the CPU.

    python scripts/torch_cls_step_agreement.py      # needs a CUDA device

At the published width (``ClsConfig()``, ``knn_fast``, dropout off) on
chip_smoke.py's synthetic clouds of 1024 points, at 4, 8, 16 and 32
clouds, some sizes twice (the card's sums run in a fixed order, so a
size read twice reads the same): chip_smoke.py's ``cls_step_vs_cpu`` (the CPU replaying the
card's kNN indices, kernel moments and batch moments), printing the loss
and logits errors, each fused block's worst error rerun on its own, the
four worst gradient leaves, their median and the null-gradient biases.
The limits of chip_smoke.py phase 12 follow from these readings.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from weaksuppointcloudseg_tpu_torch import configs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_cls_step_agreement: CUDA is not available")
    print(cs.card_line())
    cs.phase_build()
    labels = torch.arange(cs.CB, device="cuda") % cs.C_CLASSES
    xs = torch.from_numpy(cs.class_clouds(labels.cpu().numpy(), cs.CN, 0)).cuda()
    cfg = dataclasses.replace(configs.ClsConfig(), knn_fast=True, keep_prob=1.0)
    for b in (4, 4, 4, 8, 8, 16, 32, 32):
        t0 = time.perf_counter()
        loss, logits, errs, null, blocks = cs.cls_step_vs_cpu(
            cfg, xs[:b].bfloat16(), labels[:b], seed=1)
        leaf = sorted((e, n) for n, e in errs.items() if n not in null)
        block = max((e, f"{name}.{k}") for name, be in blocks
                    for k, e in be.items())
        print(f"{b} clouds ({time.perf_counter() - t0:.1f} s): loss rel err "
              f"{loss:.2e}, logits rel RMS {logits:.2e}, worst block "
              f"{block[1]} {block[0]:.2e}, worst leaves " + ", ".join(
                  f"{n} {e:.2e}" for e, n in leaf[-4:][::-1])
              + f", median {leaf[len(leaf) // 2][0]:.2e}, null-gradient "
              f"biases {max(e for n, e in errs.items() if n in null):.2e}",
              flush=True)


if __name__ == "__main__":
    main()
