"""host_assemble_ms.train: host milliseconds per training step spent
assembling the batch (the program's ``train.assemble`` spans: twins,
augmentation, masks, one-hots, part bias) over the ``train.step`` spans
of the traced window."""

from harness import spans


def read(w):
    if w.kind != "train":
        return None
    steps = len(spans.named(w.trace, "train.step"))
    if not steps:
        return None
    return 1e3 * spans.seconds(spans.named(w.trace, "train.assemble")) / steps
