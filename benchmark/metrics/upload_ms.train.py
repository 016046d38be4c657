"""upload_ms.train: host milliseconds per training step in the batch's
upload (the program's ``train.upload`` spans) over the ``train.step``
spans of the traced window. The copies are pageable and synchronise the
stream, so this holds the wait for the previous step too."""

from harness import spans


def read(w):
    if w.kind != "train":
        return None
    steps = len(spans.named(w.trace, "train.step"))
    if not steps:
        return None
    return 1e3 * spans.seconds(spans.named(w.trace, "train.upload")) / steps
