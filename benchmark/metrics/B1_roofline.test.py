"""B1_roofline.test: kernel B1 in the eval forwards of the traced window's
requests, counted as B1_roofline.train counts it (metrics/
B1_roofline.train.py), per chunk of ``batch_size`` clouds of a request."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_b1_train", os.path.join(os.path.dirname(__file__), "B1_roofline.train.py"))
_b1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_b1)


def read(w):
    if w.kind != "test" or not w.requests:
        return None
    seconds, launches = w.trace.kernel_s(_b1.is_b1)
    if not launches:
        return None
    bs = w.mix["batch_size"]
    need = 0.0
    for r in w.requests:
        for s in range(0, r["clouds"], bs):
            need += _b1.step_ms(w.config, min(bs, r["clouds"] - s), r["points"],
                                False)
    return 100.0 * need / (seconds * 1e3)
