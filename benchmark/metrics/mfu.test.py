"""mfu.test: the model operations of the eval forward of every request
completed in the traced window (every block or view the forward ran) over
the window times the H100's dense bf16 peak, in percent."""

from harness.counting import PEAK_FLOPS, model_flops


def read(w):
    if w.kind != "test" or not w.requests:
        return None
    flops = sum(r["clouds"] * model_flops(w.config, r["points"], False)
                for r in w.requests)
    return 100.0 * flops / (w.trace.window_s * PEAK_FLOPS["bf16"])
