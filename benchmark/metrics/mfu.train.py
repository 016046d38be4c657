"""mfu.train: the model operations of the training steps completed in the
traced window (harness/counting.py::model_flops, forward and backward,
Siamese twins included) over the window times the H100's dense bf16 peak,
in percent."""

from harness.counting import PEAK_FLOPS, model_flops


def read(w):
    if w.kind != "train" or w.steps == 0:
        return None
    flops = w.steps * w.clouds_per_step * model_flops(w.config, w.points, True)
    return 100.0 * flops / (w.trace.window_s * PEAK_FLOPS["bf16"])
