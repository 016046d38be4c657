"""cg_steps.test: CG steps of a room's label propagation (the program's
``lp.cg_step`` spans, one per matvec, inside each ``lp.room``), mean over
the rooms served in the traced window."""

from harness import spans


def read(w):
    if w.kind != "test":
        return None
    lps = spans.in_rooms(w, "lp.room")
    if not lps:
        return None
    steps = spans.named(w.trace, "lp.cg_step")
    return sum(len(spans.inside(steps, s)) for s in lps) / len(lps)
