"""lp_ms.test: host milliseconds of a room's label propagation (the
program's ``lp.room`` span), mean over the rooms served in the traced
window."""

from harness import spans


def read(w):
    if w.kind != "test":
        return None
    lps = spans.in_rooms(w, "lp.room")
    if not lps:
        return None
    return 1e3 * spans.seconds(lps) / len(lps)
