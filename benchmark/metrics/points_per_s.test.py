"""points_per_s.test: the points labelled (every block point of each room)
by the requests completed in the traced window, over the window (host
clock). The window's rate: the host's sweep of each room sets most of it,
so it follows the host's speed from run to run."""


def read(w):
    if w.kind != "test" or not w.requests:
        return None
    return sum(r["clouds"] * r["points"] for r in w.requests) / w.trace.window_s
