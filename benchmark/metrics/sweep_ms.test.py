"""sweep_ms.test: host milliseconds a room spends in its block sweep
(the program's ``room.sweep`` span, ``room_to_blocks``), mean over the
rooms served in the traced window."""

from harness import spans


def read(w):
    rooms = spans.per_room(w, "room.sweep") if w.kind == "test" else []
    if not rooms or not all(rooms):
        return None
    return 1e3 * sum(spans.seconds(r) for r in rooms) / len(rooms)
