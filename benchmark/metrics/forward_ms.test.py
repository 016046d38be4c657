"""forward_ms.test: host milliseconds a room spends in its eval forward
chunks (the program's ``room.forward`` spans summed per room: upload,
forward, softmax and the fetch of the probabilities), mean over the
rooms served in the traced window."""

from harness import spans


def read(w):
    rooms = spans.per_room(w, "room.forward") if w.kind == "test" else []
    if not rooms or not all(rooms):
        return None
    return 1e3 * sum(spans.seconds(r) for r in rooms) / len(rooms)
