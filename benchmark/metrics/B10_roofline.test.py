"""B10_roofline.test: kernel B10 (the Gaussian-affinity matvec of the
room's label propagation) in the traced window, as the least time of its
matvecs over the device time of its kernels, in percent.

The work of a room is counted by the benchmark's own rule, from the
room's points and never from the program's tile plan: the room swept
once on a fixed stream (numpy's generator of seed 0), and the ordered
pairs (i, j) of its block points whose exponent 1e3 |dxyz|^2 + 10
|drgb|^2 is at most 30, where the affinity is at least exp(-30). The
blocks that the room LP pads the room with (2 m beyond it, no affinity
to any room point) are not counted: no request needs their work. A
matvec of K classes over the room's N block points and those P pairs
needs affinity_flops(1, N, 6, K, P) operations (harness/counting.py) at
the f32 peak, or the features, u and W u once through memory. The
matvecs of a request are the launches of ``affinity_prep_kernel`` inside
its span: the first the degree pass (K = 1), the others the CG's (K =
the classes)."""

import numpy as np

from harness.counting import F32, affinity_flops, bound

CUTOFF = 30.0
F = 6
KERNELS = ("affinity_",)


def room_pairs(room, points, device):
    import torch

    from reference import rooms as ref

    blocks, _ = ref.sweep(room, ref.columns(room), points, np.random.default_rng(0))
    room_max = room[:, 0:3].max(axis=0).astype(np.float32)
    xyz = (blocks[:, :, 6:9] * room_max).astype(np.float32)
    rgb = blocks[:, :, 3:6].astype(np.float32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1, 3)).to(device)
    with torch.no_grad():
        return ref.Affinity(put(xyz), put(rgb)).pairs(CUTOFF), xyz.shape[0] * xyz.shape[1]


def matvec_ms(n, k, pairs):
    return bound(affinity_flops(1, n, F, k, pairs), "f32",
                 n * F * F32 + 2 * n * k * F32)[0]


def read(w):
    if w.kind != "test" or not w.requests:
        return None
    kern = [(s, e) for s, e, name in w.trace.kernels
            if any(p in name for p in KERNELS)]
    if not kern:
        return None
    preps = sorted(s for s, e, name in w.trace.kernels
                   if "affinity_prep_kernel" in name)
    classes = w.config["model"]["num_classes"]
    sizes = {}
    need = 0.0
    for r in w.requests:
        if r["room"] not in sizes:
            sizes[r["room"]] = room_pairs(w.rooms[r["room"]], r["points"], w.device)
        pairs, n = sizes[r["room"]]
        s, e = r["span"]
        m = sum(1 for t in preps if s <= t <= e)
        if m:
            need += matvec_ms(n, 1, pairs) + (m - 1) * matvec_ms(n, classes, pairs)
    seconds = sum(e - s for s, e in kern) / 1e9
    return 100.0 * need / (seconds * 1e3)
