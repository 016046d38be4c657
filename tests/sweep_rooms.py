"""Raw rooms that stress the S3DIS block sweep, and the comparison of
``load_room`` on a torch device with a reference sweep; no JAX (the
card's tests, which run without it, share them with the CPU tests).

``sweep_room(case, rng)`` gives (room [n, 7], num_point, min_points) of one
of ``SWEEP_CASES``: points on the inclusive block bounds (an edge in 2
blocks, a corner in 4, walls at an integer and a fractional far extent,
points off the grid) and the block counts around ``num_point`` and
``min_points``. ``write_area`` lays rooms out as an S3DIS test area;
``sweep_on`` sweeps them through ``load_room(device=...)`` and through a
reference: the JAX package's ``room_to_blocks`` in the CPU tests, and
``plain_sweep`` (the port's sweep on the CPU, over ops/room_sweep.py's
plain versions) in the card's.
"""

import copy
import os

import numpy as np
import torch

from weaksuppointcloudseg_tpu_torch.data import s3dis


def as_room(xyz, rng):
    rgb = rng.uniform(0, 255, (len(xyz), 3))
    lab = rng.integers(0, 13, len(xyz))
    return np.concatenate([xyz, rgb, lab[:, None]], 1)


def counted_room(rng, counts):
    """A room whose block (i, j) holds counts[i][j] points, all strictly
    inside it (no point on an edge), in shuffled order."""
    xyz = [rng.uniform([i + 0.01, j + 0.01, 0], [i + 0.99, j + 0.99, 3], (n, 3))
           for i, row in enumerate(counts) for j, n in enumerate(row)]
    xyz = np.concatenate(xyz)
    return as_room(xyz[rng.permutation(len(xyz))], rng)


def sweep_room(case, rng):
    """(room, num_point, min_points) of one edge-rule case of the sweep."""
    if case == "interior_edges":  # points on x = 1, 2 and y = 1, 2, corners
        xyz = rng.uniform([0, 0, 0], [3.5, 2.5, 3], (3000, 3))
        xyz[:300, 0] = rng.choice([1.0, 2.0], 300)  # in 2 blocks (4 on y = 1, 2)
        xyz[300:600, 1] = rng.choice([1.0, 2.0], 300)
        xyz[600:700, 0:2] = rng.choice([1.0, 2.0], (100, 2))  # in 4 blocks
        return as_room(xyz[rng.permutation(len(xyz))], rng), 64, 20
    if case == "integer_wall":  # x == limit == 5.0: only in the block below
        xyz = rng.uniform([0, 0, 0], [5, 3, 3], (4000, 3))
        xyz[:500, 0] = 5.0
        xyz[500:900, 1] = 3.0
        xyz[900:950, 0:2] = [5.0, 3.0]
        xyz[950:1100, 0:2] = [0.0, 0.0]  # the origin: no block below it
        return as_room(xyz, rng), 64, 20
    if case == "fractional_wall":  # x == limit == 4.6, and x < 0
        xyz = rng.uniform([0, 0, 0], [4.6, 2.3, 3], (4000, 3))
        xyz[:500, 0] = 4.6
        xyz[500:900, 1] = 2.3
        xyz[900:1000, 0] = 4.0
        xyz[1000:1050, 0] = rng.choice([-1.0, -0.5, -1e-9], 50)  # in no block
        return as_room(xyz, rng), 64, 20
    if case == "counts":  # exactly num_point; min_points - 1, at, above
        return counted_room(rng, [[128, 99, 100], [101, 400, 30]]), 128, 100
    if case == "none_kept":
        return counted_room(rng, [[99, 20], [0, 99]]), 128, 100
    raise ValueError(case)


SWEEP_CASES = ["interior_edges", "integer_wall", "fractional_wall", "counts",
               "none_kept"]


def large_room(rng, size=(8.0, 6.0, 3.0), per_m2=10600):
    """A surface-sampled room of ~1.5 M points at 8 x 6 x 3 m: floor,
    ceiling and four walls, the far walls at whole metres (their points lie
    on block edges), in plane order. The room benchmark's rooms
    (chip_smoke.py::surface_room) add a table, a bookcase face and clutter
    and colour by class; this one keeps to the planes that put points on
    the grid's edges, with random colours and labels."""
    sx, sy, sz = size
    parts = []
    for z in (0.0, sz):
        n = int(sx * sy * per_m2)
        parts.append(np.stack([rng.uniform(0, sx, n), rng.uniform(0, sy, n),
                               np.full(n, z)], 1))
    for fixed, length, along_x in ((0.0, sx, True), (sy, sx, True),
                                   (0.0, sy, False), (sx, sy, False)):
        n = int(length * sz * per_m2 / 2)
        t, z, c = rng.uniform(0, length, n), rng.uniform(0, sz, n), np.full(n, fixed)
        parts.append(np.stack((t, c, z) if along_x else (c, t, z), 1))
    return as_room(np.concatenate(parts), rng)


def write_area(base, rooms, area="area5"):
    """``rooms`` as ``<base>/rooms/<area>_<i>.npy``, listed in
    ``<base>/meta/<area>_data_label.txt`` (S3DISTestRooms' layout)."""
    os.makedirs(os.path.join(base, "meta"), exist_ok=True)
    os.makedirs(os.path.join(base, "rooms"), exist_ok=True)
    rel = [f"rooms/{area}_{i}.npy" for i in range(len(rooms))]
    for r, room in zip(rel, rooms):
        np.save(os.path.join(base, r), room)
    with open(os.path.join(base, "meta", f"{area}_data_label.txt"), "w") as f:
        f.write("".join(r + "\n" for r in rel))
    return [os.path.join(base, r) for r in rel]


def plain_sweep(room, num_point, min_points, rng):
    """(blocks, labels, room_max) of ``room`` swept on the CPU by the
    port (room_to_blocks: load_room's sweep over ops/room_sweep.py's plain
    versions), room_max the room's xyz max as float32."""
    blocks, labels = s3dis.room_to_blocks(room, num_point,
                                          min_points=min_points, rng=rng)
    return blocks, labels, room[:, 0:3].max(0).astype(np.float32)


def sweep_on(device, rooms_and_params, base, monkeypatch, seed, reference):
    """Each (room, num_point, min_points) through load_room(device=...) on
    one generator (one reader per num_point, its host buffers reused), and
    through ``reference(room, num_point, min_points, rng)`` -> (blocks,
    labels, room_max) as numpy arrays on a copy of it: both results per
    room, and whether the generators end in the same state."""
    rng = np.random.default_rng(seed)
    ref = copy.deepcopy(rng)
    write_area(str(base), [r for r, _, _ in rooms_and_params])
    readers, out = {}, []
    for i, (room, num_point, min_points) in enumerate(rooms_and_params):
        monkeypatch.setattr(s3dis, "MIN_POINTS", min_points)
        if num_point not in readers:
            readers[num_point] = s3dis.S3DISTestRooms(str(base), "area5",
                                                      num_point=num_point)
        got = readers[num_point].load_room(i, rng=rng, device=device)
        out.append((got, reference(room, num_point, min_points, ref)))
    return out, rng.random() == ref.random()


def assert_sweep_equal(got, want, device):
    """load_room's (blocks, labels, path, room_max) on ``device`` bitwise
    the reference's (blocks, labels, room_max)."""
    blocks, labels, _, room_max = got
    assert blocks.device.type == labels.device.type == torch.device(device).type
    assert blocks.dtype == torch.float32 and labels.dtype == torch.int32
    assert isinstance(room_max, np.ndarray) and room_max.dtype == np.float32
    assert blocks.shape == want[0].shape and labels.shape == want[1].shape
    assert torch.equal(blocks.cpu(), torch.from_numpy(want[0]))
    assert torch.equal(labels.cpu(), torch.from_numpy(want[1]))
    assert np.array_equal(room_max, want[2])


def cases_in_turn():
    """Every case, float64 then float32, each on a room of its own."""
    return [(room.astype(dt), p, m)
            for dt in (np.float64, np.float32)
            for room, p, m in (sweep_room(c, np.random.default_rng(i))
                               for i, c in enumerate(SWEEP_CASES))]
