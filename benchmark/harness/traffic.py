"""The benchmark's data generators, numpy only, each fixed by its seed.

Copied from chip_smoke.py (``CATEGORIES``, ``synthetic_split``,
``surface_room``, the block maker of ``write_s3dis_split``), frozen here:
the program may change, the traffic may not. The copies return arrays
and write nothing; :func:`write_rooms` writes the raw rooms as ``.npy``
where the run asks.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

# ShapeNet's 16 categories with their part counts (50 parts in all)
CATEGORIES = (
    ("Airplane", "02691156", 4), ("Bag", "02773838", 2), ("Cap", "02954340", 2),
    ("Car", "02958343", 4), ("Chair", "03001627", 4),
    ("Earphone", "03261776", 3), ("Guitar", "03467517", 3),
    ("Knife", "03624134", 2), ("Lamp", "03636649", 4),
    ("Laptop", "03642806", 2), ("Motorbike", "03790512", 6),
    ("Mug", "03797390", 2), ("Pistol", "03948459", 3),
    ("Rocket", "04099429", 3), ("Skateboard", "04225987", 3),
    ("Table", "04379243", 3))


def part_offsets() -> np.ndarray:
    return np.cumsum([0] + [p for _, _, p in CATEGORIES])


def synthetic_split(num: int, points: int, rng: np.random.Generator):
    """(data [S, points, 3] f32, label [S] i32, seg [S, points] i32): clouds
    of the 16 categories with their real part counts, parts as slabs along
    z, normalised to the unit sphere as the h5 splits are (chip_smoke.py::
    synthetic_split)."""
    offsets = part_offsets()
    label = rng.integers(0, len(CATEGORIES), num).astype(np.int32)
    data = rng.standard_normal((num, points, 3)) * np.array([0.3, 0.2, 0.6])
    data += rng.standard_normal((num, 1, 3)) * 0.05 * label[:, None, None] / 16
    data /= np.linalg.norm(data, axis=-1).max(axis=1)[:, None, None]
    parts = np.array([p for _, _, p in CATEGORIES])[label][:, None]
    rank = np.argsort(np.argsort(data[..., 2], axis=1), axis=1)
    seg = offsets[label][:, None] + (rank * parts) // points
    return data.astype(np.float32), label, seg.astype(np.int32)


def s3dis_blocks(num: int, points: int, rng: np.random.Generator):
    """(data [S, points, 9] f32, label [S, points] i32): 1 m blocks of a 6 x
    6 x 3 m room (xy centred, z, rgb / 255, xyz over the room's extent)
    with 13 labels by height and by wall distance; a third hold half to all
    but one of ``points`` distinct points padded with repeats, as the block
    sampler pads short blocks (chip_smoke.py::write_s3dis_split, its
    arrays)."""
    data = np.empty((num, points, 9), np.float32)
    label = np.empty((num, points), np.int32)
    for i in range(num):
        bx, by = rng.integers(0, 6, 2)
        m = int(rng.integers(points // 2, points)) if i % 3 == 0 else points
        xyz = rng.random((m, 3)) * np.array([1.0, 1.0, 3.0]) + np.array([bx, by, 0])
        xyz = xyz[np.concatenate([np.arange(m), rng.integers(0, m, points - m)])]
        wall = np.minimum.reduce([xyz[:, 0], xyz[:, 1], 6 - xyz[:, 0], 6 - xyz[:, 1]])
        lab = np.minimum((xyz[:, 2] / 3.0 * 10).astype(int), 9)
        lab = np.where(wall < 0.3, 10 + (xyz[:, 2] > 1.5), lab)
        lab[rng.random(points) < 0.02] = 12
        rgb = np.clip(lab[:, None] / 12.0 + rng.random((points, 3)) * 0.3, 0, 1)
        data[i] = np.concatenate([
            xyz - np.array([bx + 0.5, by + 0.5, 0]), rgb,
            xyz / np.array([6.0, 6.0, 3.0])], axis=1)
        label[i] = lab
    return data, label


def labelled_points(num: int, points: int, fraction: float,
                    rng: np.random.Generator) -> np.ndarray:
    """floor(fraction * points) labelled points of each sample, drawn
    without replacement: int64 [num, n_labelled]."""
    n = max(1, int(fraction * points))
    return np.stack([rng.choice(points, n, replace=False) for _ in range(num)])


def surface_room(rng: np.random.Generator, size, per_m2: int = 2000):
    """A raw S3DIS room [P, 7] (xyz in metres from the min corner, rgb
    0-255, label) sampled on surfaces as scans are: floor (1), ceiling
    (0), four walls (2), a table top (7) and a bookcase face (10), with
    clutter (12) in the volume; colours by class with noise
    (chip_smoke.py::surface_room). The point count depends on ``size`` and
    ``per_m2`` alone."""
    sx, sy, sz = size
    parts = []

    def plane(n, lab, x, y, z):
        parts.append((np.stack([x, y, z], 1), np.full(n, lab)))

    for lab, z in ((1, 0.0), (0, sz)):
        n = int(sx * sy * per_m2)
        plane(n, lab, rng.uniform(0, sx, n), rng.uniform(0, sy, n), np.full(n, z))
    for fixed, length, along_x in ((0.0, sx, True), (sy, sx, True),
                                   (0.0, sy, False), (sx, sy, False)):
        n = int(length * sz * per_m2 / 2)
        t, z = rng.uniform(0, length, n), rng.uniform(0, sz, n)
        c = np.full(n, fixed)
        plane(n, 2, *((t, c, z) if along_x else (c, t, z)))
    n = int(1.2 * 0.8 * per_m2)
    plane(n, 7, rng.uniform(1.0, 2.2, n), rng.uniform(1.0, 1.8, n), np.full(n, 0.75))
    n = int(2.0 * 1.8 * per_m2)
    plane(n, 10, rng.uniform(2.5, 4.5, n), np.full(n, 0.3), rng.uniform(0, 1.8, n))
    n = int(sx * sy * per_m2 * 0.05)
    plane(n, 12, *(rng.uniform(0, m, n) for m in size))
    xyz = np.concatenate([p[0] for p in parts])
    lab = np.concatenate([p[1] for p in parts])
    rgb = np.clip(lab[:, None] * 19.0 + rng.normal(0, 20, (len(lab), 3)), 0, 255)
    return np.concatenate([xyz, rgb, lab[:, None]], 1)


def write_rooms(base: str, plans: Sequence[Sequence[float]], height: float,
                per_m2: int, rng: np.random.Generator) -> List[str]:
    """One surface-sampled room per floor plan (x, y metres), written as
    ``<base>/rooms/room_<i>.npy`` and listed alone in
    ``<base>/meta/r<i>_data_label.txt`` (the layout S3DIS test rooms are
    read from: area ``r<i>`` holds room i). Returns the room paths."""
    os.makedirs(os.path.join(base, "meta"), exist_ok=True)
    os.makedirs(os.path.join(base, "rooms"), exist_ok=True)
    paths = []
    for i, (sx, sy) in enumerate(plans):
        rel = f"rooms/room_{i}.npy"
        np.save(os.path.join(base, rel), surface_room(rng, (sx, sy, height), per_m2))
        with open(os.path.join(base, "meta", f"r{i}_data_label.txt"), "w") as f:
            f.write(rel + "\n")
        paths.append(os.path.join(base, rel))
    return paths


def cycle_order(n_items: int, cycles: int, rng: np.random.Generator) -> np.ndarray:
    """``cycles`` passes over items 0..n_items-1, each pass in its own
    random order: every seed sends the same rooms equally often."""
    return np.concatenate([rng.permutation(n_items) for _ in range(cycles)])


def split_seeds(seed: int, n: int) -> Tuple[np.random.Generator, ...]:
    """``n`` independent generators of the run's seed, none of them the
    stream ``np.random.default_rng(seed)`` that the trainers draw from."""
    return tuple(np.random.default_rng([seed, 7919, i]) for i in range(n))
