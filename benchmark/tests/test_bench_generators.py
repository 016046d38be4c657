"""Every generator of the benchmark is fixed by its seed, and the rooms'
sizes do not depend on it."""

import numpy as np

from harness import traffic
from reference import rooms as ref_rooms

SEED = 2**31 + 977


def test_split_seeds_fixed_and_apart():
    a = [g.random(4) for g in traffic.split_seeds(SEED, 3)]
    b = [g.random(4) for g in traffic.split_seeds(SEED, 3)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    trainer_stream = np.random.default_rng(SEED).random(4)
    assert not any(np.array_equal(x, trainer_stream) for x in a)


def test_shapenet_split_fixed_by_seed():
    one = traffic.synthetic_split(5, 64, np.random.default_rng(SEED))
    two = traffic.synthetic_split(5, 64, np.random.default_rng(SEED))
    other = traffic.synthetic_split(5, 64, np.random.default_rng(SEED + 1))
    for x, y in zip(one, two):
        assert np.array_equal(x, y)
    assert not np.array_equal(one[0], other[0])
    data, label, seg = one
    assert data.shape == (5, 64, 3) and data.dtype == np.float32
    assert np.allclose(np.linalg.norm(data, axis=-1).max(axis=1), 1.0, atol=1e-6)
    off = traffic.part_offsets()
    assert np.all(seg >= off[label][:, None]) and np.all(seg < off[label + 1][:, None])


def test_s3dis_blocks_fixed_by_seed():
    one = traffic.s3dis_blocks(4, 128, np.random.default_rng(SEED))
    two = traffic.s3dis_blocks(4, 128, np.random.default_rng(SEED))
    assert all(np.array_equal(x, y) for x, y in zip(one, two))
    data, label = one
    assert data.shape == (4, 128, 9) and label.max() <= 12
    assert np.all((data[..., 3:6] >= 0) & (data[..., 3:6] <= 1))


def test_labelled_points_fixed_and_distinct():
    a = traffic.labelled_points(3, 100, 0.1, np.random.default_rng(SEED))
    b = traffic.labelled_points(3, 100, 0.1, np.random.default_rng(SEED))
    assert np.array_equal(a, b) and a.shape == (3, 10)
    assert all(len(set(row)) == 10 for row in a)


def test_room_size_independent_of_seed():
    a = traffic.surface_room(np.random.default_rng(SEED), (5, 3, 3.0), 200)
    b = traffic.surface_room(np.random.default_rng(SEED), (5, 3, 3.0), 200)
    c = traffic.surface_room(np.random.default_rng(SEED + 5), (5, 3, 3.0), 200)
    assert np.array_equal(a, b) and a.shape == c.shape and not np.array_equal(a, c)
    limit, kept = ref_rooms.columns(a)
    assert len(kept) == 15  # a 5 x 3 m floor plan sweeps into 15 blocks


def test_write_rooms_and_cycle(tmp_path):
    paths = traffic.write_rooms(str(tmp_path), [[2, 2], [3, 2]], 3.0, 100,
                                np.random.default_rng(SEED))
    again = traffic.write_rooms(str(tmp_path / "b"), [[2, 2], [3, 2]], 3.0, 100,
                                np.random.default_rng(SEED))
    for p, q in zip(paths, again):
        assert np.array_equal(np.load(p), np.load(q))
    order = traffic.cycle_order(3, 4, np.random.default_rng(SEED))
    assert np.array_equal(np.bincount(order), [4, 4, 4])
    assert np.array_equal(order, traffic.cycle_order(3, 4, np.random.default_rng(SEED)))
