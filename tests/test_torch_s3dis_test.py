"""The S3DIS test path on the CPU against the JAX package: the room sweep
(room_to_blocks, S3DISTestRooms.load_room on the CPU, over the plain
versions of ops/room_sweep.py, and the host buffer's reader),
S3DISTrainer.test with per-block and room-level label propagation, the
.mat dumps, and cli.test_s3dis.

Tolerances: the room sweep bitwise (the same float64 arithmetic and the
same draws from the caller's generator); the test path as stated at each
test.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import scipy.io
import torch

from sweep_rooms import (
    SWEEP_CASES,
    assert_sweep_equal,
    cases_in_turn,
    sweep_on,
    sweep_room,
    write_area,
)
from test_torch_train import jax_weights, port_cfg
from weaksuppointcloudseg_tpu import configs as jc
from weaksuppointcloudseg_tpu.cli import common as jax_common
from weaksuppointcloudseg_tpu.data import s3dis as js3dis
from weaksuppointcloudseg_tpu.train.loop import S3DISTrainer as JaxTrainer
from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.cli import test_s3dis
from weaksuppointcloudseg_tpu_torch.data import s3dis
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import (
    params_from_jax,
    save_checkpoint,
)

torch.set_num_threads(1)

N = 64


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("s3dis_rooms"))
    js3dis.write_synthetic(base, num_rooms_per_area=2, areas=(1, 5),
                           blocks_per_room=5, num_points=N, seed=3)
    return base


def edge_room(rng, n=3000):
    """A 3.4 x 2 x 3 m room with points on the block edges x, y = 1, 2 m
    (they belong to both neighbours) and a sparse corner block of fewer
    than 100 points (dropped)."""
    xyz = rng.uniform([0, 0, 0], [3.4, 2.0, 3.0], (n, 3))
    xyz[:200, 0] = 1.0
    xyz[200:400, 1] = 2.0
    xyz[xyz[:, 0] > 3.0] *= [1.0, 0.3, 1.0]  # thin out x in (3, 3.4]
    keep = ~((xyz[:, 0] > 3.0) & (xyz[:, 1] < 0.3))
    keep[np.flatnonzero((xyz[:, 0] > 3.0) & (xyz[:, 1] < 0.3))[:50]] = True
    xyz = xyz[keep]
    rgb = rng.uniform(0, 255, (len(xyz), 3))
    lab = rng.integers(0, 13, len(xyz))
    return np.concatenate([xyz, rgb, lab[:, None]], 1)


@pytest.mark.parametrize("num_point", [64, 500])
def test_room_to_blocks_matches_reference(num_point):
    """Bitwise, with the same seed: more points than num_point in a block
    (a draw with replacement) and fewer (all plus a draw)."""
    room = edge_room(np.random.default_rng(0))
    got = s3dis.room_to_blocks(room, num_point, rng=np.random.default_rng(1))
    want = js3dis.room_to_blocks(room, num_point, rng=np.random.default_rng(1))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 4 * 2 - 1  # the sparse corner block is dropped
    empty = s3dis.room_to_blocks(room[:50], num_point)
    assert empty[0].shape == (0, num_point, 9) and empty[1].shape == (0, num_point)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_one_pass_sweep_matches_reference(case, dtype):
    """Bitwise against the reference's mask per block: blocks, labels and
    the caller's generator after the sweep, on rooms that stress the
    inclusive bounds (a point on an edge in 2 blocks, on a corner in 4, a
    wall at an integer and a fractional far extent) and the block counts
    (exactly num_point, min_points - 1 and min_points, no block kept)."""
    room, num_point, min_points = sweep_room(case, np.random.default_rng(5))
    room = room.astype(dtype)
    rg, rw = np.random.default_rng(9), np.random.default_rng(9)
    got = s3dis.room_to_blocks(room, num_point, min_points=min_points, rng=rg)
    want = js3dis.room_to_blocks(room, num_point, min_points=min_points, rng=rw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert rg.random() == rw.random()
    kept = {"interior_edges": 12, "integer_wall": 15, "fractional_wall": 15,
            "counts": 4, "none_kept": 0}[case]
    assert len(got[0]) == kept


def test_one_pass_sweep_rooms_in_turn():
    """Every case swept in turn on one generator (as S3DISTrainer.test
    draws across rooms) ends where the reference's does, twice over."""
    rooms = [sweep_room(c, np.random.default_rng(i))
             for i, c in enumerate(SWEEP_CASES * 2)]
    rg, rw = np.random.default_rng(11), np.random.default_rng(11)
    for room, num_point, min_points in rooms:
        got = s3dis.room_to_blocks(room, num_point, min_points=min_points, rng=rg)
        want = js3dis.room_to_blocks(room, num_point, min_points=min_points,
                                     rng=rw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert rg.random() == rw.random()


def as_numpy(loaded):
    """load_room's (blocks, labels, path, room_max) with the tensors as
    numpy arrays."""
    blocks, labels, path, room_max = loaded
    return blocks.numpy(), labels.numpy(), path, room_max


def test_load_room_matches_reference(dataset):
    got = s3dis.S3DISTestRooms(dataset, "area5", num_point=N)
    want = js3dis.S3DISTestRooms(dataset, "area5", num_point=N)
    assert got.room_paths == want.room_paths and len(got) == 2
    rg, rw = np.random.default_rng(2), np.random.default_rng(2)
    for i in range(len(got)):  # one generator across rooms, as test() draws
        a, b = got.load_room(i, rng=rg), want.load_room(i, rng=rw)
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in a[:2])
        for x, y in zip(as_numpy(a), b):
            np.testing.assert_array_equal(x, y)
        assert a[3].dtype == np.float32 and a[0].shape[1:] == (N, 9)
    txt = os.path.join(os.path.dirname(got.room_paths[0]), "room.txt")
    np.savetxt(txt, np.load(got.room_paths[0])[:500])
    got.room_paths = want.room_paths = [txt]
    for x, y in zip(as_numpy(got.load_room(0)), want.load_room(0)):
        np.testing.assert_array_equal(x, y)


def test_load_room_extent_from_the_sweep(dataset):
    """room_max, taken from the sweep's pass, is the room's xyz max as
    float32, for a .npy room and a .txt room."""
    rooms = s3dis.S3DISTestRooms(dataset, "area5", num_point=N)
    npy = rooms.room_paths[0]
    txt = os.path.join(os.path.dirname(npy), "extent.txt")
    np.savetxt(txt, np.load(npy)[:700])
    rooms.room_paths = [npy, txt]
    for i, raw in enumerate([np.load(npy), np.loadtxt(txt)]):
        blocks, _, _, room_max = rooms.load_room(i)
        assert isinstance(blocks, torch.Tensor) and room_max.dtype == np.float32
        np.testing.assert_array_equal(
            room_max, raw[:, 0:3].max(axis=0).astype(np.float32))


# ------------------------------------------- the sweep on a torch device

def jax_sweep(room, num_point, min_points, rng):
    """The reference's (blocks, labels) of ``room`` and its room_max, as
    the JAX package's load_room computes it."""
    blocks, labels = js3dis.room_to_blocks(room, num_point,
                                           min_points=min_points, rng=rng)
    return blocks, labels, room[:, 0:3].max(axis=0).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_device_sweep_matches_sweep(case, dtype, tmp_path, monkeypatch):
    """load_room(device=cpu) over the kernels' plain versions: blocks,
    labels, room_max and the generator bitwise the JAX package's sweep of
    the same room."""
    room, num_point, min_points = sweep_room(case, np.random.default_rng(5))
    (res,), same_rng = sweep_on("cpu", [(room.astype(dtype), num_point, min_points)],
                                tmp_path, monkeypatch, 9, jax_sweep)
    assert_sweep_equal(*res, "cpu")
    assert same_rng


def test_device_sweep_rooms_in_turn(tmp_path, monkeypatch):
    """Every case in turn (float64, then float32) on one generator."""
    res, same_rng = sweep_on("cpu", cases_in_turn(), tmp_path, monkeypatch, 11,
                             jax_sweep)
    for got, want in res:
        assert_sweep_equal(got, want, "cpu")
    assert same_rng


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_block_members_plain_matches_numpy(case, dtype):
    """ops/room_sweep.py::block_members on a CPU tensor (its plain
    version): the members and counts of the reference's mask per block,
    block (i, j) holding i <= x <= i + 1 and j <= y <= j + 1, its members
    in index order, blocks numbered i * num_y + j."""
    from weaksuppointcloudseg_tpu_torch.ops import room_sweep

    room = sweep_room(case, np.random.default_rng(5))[0].astype(dtype)
    x, y = room[:, 0].astype(np.float64), room[:, 1].astype(np.float64)
    num_x, num_y = int(np.ceil(x.max() - 1)) + 1, int(np.ceil(y.max() - 1)) + 1
    masks = [np.flatnonzero((x >= i) & (x <= i + 1) & (y >= j) & (y <= j + 1))
             for i in range(num_x) for j in range(num_y)]
    got_m, got_c = room_sweep.block_members(torch.from_numpy(room), num_x, num_y)
    assert got_m.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), [len(m) for m in masks])
    np.testing.assert_array_equal(got_m.numpy(), np.concatenate(masks))


@pytest.mark.parametrize("raw,grid", [
    (torch.zeros((10, 7), dtype=torch.int64), (2, 2)),  # not a float room
    (torch.zeros((0, 7)), (2, 2)),  # no point
    (torch.zeros((10, 7)), (111, 111)),  # more blocks than the kernel holds
])
def test_sweep_wrappers_reject(raw, grid):
    """The sweep's wrappers refuse what the kernels do not take, on the
    CPU as on the card; the gather wants rgb and a label (7 columns)."""
    from weaksuppointcloudseg_tpu_torch.ops import room_sweep

    with pytest.raises(ValueError):
        room_sweep.block_members(raw, *grid)
    members = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="C >= 7"):
        room_sweep.gather_blocks(torch.zeros((10, 6)), members, members[None],
                                 (1, 1, 1))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_read_room_into_a_reused_buffer(dtype, tmp_path):
    """A C-order float .npy is read straight into the host buffer (in
    slices, at once), equal to np.load; the buffer is reused for a smaller
    room and grows for a larger one; a payload cut short raises."""
    rng = np.random.default_rng(0)
    rooms = [rng.uniform(0, 9, (n, 7)).astype(dtype) for n in (500, 300, 900)]
    paths = write_area(str(tmp_path), rooms)
    buf = s3dis._HostBuffer(torch.device("cpu"))
    ptrs = []
    for path, room in zip(paths, rooms):
        got = s3dis.read_room(path, buf)
        assert got.dtype == dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, np.load(path))
        ptrs.append(got.ctypes.data)
    assert ptrs[1] == ptrs[0] != ptrs[2]
    with open(paths[2], "r+b") as f:  # a payload cut short
        f.truncate(os.path.getsize(paths[2]) - 8)
    with pytest.raises(ValueError, match="8 bytes short"):
        s3dis.read_room(paths[2], buf)


def test_read_room_falls_back(tmp_path, monkeypatch):
    """A Fortran-order .npy and a .txt room go through np.load and
    np.loadtxt, then into the buffer; an int room as float64."""
    rng = np.random.default_rng(1)
    room = rng.uniform(0, 9, (400, 7))
    fortran = str(tmp_path / "f.npy")
    np.save(fortran, np.asfortranarray(room))
    ints = str(tmp_path / "i.npy")
    np.save(ints, room.astype(np.int32))
    txt = str(tmp_path / "t.txt")
    np.savetxt(txt, room)
    loads = []
    load = np.load
    monkeypatch.setattr(np, "load", lambda *a, **k: loads.append(a) or load(*a, **k))
    buf = s3dis._HostBuffer(torch.device("cpu"))
    np.testing.assert_array_equal(s3dis.read_room(fortran, buf), room)
    got = s3dis.read_room(ints, buf)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, room.astype(np.int32))
    assert len(loads) == 2
    np.testing.assert_array_equal(s3dis.read_room(txt, buf), np.loadtxt(txt))


# --------------------------------------------------------- the test path

def tiny_cfg(batch_size):
    """The S3DIS preset at narrow width. The synthetic rooms hold 64
    points per 1 m block (real blocks 4096), so the LP's xyz bandwidth is
    lowered from 1e3 to 10 for the points to have neighbours."""
    base = jc.s3dis_config()
    model = dataclasses.replace(
        base.model, num_points=N, k=8, global_channels=128,
        edge_channels=((16, 16), (16, 16), (16,)), head_channels=(32, 16))
    return dataclasses.replace(
        base, model=model,
        labelprop=dataclasses.replace(base.labelprop, xyz_bandwidth=10.0),
        train=dataclasses.replace(base.train, batch_size=batch_size,
                                  style="Full"))


@pytest.fixture(scope="module")
def trainers(dataset):
    """A JAX trainer and the port's (on the CPU) with the same non-trivial
    weights, at chunks of 3 blocks (a ragged last chunk per room)."""
    cfg = tiny_cfg(3)
    params, state = jax_weights(cfg, seed=1)
    jt = JaxTrainer(cfg, js3dis.S3DISDataset(dataset), None, test_area=5, seed=0)
    jt.state = jt.state.replace(params=jax.tree.map(np.asarray, params),
                                bn_state=jax.tree.map(np.asarray, state))
    pt = S3DISTrainer(port_cfg(cfg), s3dis.S3DISDataset(dataset), None,
                      test_area=5, seed=0, device="cpu")
    pt.model.load_state_dict(params_from_jax(params, state), strict=True)
    return jt, pt


@pytest.mark.parametrize("room_lp", [False, True])
def test_test_path_matches_jax(dataset, trainers, tmp_path, room_lp):
    """Same rooms (the same draws), same weights, f32, label propagation
    per block chunk or over each whole room (rooms of 5 blocks, padded to
    8). The forward and the LP sum in other orders than XLA's: the
    probabilities differ by ~1e-5, so a point whose two best classes tie
    that closely may flip (measured: one point of 256 in one room, in both
    modes). Held: the predictions in the .mat dumps agree on >= 99% of
    points, the mIoU and every class IoU within 1e-2 (measured 3e-5), the
    dumped blocks and labels bitwise. At the lowered bandwidth the LP
    moves a quarter of the predictions, and the room LP a quarter of the
    per-block LP's."""
    jt, pt = trainers
    jt.np_rng, pt.np_rng = np.random.default_rng(0), np.random.default_rng(0)
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    want = jt.test(js3dis.S3DISTestRooms(dataset, "area5", num_point=N),
                   use_label_prop=True, pred_dir=dirs["jax"], room_lp=room_lp)
    got = pt.test(s3dis.S3DISTestRooms(dataset, "area5", num_point=N),
                  use_label_prop=True, pred_dir=dirs["port"], room_lp=room_lp)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) and len(names) == 2
    agree = []
    for name in names:
        a = scipy.io.loadmat(os.path.join(dirs["port"], name))
        b = scipy.io.loadmat(os.path.join(dirs["jax"], name))
        np.testing.assert_array_equal(a["data"], b["data"])
        np.testing.assert_array_equal(a["gt"], b["gt"])
        agree.append((a["pred"] == b["pred"]).mean())
    assert min(agree) >= 0.99, agree
    assert abs(got["miou"] - want["miou"]) <= 1e-2
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-2
    np.testing.assert_allclose(got["per_class_iou"], want["per_class_iou"],
                               atol=1e-2)


def test_room_lp_with_plain_style_warns_and_takes_argmax(dataset, trainers):
    """-sty Plain with --RoomLP: the reference's warning, and the plain
    per-block argmax (no LP) as without it."""
    _, pt = trainers
    rooms = s3dis.S3DISTestRooms(dataset, "area5", num_point=N)
    pt.np_rng = np.random.default_rng(0)
    with pytest.warns(UserWarning, match="no effect"):
        got = pt.test(rooms, use_label_prop=False, room_lp=True)
    pt.np_rng = np.random.default_rng(0)
    want = pt.test(rooms, use_label_prop=False)
    assert got["miou"] == want["miou"]
    np.testing.assert_array_equal(got["per_class_iou"], want["per_class_iou"])


def test_room_label_prop_pads_to_eight_blocks(monkeypatch, trainers):
    """A room of 5 blocks goes to the CG as 8: 3 pad blocks of uniform
    probabilities 2 m beyond the room on every axis."""
    _, pt = trainers
    from weaksuppointcloudseg_tpu_torch.train import loop

    seen = {}

    def spy(xyz, g, rgb, **kw):
        seen.update(xyz=xyz, g=g, rgb=rgb, solver=kw["solver"])
        return g
    monkeypatch.setattr(loop, "propagate_batch", spy)
    rng = np.random.default_rng(4)
    blocks = rng.uniform(0, 1, (5, N, 9)).astype(np.float32)
    prob = rng.dirichlet(np.ones(13), (5, N)).astype(np.float32)
    room_max = np.array([3.0, 2.0, 2.5], np.float32)
    pred = pt.room_label_prop(blocks, prob, room_max)
    assert pred.shape == (5, N) and seen["solver"] == "cg_matfree"
    assert seen["xyz"].shape == (1, 8 * N, 3)
    np.testing.assert_array_equal(seen["xyz"][0, 5 * N:].numpy(),
                                  np.broadcast_to(room_max + 2.0, (3 * N, 3)))
    np.testing.assert_allclose(seen["g"][0, 5 * N:].numpy(), 1 / 13)
    np.testing.assert_array_equal(pred, prob.argmax(-1))


# ------------------------------------------------------------------- CLI

def test_room_label_prop_tensor_blocks_match_arrays(trainers):
    """room_label_prop builds the cloud from tensor blocks (load_room's on
    a device) as from arrays: the same labels."""
    _, pt = trainers
    rng = np.random.default_rng(6)
    blocks = rng.uniform(0, 1, (5, N, 9)).astype(np.float32)
    prob = rng.dirichlet(np.ones(13), (5, N)).astype(np.float32)
    room_max = np.array([3.0, 2.0, 2.5], np.float32)
    want = pt.room_label_prop(blocks, prob, room_max)
    got = pt.room_label_prop(torch.from_numpy(blocks), prob, room_max)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    assert (want != prob.argmax(-1)).any()


def test_test_s3dis_flags_match_reference():
    """The reference S3DIS test CLI's flags, plus the port's --device and
    -bs (--batchsize as the training CLIs spell it)."""
    want = jax_common.base_parser("S3DIS", train=False)
    want.add_argument("--test_area", "-ta")
    for flag in ("--RoomsPath", "--RoomLP", "--device", "-bs"):
        want.add_argument(flag)
    got = test_s3dis.parser()
    assert ({s for a in got._actions for s in a.option_strings}
            == {s for a in want._actions for s in a.option_strings})
    assert got.parse_args([]).batchsize == 1
    assert got.parse_args(["-bs", "14"]).batchsize == 14
    assert got.parse_args(["--batchsize", "3", "-sty", "Plain"]).Style == "Plain"


def test_lp_solver_help_names_the_ported_solvers():
    """--LPSolver's help on both test CLIs names the solvers the port runs
    (solve, cg, cg_matfree) and the one propagate_batch still refuses."""
    from weaksuppointcloudseg_tpu_torch.cli import test_shapenet
    from weaksuppointcloudseg_tpu_torch.propagate import label_prop

    for p in (test_s3dis.parser(), test_shapenet.parser()):
        (action,) = [a for a in p._actions if "--LPSolver" in a.option_strings]
        ported = [c for c in action.choices if c not in label_prop._NOT_PORTED]
        assert ported == ["solve", "cg", "cg_matfree"]
        head, tail = action.help.split(";")
        assert head.endswith("ported: " + ", ".join(ported))
        assert all(c in tail for c in label_prop._NOT_PORTED)
        assert "only cg" not in action.help


@pytest.mark.parametrize("room_lp", [False, True])
def test_cli_on_cpu(dataset, tmp_path, capsys, monkeypatch, room_lp):
    """cli.test_s3dis --device cpu end to end on a full-width S3DIS model
    saved by the port (blocks of 64 points, as the synthetic set's: the
    preset's 4096 would make the CPU's room LP too slow): the reference's
    print, a .mat per room and PerClassIoU.mat, and the numbers of the
    trainer called directly."""
    preset = configs.s3dis_config

    def small():
        cfg = preset()
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_points=N))
    monkeypatch.setattr(configs, "s3dis_config", small)
    cfg = small()
    ckpt_dir = tmp_path / "run" / "Checkpoint"
    ckpt_dir.mkdir(parents=True)
    ckpt = save_checkpoint(str(ckpt_dir / "best"), DGCNNSeg(cfg.model, seed=5))
    res = test_s3dis.main(
        ["--DataPath", dataset, "--Checkpoint", ckpt, "-sty", "Full",
         "--batchsize", "4", "--device", "cpu"] + (["--RoomLP"] if room_lp else []))
    out = capsys.readouterr().out
    assert out.startswith("Test Area 5  mIoU ")
    assert "  ceiling    IoU " in out and "  clutter    IoU " in out
    pred = tmp_path / "run" / "Prediction"
    assert sorted(os.listdir(pred)) == [
        "Area_5_room_0_pred_gt.mat", "Area_5_room_1_pred_gt.mat",
        "PerClassIoU.mat"]
    np.testing.assert_array_equal(
        scipy.io.loadmat(pred / "PerClassIoU.mat")["per_class_iou"][0],
        res["per_class_iou"])
    assert np.isfinite(res["miou"]) and 0 <= res["accuracy"] <= 1
    trainer = S3DISTrainer(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=4)),
        s3dis.S3DISDataset(dataset), device="cpu")
    trainer.restore_checkpoint(ckpt)
    direct = trainer.test(s3dis.S3DISTestRooms(dataset, "area5", num_point=N),
                          use_label_prop=True, room_lp=room_lp)
    assert direct["miou"] == res["miou"]
