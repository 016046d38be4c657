"""The port's synthetic convergence recipes (utils/synth_convergence.py)
against the JAX package's: the same learnable sets from the same seeds,
bitwise, and a tiny CPU smoke of both recipes (the calibrated 1024-point
runs and their bars are chip_smoke.py's phase 10 on the card).

The S3DIS set: the JAX writer puts its blocks in an h5 shard (h5py is
here); the port builds the same arrays in memory with numpy only.
"""

import h5py
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.data import s3dis as js3dis
from weaksuppointcloudseg_tpu.utils import synth_convergence as jsc
from weaksuppointcloudseg_tpu_torch.data import s3dis
from weaksuppointcloudseg_tpu_torch.utils import synth_convergence as sc

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 3])
def test_learnable_shapenet_matches_jax(seed):
    """The same shapes, parts and categories from the same numpy seed, and
    the val extension around the first draw's centres."""
    got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = sc.learnable_shapenet(got_rng, 64, 128)
    want = jsc.learnable_shapenet(want_rng, 64, 128)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ext_got = sc.learnable_shapenet(got_rng, 80, 128, centers=got[3])
    ext_want = jsc.learnable_shapenet(want_rng, 80, 128, centers=want[3])
    for a, b in zip(ext_got, ext_want):
        np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32


@pytest.mark.parametrize("num_points,blocks_per_room", [(128, 4), (1024, 8)])
def test_s3dis_synthetic_blocks_match_jax_writer(tmp_path, num_points,
                                                 blocks_per_room):
    """data/s3dis.py::synthetic_blocks gives, bitwise, the blocks, labels
    and room list the JAX write_synthetic writes (the convergence recipe's
    arguments, and a small set), and they split by area as the trainer
    reads them."""
    kw = dict(num_rooms_per_area=6, blocks_per_room=blocks_per_room,
              num_points=num_points, areas=(1, 5), seed=0)
    js3dis.write_synthetic(str(tmp_path), **kw)
    with h5py.File(tmp_path / "ply_data_all_0.h5", "r") as f:
        want_data, want_label = f["data"][:], f["label"][:]
    with open(tmp_path / "room_filelist.txt") as f:
        want_rooms = [line.strip() for line in f if line.strip()]
    data, label, rooms = s3dis.synthetic_blocks(**kw)
    assert data.dtype == np.float32 and label.dtype == np.int32
    np.testing.assert_array_equal(data, want_data)
    np.testing.assert_array_equal(label, want_label)
    assert rooms == want_rooms
    ds = s3dis.S3DISDataset.from_arrays(data, label, rooms)
    want_ds = js3dis.S3DISDataset(str(tmp_path))
    for a, b in zip(ds.split_indices(5), want_ds.split_indices(5)):
        np.testing.assert_array_equal(a, b)
    batch = next(ds.batches(ds.split_indices(5)[0], 4))
    np.testing.assert_array_equal(batch.data, data[:4])


@pytest.mark.parametrize("dtype,fast,static", [
    ("float32", False, False), ("bfloat16", True, True)])
def test_shapenet_recipe_smoke_on_cpu(dtype, fast, static):
    """The ShapeNet recipe end to end on the CPU at a tiny shape (the
    decoupled draw and the tail-averaged eval), dynamic and static graph:
    an mIoU in [0, 1]."""
    m = sc.shapenet_train_and_eval_miou(
        dtype, fast, seed=0, epochs=2, static_graph=static, data_seed=0,
        eval_tail=2, n_points=128, bs=4, device="cpu")
    assert 0.0 <= m <= 1.0


def test_shapenet_recipe_eval_tail_needs_data_seed():
    """eval_tail > 1 without data_seed would perturb the training stream:
    it raises before any training."""
    with pytest.raises(ValueError, match="data_seed"):
        sc.shapenet_train_and_eval_miou(
            "float32", False, seed=0, epochs=2, eval_tail=2, n_points=128,
            bs=4, device="cpu")


def test_s3dis_recipe_smoke_on_cpu():
    """The S3DIS recipe through S3DISTrainer on the CPU at 128-point
    blocks, static graph in bf16 with knn_fast (the CPU's plain
    composition): mIoU and accuracy in [0, 1]."""
    miou, acc = sc.s3dis_train_and_eval_miou(
        "bfloat16", True, seed=0, epochs=2, static_graph=True, n_points=128,
        bs=4, device="cpu")
    assert 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0
