"""Configuration of the ported paths: the ShapeNet and S3DIS presets and the
DGCNN classifier.

Counterpart of weaksuppointcloudseg_tpu/configs.py: the fields keep the
reference's names and defaults, so either package's configs drive either
package's models (tests/test_torch_data.py holds the two equal). Fields of
paths not ported yet (data parallelism) come with those paths.
``TrainConfig.rng_impl`` is absent on purpose: "rbg" selects a TPU
hardware random-bit generator for dropout, and the port's dropout draws
from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """LR and batch-norm decay staircases, driven by samples seen
    (ShapeNet/ShapeNet_DGCNN_trainer.py:25-54)."""

    base_learning_rate: float = 1e-3
    lr_decay_step: int = 16881 * 20  # samples, not steps
    lr_decay_rate: float = 0.5
    lr_floor: float = 1e-5
    bn_init_decay: float = 0.5
    bn_decay_decay_rate: float = 0.5
    bn_decay_decay_step: int = 16881 * 20 * 2  # samples
    bn_decay_clip: float = 0.99


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DGCNN segmentation architecture: ShapeNet (ShapeNet/
    DGCNN_ShapeNet.py:15-113) and S3DIS (S3DIS/DGCNN_S3DIS.py:24-104)."""

    num_points: int = 2048
    in_channels: int = 3
    num_classes: int = 50
    k: int = 20
    # channel range the kNN graph is built on (None: all input channels)
    knn_channels: Optional[Tuple[int, int]] = None
    use_transform_net: bool = True
    num_categories: int = 0  # >0 enables the one-hot category-label branch
    edge_channels: Tuple[Tuple[int, ...], ...] = ((64, 64), (64, 64), (64,))
    global_channels: int = 1024
    category_embed_channels: int = 64
    head_channels: Tuple[int, ...] = (256, 256, 128)
    # dropout keep-probability after each head layer (None: no dropout)
    head_keep_prob: Tuple[Optional[float], ...] = (0.6, 0.6, None)
    bn_eps: float = 1e-3
    # the S3DIS head convs' BN stats decay at tf_util's fixed 0.9, not the
    # scheduled rate (DGCNN_S3DIS.py:95-101); None: scheduled everywhere
    head_bn_fixed_decay: Optional[float] = None
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # the kNN kernels: B12 for f32, the fused EdgeConv kernels for bf16
    use_fused_knn: bool = True
    # packed-min top-k selection: near-tie neighbors may reorder
    knn_fast: bool = False
    # opt-in (not reference parity): one kNN graph on the input
    # coordinates, reused by every EdgeConv stage (models/dgcnn.py)
    static_graph: bool = False


@dataclasses.dataclass(frozen=True)
class ClsConfig:
    """DGCNN classifier (Networks/dgcnn/models/dgcnn.py:20-107; the
    reference's models/dgcnn_cls.py:27-47). ``allow_known_bad_bf16`` is
    absent: it guards against a TPU backend's bf16 miscompile."""

    num_classes: int = 40
    k: int = 20
    edge_channels: Tuple[int, ...] = (64, 64, 64, 128)
    global_channels: int = 1024
    fc_channels: Tuple[int, ...] = (512, 256)
    keep_prob: float = 0.5
    label_smoothing: float = 0.2
    bn_eps: float = 1e-3
    use_fused_knn: bool = True
    # packed-min top-k selection (see ModelConfig.knn_fast)
    knn_fast: bool = False
    # one input-coordinate kNN graph reused by every EdgeConv stage
    # (see ModelConfig.static_graph: opt-in speed/accuracy trade)
    static_graph: bool = False


@dataclasses.dataclass(frozen=True)
class WeakSupConfig:
    """Weak-supervision loss settings (ShapeNet_DGCNN_trainer.py:115-133)."""

    siamese_weight: float = 1.0  # S3DIS: 10 (S3DIS_DGCNN_trainer.py:128)
    smooth_gamma: float = 1e-1
    smooth_knn: int = 10
    # channel range fed to the smooth loss distance (None: all channels;
    # S3DIS: xyzrgb, 0:6)
    smooth_channels: Optional[Tuple[int, int]] = None
    rampup: int = 101
    # True reproduces the released code's rampup gate, a frozen constant 0
    # (the weak losses never receive gradient); False turns the gate on at
    # epoch >= rampup, as the paper intends
    compat_frozen_gate: bool = False


@dataclasses.dataclass(frozen=True)
class LabelPropConfig:
    """Probabilistic label propagation (Util/ProbLabelPropagation.py)."""

    alpha: float = 1.0
    beta: float = 1.0
    xyz_bandwidth: float = 1e3
    rgb_bandwidth: float = 1e1
    ridge: float = 1e-5
    solver: str = "cg"  # ported: "solve", "cg", "cg_matfree" (sharded: not yet)
    cg_iters: int = 50
    cg_tol: float = 1e-5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 6  # unique samples; Full style feeds 2x (Siamese pairs)
    epochs: int = 201
    rampup: int = 101
    style: str = "Full"  # "Plain" | "Full" (Full runs label propagation)
    label_fraction: float = 0.1  # -m flag
    eval_every: int = 5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    dataset: str = "ShapeNet"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    weaksup: WeakSupConfig = dataclasses.field(default_factory=WeakSupConfig)
    labelprop: LabelPropConfig = dataclasses.field(default_factory=LabelPropConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def shapenet_config(**overrides) -> ExperimentConfig:
    """The ShapeNet preset (train_ShapeNet.py defaults)."""
    model = ModelConfig(num_points=2048, in_channels=3, num_classes=50, k=20,
                        knn_channels=None, use_transform_net=True,
                        num_categories=16, head_channels=(256, 256, 128),
                        head_keep_prob=(0.6, 0.6, None))
    weaksup = WeakSupConfig(siamese_weight=1.0, smooth_channels=None)
    train = TrainConfig(batch_size=6, style="Full", label_fraction=0.1)
    cfg = ExperimentConfig(dataset="ShapeNet", model=model, weaksup=weaksup,
                           train=train)
    return dataclasses.replace(cfg, **overrides)


def s3dis_config(**overrides) -> ExperimentConfig:
    """The S3DIS preset (train_S3DIS.py defaults): 9 input channels, the kNN
    graph on the normalized xyz 6:9, no transform net or category branch,
    head 512/256 with the fixed BN decay, Siamese weight 10, smoothness on
    xyzrgb 0:6."""
    model = ModelConfig(num_points=4096, in_channels=9, num_classes=13, k=20,
                        knn_channels=(6, 9), use_transform_net=False,
                        num_categories=0, head_channels=(512, 256),
                        head_keep_prob=(None, 0.7), head_bn_fixed_decay=0.9)
    weaksup = WeakSupConfig(siamese_weight=10.0, smooth_channels=(0, 6))
    train = TrainConfig(batch_size=3, style="Plain", label_fraction=0.1)
    cfg = ExperimentConfig(dataset="S3DIS", model=model, weaksup=weaksup,
                           train=train)
    return dataclasses.replace(cfg, **overrides)
