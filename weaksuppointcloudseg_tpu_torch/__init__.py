"""weaksuppointcloudseg_tpu_torch — the PyTorch/CUDA port of weaksuppointcloudseg_tpu.

The JAX package next to this one is the reference: every module here has its
counterpart at the same relative path there, and the tests in
``tests/test_torch_*.py`` hold the two against each other on the CPU.

Ported so far: training and test of ShapeNet and S3DIS in f32 and bf16,
through the fused EdgeConv blocks (stages of any number of convs) and the
fused smoothness loss or, without the fused kNN (``use_fused_knn=False``),
through the plain composition; static-graph mode; label propagation with
the "cg", "solve" and "cg_matfree" solvers and the whole-room LP; the
ShapeNet test loop's one-batch lag; the DGCNN classifier on every route.
All eighteen of the JAX package's Pallas kernels have a hand-written
Hopper counterpart (``ops/csrc/*.cu``); data parallelism is still to port
(ROADMAP.md).

This package imports neither JAX nor the JAX package: the configs, the
ShapeNet and S3DIS readers, the augmentation and label sampling, and the
metrics it needs are its own copies (``configs``, ``data/``,
``metrics/iou.py``), held equal to the originals by
tests/test_torch_data.py, tests/test_torch_train.py and
tests/test_torch_s3dis.py.
"""

import torch

# Label propagation feeds f32 Grams into exp(-1e3 * d^2): TF32's ~1e-3
# relative error there turns affinities into noise (the reference's
# neighbors.py:35-40 precision note), and f32 training is held to the
# reference's f32 gradients. Full f32 everywhere in this package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
