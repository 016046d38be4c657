"""weaksuppointcloudseg_tpu_torch — the PyTorch/CUDA port of weaksuppointcloudseg_tpu.

The JAX package next to this one is the reference: every module here has its
counterpart at the same relative path there, and the tests in
``tests/test_torch_*.py`` hold the two against each other on the CPU.

Ported so far: the ShapeNet test path (eval forward in bf16 with the fused
EdgeConv blocks, or in f32, then label propagation), ShapeNet Full-style
training at the default f32 precision, and Plain- and Full-style training
of ShapeNet and S3DIS in bf16 through the fused blocks and the fused
smoothness loss, with thirteen hand-written Hopper kernels
(``ops/csrc/*.cu``). The S3DIS test path, room LP and the other solvers
are still to port (ROADMAP.md).

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
