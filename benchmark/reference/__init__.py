"""The benchmark's plain reference: DGCNN segmentation, the four weakly
supervised losses, Adam, the host assembly of a training batch, the S3DIS
block sweep and label propagation, in plain PyTorch and numpy.

Nothing here imports the program under test, JAX or the JAX package. The
reference computes in float32 with TF32 off; ``precision.py`` gives the
lower-precision control that the comparisons must reject.
"""
