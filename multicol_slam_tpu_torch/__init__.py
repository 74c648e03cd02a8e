"""MultiCol-SLAM in PyTorch and CUDA: the port of ``multicol_slam_tpu``.

The JAX package beside this one is the reference; every module here
keeps its counterpart's name and layout so a reader finds each twin:

  - ``ops/``      batched tensor functions: SE3/cayley, camera model, rig,
                  pyramid, FAST, ORB, Hamming matching core.
  - ``models/``   extractor, matchers, pose-only LM, the WORKING frame.
  - ``utils/``    calibration IO, synthetic renderer, numpy converters.
  - ``kernels/``  Python wrappers of the hand-written CUDA kernels.
  - ``csrc/``     the CUDA sources, built at first use with ``nvcc``.

This package imports torch and numpy only, never JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# Pose chains and sub-pixel Huber gates break under TF32 (about three
# decimal digits), so matmuls and convolutions run in full float32 —
# the same reason the JAX package forces "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
