"""scaloam_tpu_torch: the PyTorch/CUDA port of the SLAM system.

The JAX package `scaloam_tpu` stays the reference; this package imports
none of it. Everything runs in float32. The reference asks for full-f32
products (`Precision.HIGHEST` in ops/gn.py, ops/fit.py, ops/residuals.py),
so TF32 is switched off for matmuls and cuDNN alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
