"""A frozen copy of the plain PyTorch path of the front end under test,
the benchmark's reference: the program's features, odometry, mapping, and
keyframe gate and prep as they were at the program's commit ee9a45a, the
package name replaced. It imports nothing of the program: each hand
kernel is its plain version, called directly, and every step runs
eagerly. Everything runs in float32 with TF32 off, as the program
states."""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
