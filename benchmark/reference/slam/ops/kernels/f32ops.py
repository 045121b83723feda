"""Float32 arithmetic rounded as the compiled reference rounds it, the
program's csrc/f32ops.cu kernels as their plain versions (ops/f32.py):
the 2-NN squared distances, 3-vector squared norms and atan2."""


import torch
from torch import Tensor

from reference.slam.ops import f32


def sq_dist(query: Tensor, target: Tensor) -> Tensor:
    """[Q, 3] x [T, 3] -> [Q, T] squared distances |q|^2 + |t|^2 - 2 q.t,
    rounded as the reference's compiled program rounds them (f32.sq_dist)."""
    return f32.sq_dist(query, target)


def sum3_sq(v: Tensor) -> Tensor:
    """Squared norms over the last axis of 3, [..., 3] -> [...], rounded as
    the reference's compiled reduction (f32.sum3_sq)."""
    return f32.sum3_sq(v)


def atan2(y: Tensor, x: Tensor) -> Tensor:
    """glibc's atan2f(y, x), elementwise over float32 tensors of one shape
    (f32.atan2)."""
    return f32.atan2(y, x)


