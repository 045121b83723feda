"""Float32 arithmetic rounded as the compiled reference rounds it.

The JAX reference runs compiled (jit) on the CPU, where XLA rewrites some
expressions and its math calls come from the host's C library. Where a
floor, a threshold or a ranking of the result decides something (a voxel,
a ring, a nearest neighbour), the port computes the same float32 value:

- `inv_f32`: XLA folds `x / c` for a constant c into `x * (1 / c)`;
- `cell_of`: a floor of `x / c` for a constant c, so folded;
- `fma_f32`, `sum3_sq`, `sq_dist`: XLA contracts a multiply feeding an add
  into one fused multiply-add, so a 3-term squared norm or dot product is
  a chain of them. Emulated in float64: the product of two float32 values
  is exact there, and where the float64 sum lands on a float32 tie its
  rounding error (two-sum) breaks the tie, so the result is the fused
  operation's single rounding (`sum3_sq` and `sq_dist` find those ties by
  their bits and fix only them);
- `atan2`: XLA calls the C library's atan2f, which is glibc's float
  atan2f (fdlibm's argument reduction and polynomial in float32, not
  correctly rounded), reproduced here op by op;
- `sqrt`: the correctly rounded square root, which XLA and the card give
  and PyTorch's CPU `torch.sqrt` does not always give.

Every function is elementwise torch arithmetic that rounds the same on
the CPU and on the card (no BLAS, no device math library). `sq_dist` and
`atan2` are also the plain versions of the CUDA kernels in
ops/kernels/f32ops.py, which the port calls.
"""

from __future__ import annotations

import numpy as np
import torch


def inv_f32(c: float) -> float:
    """1 / c rounded to float32: `x * inv_f32(c)` is the reference's
    `x / c` for a constant c (not a division when c is not a power of two,
    e.g. 0.2, 0.4 or 0.8 m voxels)."""
    return float(np.float32(1.0) / np.float32(c))


def cell_of(x: torch.Tensor, c: float) -> torch.Tensor:
    """The reference's floor(x / c) for a constant cell or voxel size c, as
    int32: floor(x * inv_f32(c))."""
    return torch.floor(x * inv_f32(c)).to(torch.int32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root. PyTorch's CPU
    `torch.sqrt` misrounds some float32 inputs by an ulp (665 of 100,000
    uniform in [0.5, 4] with torch 2.13 on x86-64; sqrt(1.0216780) gives
    1.0107808 for 1.0107809); the card's `torch.sqrt` and the kernels'
    `__fsqrt_rn` round correctly. The float64 root rounded once to float32
    is the correctly rounded one (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _f64(v):
    """A tensor in float64, or a Python number as its float32 value."""
    return v.double() if isinstance(v, torch.Tensor) else float(np.float32(v))


def _round_sum(p, c, s) -> torch.Tensor:
    """The float32 rounding of the exact sum of float64 values p and c,
    given s, their sum rounded to float64. Rounding s to float32 is that
    rounding unless s lands on a float32 tie the exact sum is not on;
    there the sum's rounding error (Knuth's two-sum) breaks the tie."""
    r = s.float()
    inf = torch.full_like(r, torch.inf)
    other = torch.nextafter(r, torch.where(s > r.double(), inf, -inf))  # s lies between
    tie = s == (r.double() + other.double()) * 0.5
    pv = s - c
    err = (p - pv) + (c - (s - pv))
    return torch.where(tie & (err != 0) & ((other > r) == (err > 0)), other, r)


def fma_f32(a, b, c) -> torch.Tensor:
    """a * b + c with a single float32 rounding, a a float32 tensor; b and c
    may be Python numbers, taken as float32 constants (the float64 product
    is exact). Elementwise, so it runs under vmap and never reads the card."""
    p, c = a.double() * _f64(b), _f64(c)
    return _round_sum(p, c, p + c)


def _fma_f32_rare_ties(a, b, c) -> torch.Tensor:
    """fma_f32 on large float32 tensors, cheaper: the float64 sum's bits
    show where it is a float32 tie (low 29 bits 1 followed by 28 zeros;
    rare), and only there the tie is broken. The gather makes it unfit for
    vmap and a host read on the card, so only the plain versions below,
    which the custom ops run on physical tensors, call it."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    r = s.float()
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(tie.any()):
        if s.dim() == 0:  # a scalar has no index to gather at
            return _round_sum(p, c, s)
        at = tie.nonzero(as_tuple=True)
        r[at] = _round_sum(p.expand_as(s)[at], c.expand_as(s)[at], s[at])
    return r


def sum3_sq(v: torch.Tensor) -> torch.Tensor:
    """Squared norm over the last axis of 3, rounded like the reference's
    compiled reduction: a chain of fused multiply-adds. The plain version
    of kernels.f32ops.sum3_sq."""
    v0, v1, v2 = v.unbind(-1)
    return _fma_f32_rare_ties(v2, v2, _fma_f32_rare_ties(v1, v1, v0 * v0))


def sq_dist(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[Q, 3] x [T, 3] -> [Q, T] squared distances in the reference's
    ranking form |q|^2 + |t|^2 - 2 q.t, rounded step by step as its compiled
    CPU program rounds them: each squared norm and each dot product a chain
    of fused multiply-adds over x, y, z, then (|q|^2 + |t|^2) - 2 q.t. (A
    BLAS or cuBLAS matmul sums the dot in its own order, and near-ties then
    rank differently.) The plain version of kernels.f32ops.sq_dist."""
    q, t = query[:, None, :], target[None, :, :]
    fma = _fma_f32_rare_ties
    cross = fma(q[..., 2], t[..., 2], fma(q[..., 1], t[..., 1], q[..., 0] * t[..., 0]))
    return (sum3_sq(query)[:, None] + sum3_sq(target)[None, :]) - 2.0 * cross


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# glibc's float atan constants (sysdeps/ieee754/flt-32, from fdlibm), as
# stored in its libm: atan(0.5), atan(1), atan(1.5), atan(inf) in a high
# and a low part, and the odd polynomial's coefficients.
_ATAN_HI = tuple(_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA))
_ATAN_LO = tuple(_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168))
_AT = tuple(_f32(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E,
                              0xBD9D8795, 0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221,
                              0x3C8569D7))
_PI, _PI_LO, _PI_O_2 = _f32(0x40490FDB), _f32(0xB3BBBD2E), _f32(0x3FC90FDB)


def _atan_abs(x: torch.Tensor) -> torch.Tensor:
    """glibc's atanf on x >= 0 (float32): argument reduction to one of
    four intervals, then the polynomial in z = x^2, each step one float32
    rounding."""
    # Reduced arguments of the intervals [7/16, 11/16), [11/16, 19/16),
    # [19/16, 39/16) and beyond; below 7/16 the argument is x itself.
    r = [(2.0 * x - 1.0) / (2.0 + x), (x - 1.0) / (x + 1.0),
         (x - 1.5) / (1.0 + 1.5 * x), -1.0 / x]
    band = ((x >= 0.4375).to(torch.int64) + (x >= 0.6875) + (x >= 1.1875) + (x >= 2.4375)) - 1
    xr = x
    for k in range(4):
        xr = torch.where(band == k, r[k], xr)
    z = xr * xr
    w = z * z
    p1 = w * _AT[10] + _AT[8]
    for c in (_AT[6], _AT[4], _AT[2], _AT[0]):
        p1 = p1 * w + c
    p2 = w * _AT[9] + _AT[7]
    for c in (_AT[5], _AT[3], _AT[1]):
        p2 = p2 * w + c
    t = xr * (z * p1 + w * p2)
    out = xr - t  # band -1: |x| < 7/16
    for k in range(4):
        out = torch.where(band == k, _ATAN_HI[k] - ((t - _ATAN_LO[k]) - xr), out)
    out = torch.where(x < 2.0 ** -29, x, out)
    return torch.where(x >= 2.0 ** 25, _ATAN_HI[3] + _ATAN_LO[3], out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's atan2f(y, x) on float32 tensors, bit for bit, for finite
    inputs whose ratio |y / x| lies within 2^-60 .. 2^60 or has a zero. The
    plain version of kernels.f32ops.atan2."""
    z = _atan_abs(torch.abs(y / x))
    neg_y, neg_x = torch.signbit(y), torch.signbit(x)
    out = torch.where(neg_y, -z, z)
    left = torch.where(neg_y, (z - _PI_LO) - _PI, _PI - (z - _PI_LO))
    out = torch.where(neg_x, left, out)
    axis = torch.where(neg_y, -_PI_O_2, _PI_O_2)  # x == 0
    out = torch.where(x == 0, axis, out)
    on_x = torch.where(neg_x, torch.where(neg_y, -_PI, _PI), y)  # y == 0
    return torch.where(y == 0, on_x, out)
