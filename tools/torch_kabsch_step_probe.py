"""Where ICP's plain Kabsch step (scaloam_tpu_torch/ops/kernels/kabsch.py
`kabsch_step_plain`) rounds otherwise on the CPU than on the card.

The step's kernel (csrc/kabsch_step.cu) equals the plain version run on the
card bit for bit; this probe runs the plain version on the same inputs on
the CPU and on the card, records every ATen operation of both runs (a
TorchDispatchMode) and lists the operations whose inputs are bit-equal on
the two devices and whose outputs are not: the operations that round
otherwise. It also prints how far the kernel, the card's plain version
and the CPU's plain version are from each other.

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/torch_kabsch_step_probe.py

Prints the card's name and power limit, then one JSON line a case.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from scaloam_tpu_torch.ops.kernels import kabsch  # noqa: E402

# (batch rows, points, mask_q, share of weights kept, seed): the card
# test's inputs (tests/test_torch_cuda.py `_step_inputs`, seed S + B)
CASES = ((1, 100, False, 0.9, 101), (2, 2048, False, 0.7, 2050), (1, 8192, True, 0.7, 8193))


def step_inputs(B, S, seed, keep):
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(S, 3)) * 10).astype(np.float32)
    tgt = np.stack([src + rng.normal(size=3) + rng.normal(size=(S, 3)) * 0.05 for _ in range(B)])
    w = (rng.uniform(size=(B, S)) < keep).astype(np.float32)
    return torch.from_numpy(src), torch.from_numpy(w), torch.from_numpy(tgt.astype(np.float32))


class Recorder(TorchDispatchMode):
    """Every ATen operation: (name, non-tensor arguments, tensor inputs and
    outputs copied to the host)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = pytree.tree_leaves((args, kwargs or {}))
        host = lambda xs: [x.detach().cpu().clone() for x in xs if isinstance(x, torch.Tensor)]
        self.ops.append((str(func), [x for x in leaves if not isinstance(x, torch.Tensor)],
                         host(leaves), host(pytree.tree_leaves(out))))
        return out


def bits(x):
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same(xs, ys):
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(xs, ys))


def record(src, w, tgt, mask_q, dev):
    rec = Recorder()
    args = (src[None].to(dev), w.to(dev), tgt.to(dev))
    with rec:
        q, t = kabsch.kabsch_step_plain(*args, mask_q)
    return rec.ops, q.cpu(), t.cpu()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kabsch_step_probe: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    for B, S, mask_q, keep, seed in CASES:
        src, w, tgt = step_inputs(B, S, seed, keep)
        cpu_ops, cq, ct = record(src, w, tgt, mask_q, "cpu")
        dev_ops, dq, dt = record(src, w, tgt, mask_q, dev)
        got = kabsch.kabsch_step(src.to(dev), w.to(dev), tgt.to(dev), mask_q)
        kq, kt = got.quat.cpu(), got.trans.cpu()
        rounds_otherwise, first_diff = [], None
        for i, ((name, scalars, ins_c, outs_c), (name_d, _, ins_d, outs_d)) in enumerate(
                zip(cpu_ops, dev_ops)):
            if name != name_d:
                raise AssertionError(f"op {i}: {name} on the CPU, {name_d} on the card")
            if same(ins_c, ins_d) and not same(outs_c, outs_d):
                diff = max(float((a.double() - b.double()).abs().max())
                           for a, b in zip(outs_c, outs_d) if a.is_floating_point())
                n = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(outs_c, outs_d))
                rounds_otherwise.append(dict(op=i, name=name, scalars=repr(scalars)[:120],
                                             shapes=[list(x.shape) for x in ins_c],
                                             entries_differing=n, max_abs_diff=diff))
            if first_diff is None and not same(outs_c, outs_d):
                first_diff = dict(op=i, name=name)
        print(json.dumps(dict(
            case=dict(B=B, S=S, mask_q=mask_q, keep=keep, seed=seed), ops=len(cpu_ops),
            kernel_equals_plain_on_card=same([kq, kt], [dq, dt]),
            kernel_equals_plain_on_cpu=same([kq, kt], [cq, ct]),
            quat_card_minus_cpu=float((dq - cq).abs().max()),
            trans_card_minus_cpu=float((dt - ct).abs().max()),
            first_differing_output=first_diff, rounds_otherwise=rounds_otherwise[:20],
            n_rounds_otherwise=len(rounds_otherwise))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
