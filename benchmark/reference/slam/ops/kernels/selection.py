"""Greedy curvature feature selection, the program's kernel K1 as plain
PyTorch: a literal transcription of the Pallas kernel body
(scaloam_tpu/ops/pallas/selection.py:select_features)."""

import torch

NEG = -1e30


def select_features(curv, left_ext, right_ext, eligible, sp, ep,
                    n_sub: int, n_corner: int, n_flat: int,
                    curv_thr: float):
    """curv f32 [S, W], left/right_ext int32 [S, W], eligible bool [S, W],
    sp/ep int32 [S, n_sub]. Returns (corner_idx int32 [S, n_sub, n_corner],
    corner_ok bool, flat_idx int32 [S, n_sub, n_flat], flat_ok bool,
    labels bool [S, W]): the Pallas kernel body (selection.py:_make_kernel)
    on whole [S, W] rows at a time."""
    S, W = curv.shape
    dev = curv.device
    jj = torch.arange(W, device=dev)[None, :].expand(S, W)
    elig = eligible.bool()
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    sup = torch.zeros((S, W), dtype=torch.bool, device=dev)
    labels = torch.zeros((S, W), dtype=torch.bool, device=dev)
    ci = torch.zeros((S, n_sub, n_corner), dtype=torch.int32, device=dev)
    co = torch.zeros((S, n_sub, n_corner), dtype=torch.bool, device=dev)
    fi = torch.zeros((S, n_sub, n_flat), dtype=torch.int32, device=dev)
    fo = torch.zeros((S, n_sub, n_flat), dtype=torch.bool, device=dev)

    def pick(s, val):
        """Masked argmax in subregion s: (jstar [S], found [S], band [S, W])."""
        sub = (jj >= sp[:, s, None]) & (jj <= ep[:, s, None])
        v = torch.where(sub, val, neg)
        m = torch.amax(v, dim=1)
        found = m > neg
        is_max = (v == m[:, None]) & found[:, None]
        jstar = torch.amin(torch.where(is_max, jj, W), dim=1)
        jstar_c = torch.where(found, jstar, 0)
        onehot = jj == jstar_c[:, None]
        lext = torch.amax(torch.where(onehot, left_ext, 0), dim=1)
        rext = torch.amax(torch.where(onehot, right_ext, 0), dim=1)
        lo = torch.where(found, jstar_c - lext, -1)
        hi = torch.where(found, jstar_c + rext, -1)
        band = (jj >= lo[:, None]) & (jj <= hi[:, None])
        return jstar_c, found, band

    for p in range(n_corner):
        val = torch.where(elig & ~sup & (curv > curv_thr), curv, neg)
        for s in range(n_sub):
            jstar, found, band = pick(s, val)
            sup = sup | band
            labels = labels | ((jj == jstar[:, None]) & found[:, None])
            ci[:, s, p] = jstar.to(torch.int32)
            co[:, s, p] = found
            val = torch.where(band, neg, val)

    for p in range(n_flat):
        val = torch.where(elig & ~sup & (curv < curv_thr), -curv, neg)
        for s in range(n_sub):
            jstar, found, band = pick(s, val)
            if p < n_flat - 1:
                # the last flat pick breaks before suppressing
                sup = sup | band
                val = torch.where(band, neg, val)
            fi[:, s, p] = jstar.to(torch.int32)
            fo[:, s, p] = found
    return ci, co, fi, fo, labels
