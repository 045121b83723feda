"""How far the port's pose graph lies from the JAX reference on the CPU, in
the cases of the parity tests: the largest quaternion and translation
differences of `tests/test_torch_posegraph.py`'s optimise scenarios and
captured graph, and the relative errors of `tests/test_torch_backend.py`'s
blocktri solves against the reference's and a float64 dense solve. The
tests hold these under their tolerances; this prints them, so that two
trees can be compared (a change of the solve's rounding moves them).

Run from the repository root (JAX on the CPU; ~3-4 min):

    JAX_PLATFORMS=cpu python tools/torch_posegraph_parity.py [--root DIR]

--root DIR imports the port and its tests from another checkout. Prints
one JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv) -> int:
    root = HERE
    if argv[:1] == ["--root"] and len(argv) == 2:
        root = os.path.abspath(argv[1])
    elif argv:
        print("usage: torch_posegraph_parity.py [--root DIR]", file=sys.stderr)
        return 2
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    torch.set_num_threads(2)
    import test_torch_backend as TB
    import test_torch_posegraph as T
    from scaloam_tpu import config as jconfig
    from scaloam_tpu.models import posegraph as jpg
    from scaloam_tpu_torch import config as tconfig, convert
    from scaloam_tpu_torch.models import posegraph as tpg

    def gaps(to, jo, n):
        q, jq = to.poses.quat.numpy()[:n], np.asarray(jo.poses.quat)[:n]
        q = q * np.sign(np.sum(q * jq, -1, keepdims=True))
        dt = to.poses.trans.numpy()[:n] - np.asarray(jo.poses.trans)[:n]
        return {"dq": float(np.abs(q - jq).max()), "dt_m": float(np.abs(dt).max())}

    out = {"root": root}
    for sc in ("fixed_point", "loop_chain_cg", "loop_woodbury", "gps", "robust_outlier"):
        rng = np.random.default_rng(0)  # the test's scenario, as it builds it
        n = {"fixed_point": 20, "gps": 40, "robust_outlier": 50}.get(sc, 60)
        q, t = T._circle(n)
        cfg, loops, gps, iters = T.CFG, [], None, 64
        if sc == "fixed_point":
            oq, ot = q, t
        elif sc == "gps":
            oq, ot = q, t + np.outer(0.05 * np.arange(n), [0, 0, 1]).astype(np.float32)
            gps, cfg, iters = np.zeros(n, np.float32), T.CHAIN, 128
        elif sc == "robust_outlier":
            oq, ot = T._drift(q, t, rng, 0.001, 0.01)
            bad_q = np.asarray(T.jse3.exp_so3(jnp.asarray([0, 0, 2.0], jnp.float32)))
            loops = [(n - 1, 0, bad_q, np.array([30.0, -20.0, 5.0], np.float32))]
        else:
            oq, ot = T._drift(q, t, rng)
            loops = T._loops(q, t, n, 5)
            if sc == "loop_chain_cg":
                cfg, iters = T.CHAIN, 128
            else:
                cfg = dataclasses.replace(T.CFG, solver="woodbury", wb_min_nodes=1,
                                          wb_cg_iters=8, **T.LOOPY)
        jg, tg = T._build_both(cfg, oq, ot, loops, gps)
        jo, to = T._optimize_both(cfg, jg, tg, iters)
        out[f"optimize {sc}"] = gaps(to, jo, n)
        print(sc, out[f"optimize {sc}"], file=sys.stderr, flush=True)
    z = np.load(os.path.join(root, "tests", "data_pgo_regression_graph.npz"))
    tree = {"poses": {"quat": z["poses_q"], "trans": z["poses_t"]},
            "odom_poses": {"quat": z["odom_q"], "trans": z["odom_t"]},
            "n_nodes": z["n_nodes"], "odom_rel": {"quat": z["rel_q"], "trans": z["rel_t"]},
            "loop_i": z["loop_i"], "loop_j": z["loop_j"],
            "loop_rel": {"quat": z["loopr_q"], "trans": z["loopr_t"]},
            "n_loops": z["n_loops"], "gps_z": z["gps_z"], "gps_valid": z["gps_valid"],
            "chain_break": z["chain_break"]}
    jg = jpg.PoseGraph(**{k: (T.JPose(jnp.asarray(v["quat"]), jnp.asarray(v["trans"]))
                              if isinstance(v, dict) else jnp.asarray(v))
                          for k, v in tree.items()})
    tg = convert.graph_from_numpy(tree, T.CPU)
    out["optimize captured graph"] = gaps(tpg.optimize(tg, tconfig.kitti_hdl64().pgo),
                                          jpg.optimize(jg, jconfig.kitti_hdl64().pgo),
                                          int(z["n_nodes"]))
    for n, r in ((1, None), (13, None), (32, None), (21, 5)):
        D, B, b = TB._chain_system(np.random.default_rng(n), n, r)
        want = np.asarray(TB.jbt.solve(TB.jbt.factor(jnp.asarray(D), jnp.asarray(B), reg=0.0),
                                       jnp.asarray(b)))
        got = TB.tbt.solve(TB.tbt.factor(TB._t(D), TB._t(B), reg=0.0), TB._t(b)).numpy()
        x = np.linalg.solve(TB._dense(D.astype(np.float64), B.astype(np.float64)),
                            b.reshape(6 * n, -1).astype(np.float64)).reshape(b.shape)
        scale = np.abs(x).max()
        out[f"blocktri {n} x {r or 1}"] = {"rel_to_reference": float(np.abs(got - want).max() / scale),
                                          "rel_to_float64": float(np.abs(got - x).max() / scale)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
