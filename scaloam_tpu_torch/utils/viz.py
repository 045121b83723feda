"""Trajectory / map visualization, the rviz_cfg equivalent (a copy of
scaloam_tpu/utils/viz.py).

The reference ships an rviz layout (rviz_cfg/aloam_velodyne.rviz) showing
paths, maps and loop pairs. Headless equivalent: render trajectories and
map clouds to PNG with matplotlib (if available) and/or a self-contained
HTML viewer (three.js-free, plain canvas point splatting) for quick looks.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def plot_trajectories(
    out_path: str,
    trajectories: dict,
    loops: Optional[Sequence] = None,
    title: str = "trajectory",
) -> bool:
    """Top-down XY plot of {name: [N,3] or [N,4,4]} trajectories.
    Returns False when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False

    fig, ax = plt.subplots(figsize=(8, 8))
    pts = {}
    for name, tr in trajectories.items():
        tr = np.asarray(tr)
        p = tr[:, :3, 3] if tr.ndim == 3 else tr
        pts[name] = p
        ax.plot(p[:, 0], p[:, 1], label=name, linewidth=1.2)
    if loops:
        any_tr = next(iter(pts.values()))
        for (i, j) in loops:
            if i < len(any_tr) and j < len(any_tr):
                ax.plot(
                    [any_tr[i, 0], any_tr[j, 0]],
                    [any_tr[i, 1], any_tr[j, 1]],
                    "r--", linewidth=0.8, alpha=0.7,
                )
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def export_map_html(out_path: str, points: np.ndarray, poses: Optional[np.ndarray] = None,
                    max_points: int = 200000) -> None:
    """Self-contained HTML point-cloud viewer (orthographic top-down with
    height coloring; drag to pan, wheel to zoom)."""
    pts = np.asarray(points, np.float32)
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[sel]
    traj = None
    if poses is not None:
        poses = np.asarray(poses)
        traj = (poses[:, :3, 3] if poses.ndim == 3 else poses)[:, :2].tolist()
    payload = {
        "pts": np.round(pts, 2).tolist(),
        "traj": traj,
    }
    html = """<!DOCTYPE html><html><head><meta charset="utf-8">
<style>body{margin:0;background:#111}canvas{display:block}</style></head>
<body><canvas id="c"></canvas><script>
const D=__DATA__;const cv=document.getElementById('c');const ctx=cv.getContext('2d');
let scale=4,ox=0,oy=0,drag=null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw()}
function draw(){ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
const zs=D.pts.map(p=>p[2]);const zmin=Math.min(...zs),zmax=Math.max(...zs);
for(const p of D.pts){const x=cv.width/2+(p[0]+ox)*scale,y=cv.height/2-(p[1]+oy)*scale;
const t=(p[2]-zmin)/(zmax-zmin+1e-6);ctx.fillStyle=`hsl(${240-200*t},80%,55%)`;
ctx.fillRect(x,y,1.5,1.5);}
if(D.traj){ctx.strokeStyle='#fff';ctx.lineWidth=1.5;ctx.beginPath();
D.traj.forEach((p,i)=>{const x=cv.width/2+(p[0]+ox)*scale,y=cv.height/2-(p[1]+oy)*scale;
i?ctx.lineTo(x,y):ctx.moveTo(x,y)});ctx.stroke();}}
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
cv.onmousemove=e=>{if(drag){ox+=(e.clientX-drag[0])/scale;oy-=(e.clientY-drag[1])/scale;
drag=[e.clientX,e.clientY];draw()}};
cv.onmouseup=()=>drag=null;
cv.onwheel=e=>{scale*=e.deltaY<0?1.2:1/1.2;draw();e.preventDefault()};
addEventListener('resize',resize);resize();
</script></body></html>"""
    with open(out_path, "w") as f:
        f.write(html.replace("__DATA__", json.dumps(payload)))
