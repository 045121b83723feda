"""Live headless observability: an auto-refreshing trajectory view.

The reference streams its state live over ROS topics — `/aft_pgo_path`,
`/odom_path`, the loop-pair clouds (`/loop_scan_local`,
`/loop_submap_local`) — and watches them in rviz
(src/laserPosegraphOptimization.cpp:497-515,902-908). This framework is
headless: the equivalent is a single self-contained `live.html` in the
session directory, rewritten on every artifact-flush cycle (~1 Hz, the
reference's PGO cadence) and auto-refreshed by the browser. Dependency-free
inline SVG — regenerating it costs microseconds on the host, nothing on the
device (it reuses the pose tables `flush_artifacts` already fetched).

Two series — the PGO-optimized path and the raw odometry path — drawn in a
colorblind-safe blue/orange pair with a legend; loop-closure edges are
relations, not a series: thin dashed gray chords between the optimized
poses they join, each carrying a native SVG tooltip naming the pair.
"""

from __future__ import annotations

import html as html_mod
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np

# Categorical pair (fixed assignment, identity never carried by color
# alone — the legend names both): blue = optimized, orange = odometry.
_C_OPT = "#2563eb"
_C_ODOM = "#e8833a"
_C_LOOP = "#9ca3af"
_INK = "#374151"
_MUTED = "#6b7280"

_W, _H, _PAD = 760, 560, 44


def _path_points(tr: np.ndarray, sx, sy) -> str:
    return " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in tr)


def render_live_svg(
    opt_xy: np.ndarray,  # [N, 2] optimized keyframe positions (x, y)
    odom_xy: np.ndarray,  # [N, 2] odometry keyframe positions
    loop_pairs: Sequence[Tuple[int, int]],
    stats: str,
) -> str:
    """One top-down SVG of both trajectories + loop chords (equal aspect)."""
    pts = [a for a in (opt_xy, odom_xy) if len(a)]
    if not pts:
        mins = np.zeros(2)
        maxs = np.ones(2)
    else:
        allp = np.concatenate(pts, axis=0)
        mins, maxs = allp.min(axis=0), allp.max(axis=0)
    span = float(max(maxs[0] - mins[0], maxs[1] - mins[1], 1e-3))
    cx, cy = (mins + maxs) / 2.0
    half = span / 2.0 * 1.05
    inner_w, inner_h = _W - 2 * _PAD, _H - 2 * _PAD
    s = min(inner_w, inner_h) / (2 * half)

    def sx(x):
        return _PAD + inner_w / 2 + (x - cx) * s

    def sy(y):  # +y up
        return _PAD + inner_h / 2 - (y - cy) * s

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{_W}" height="{_H}" '
        f'viewBox="0 0 {_W} {_H}" font-family="system-ui,sans-serif">',
        f'<rect width="{_W}" height="{_H}" fill="#ffffff"/>',
    ]
    # recessive scale bar (a top-down map has no meaningful axes; the
    # scale bar replaces them). Skipped while the trajectory span is
    # degenerate (first keyframe / coincident poses): span clamps to 1e-3
    # there, so the floored 0.01 m bar would render thousands of px wide
    # and overflow the canvas (ADVICE r4).
    bar_m = 10 ** int(np.floor(np.log10(max(span / 4.0, 1e-2))))
    bx0, by = _PAD, _H - 16
    if bar_m * s <= inner_w:
        parts.append(
            f'<line x1="{bx0}" y1="{by}" x2="{bx0 + bar_m * s:.1f}" y2="{by}" '
            f'stroke="{_MUTED}" stroke-width="2"/>'
            f'<text x="{bx0 + bar_m * s / 2:.1f}" y="{by - 6}" font-size="11" '
            f'fill="{_MUTED}" text-anchor="middle">{bar_m:g} m</text>'
        )
    # loop chords under the paths
    for i, j in loop_pairs:
        if i < len(opt_xy) and j < len(opt_xy):
            parts.append(
                f'<line x1="{sx(opt_xy[i, 0]):.1f}" y1="{sy(opt_xy[i, 1]):.1f}" '
                f'x2="{sx(opt_xy[j, 0]):.1f}" y2="{sy(opt_xy[j, 1]):.1f}" '
                f'stroke="{_C_LOOP}" stroke-width="1" stroke-dasharray="4 3">'
                f"<title>loop {i} &#8596; {j}</title></line>"
            )
    for xy, color in ((odom_xy, _C_ODOM), (opt_xy, _C_OPT)):
        if len(xy) >= 2:
            parts.append(
                f'<polyline points="{_path_points(xy, sx, sy)}" fill="none" '
                f'stroke="{color}" stroke-width="2" stroke-linejoin="round"/>'
            )
    if len(opt_xy):
        parts.append(
            f'<circle cx="{sx(opt_xy[-1, 0]):.1f}" cy="{sy(opt_xy[-1, 1]):.1f}" '
            f'r="5" fill="{_C_OPT}" stroke="#ffffff" stroke-width="2">'
            f"<title>current pose</title></circle>"
        )
    # legend (two series -> always present; text in ink, not series color)
    lx, ly = _W - 190, _PAD - 22
    for k, (name, color) in enumerate(
        (("optimized (PGO)", _C_OPT), ("odometry", _C_ODOM))
    ):
        parts.append(
            f'<line x1="{lx}" y1="{ly + 16 * k}" x2="{lx + 18}" '
            f'y2="{ly + 16 * k}" stroke="{color}" stroke-width="3"/>'
            f'<text x="{lx + 24}" y="{ly + 16 * k + 4}" font-size="12" '
            f'fill="{_INK}">{name}</text>'
        )
    parts.append(
        f'<text x="{_PAD}" y="{_PAD - 18}" font-size="12" fill="{_INK}">'
        f"{stats}</text>"
    )
    parts.append("</svg>")
    return "".join(parts)


def write_live_view(
    directory: str,
    opt_poses: np.ndarray,  # [N, 4, 4] (pose_to_matrix output)
    odom_poses: np.ndarray,  # [N, 4, 4]
    loop_pairs: Sequence[Tuple[int, int]],
    refresh_s: float = 1.0,
    extra: Optional[str] = None,
) -> str:
    """Write `<directory>/live.html` (atomic rename so a refreshing browser
    never sees a torn file). Returns the path."""
    opt_xy = np.asarray(opt_poses, np.float64).reshape(-1, 4, 4)[:, :2, 3]
    odom_xy = np.asarray(odom_poses, np.float64).reshape(-1, 4, 4)[:, :2, 3]
    stats = (
        f"keyframes {len(opt_xy)} &#183; loop closures {len(loop_pairs)}"
        f" &#183; {time.strftime('%H:%M:%S')}"
    )
    if extra:
        # escape: `extra` is caller text interpolated into markup (ADVICE r4)
        stats += f" &#183; {html_mod.escape(extra)}"
    svg = render_live_svg(opt_xy, odom_xy, loop_pairs, stats)
    html = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<meta http-equiv='refresh' content='{refresh_s:g}'>"
        "<title>scaloam-tpu live</title></head>"
        "<body style='margin:16px;background:#ffffff'>"
        f"{svg}</body></html>"
    )
    path = os.path.join(directory, "live.html")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)
    return path
