"""Small stand-ins of the cells for the CPU: each cell's file with its
configuration's capacities and its traffic's sizes cut down, so that the
plain path runs in seconds. The widths are the cells' own on the card."""

import dataclasses

from benchlib import registry


def small_settings(settings: dict) -> dict:
    from scaloam_tpu_torch import config as pconfig

    cfg = pconfig.from_dict(settings)
    cfg = cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(cfg.features, max_sharp=768, max_less_sharp=2048,
                                     max_flat=1536, max_less_flat=8192),
        mapping=dataclasses.replace(cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8,
                                    corner_cell_cap=32, surf_cell_cap=64,
                                    max_corner_input=2048, max_surf_input=4096),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192))
    return dataclasses.asdict(cfg)


def small_cell(name: str, frames: int = 8):
    """(cell, config) of `name` at a CPU size."""
    cell = registry.workload(name)
    config = registry.config(cell["config"])
    config["settings"] = small_settings(config["settings"])
    p = cell["params"]
    p["columns"] = 256
    p.update(lap_frames=frames, warm_frames=2, trace_frames=2, samples=min(p["samples"], frames))
    if "sequences" in p:
        p.update(sequences=2, phase_frames=frames // 2)
    return cell, config
