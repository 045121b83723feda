"""Inputs of odometry's 2-NN sweep (ops/kernels/sweep_top2.py) for the
tests, numpy only: the CPU tests hold the op's plain version to the former
composition on them, the card tests the kernel to the plain version.

`sweep_case(name, seed)` returns a dict of query [Q, 3], target [T, 3],
mask [T] (bool), ring [T] (float32), nearby and the tiles (tile_any,
tile_ring) as the odometry asks for them (the op fits them to T).
"""

import numpy as np

NEARBY = 2.5  # the presets' nearby_scan

# name: (Q, T, tile_any, tile_ring)
SHAPES = {
    "surf": (1536, 32768, 8192, 4096),  # the less-flat sweep at the presets' capacities
    "corner": (768, 4096, 8192, 4096),  # the less-sharp sweep
    "odd": (192, 3 * 1024, 8192, 4096),  # T no multiple of either tile: tiles of 1024
    "ties": (96, 512, 128, 64),  # integer points: duplicates, equal distances, ring bounds
    "masked_tiles": (64, 512, 128, 64),  # a tile all masked, a tile with one target passing
    "empty": (48, 256, 8192, 4096),  # every target masked
}
SMALL = ("odd", "ties", "masked_tiles", "empty")


def sweep_case(name: str, seed: int = 0) -> dict:
    Q, T, tile_any, tile_ring = SHAPES[name]
    rng = np.random.default_rng(seed)
    if name == "ties":
        target = rng.integers(-3, 4, (T, 3)).astype(np.float32)
        target[T // 2:] = target[: T // 2]  # each point twice, half a cloud apart
        query = (rng.integers(-6, 7, (Q, 3)) / 2).astype(np.float32)
        ring = (rng.integers(0, 8, T) / 2).astype(np.float32)  # |ring differences| hit 0.5 and 2.5
        mask = rng.uniform(size=T) < 0.8
    else:
        # a scan's feature cloud: valid rows first, as the feature compaction leaves them
        target = np.concatenate([rng.uniform(-40, 40, (T, 2)), rng.uniform(-3, 3, (T, 1))],
                                axis=1).astype(np.float32)
        ring = rng.integers(0, 64, T).astype(np.float32)
        mask = np.arange(T) < int(0.7 * T)
        mask &= rng.uniform(size=T) < 0.95
        query = (target[rng.integers(0, T, Q)] + rng.normal(0, 0.3, (Q, 3))).astype(np.float32)
    if name == "masked_tiles":
        mask[:] = True
        mask[128:256] = False  # any-tile 1 and ring tiles 2-3 all masked
        mask[256:320] = False
        mask[300] = True  # ring tile 4 with one target passing
        mask[384:512] = False
        mask[400] = True  # any-tile 3 with one target passing
    if name == "empty":
        mask[:] = False
    return dict(query=query, target=target, mask=mask, ring=ring, nearby=NEARBY,
                tile_any=tile_any, tile_ring=tile_ring)
