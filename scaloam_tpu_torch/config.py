"""Typed configuration tree for the SLAM engine.

Replaces the reference's ROS param server + per-sensor launch files
(reference: launch/*.launch, param reads at src/scanRegistration.cpp:480-482,
src/laserOdometry.cpp:191, src/laserMapping.cpp:913-919,
src/laserPosegraphOptimization.cpp:874-896) and its compile-time constants
(include/scancontext/Scancontext.h:83-103, src/laserOdometry.cpp:59-66).

Every tunable of the reference is exposed here; the launch presets become
named constructors (`kitti_hdl64()`, `mulran_os1_64()`, `vlp16()`, `hdl32()`).

Shapes are static by design: the capacity fields (`max_points`,
`max_points_per_ring`, feature capacities, map capacities, keyframe
capacity) fix every device array shape so the whole pipeline compiles once.

This is the PyTorch port's own copy of `scaloam_tpu/config.py` (the port
imports nothing of the JAX package); `from_dict` rebuilds a config from
`dataclasses.asdict` output so tests can build the same config on both
sides.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Lidar geometry + ingest settings (reference: src/scanRegistration.cpp:171-218,480-482)."""

    lidar_type: str = "HDL64"  # one of VLP16 | HDL32 | HDL64 | OS1-64
    n_scans: int = 64
    minimum_range: float = 5.0  # near-range dropout (removeClosedPointCloud)
    scan_period: float = 0.1  # seconds per revolution (10 Hz)
    # Static capacities (TPU-native: padded fixed shapes).
    max_points: int = 131072  # raw scan capacity (HDL-64 ~120k pts)
    max_points_per_ring: int = 4096  # range-image width


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Curvature feature selection (reference: src/scanRegistration.cpp:269-420)."""

    curvature_window: int = 5  # 11-point curvature stencil
    n_subregions: int = 6  # per-ring azimuth subregions
    sharp_per_subregion: int = 2
    less_sharp_per_subregion: int = 20
    flat_per_subregion: int = 4
    curvature_threshold: float = 0.1  # corner if >, surf if <
    neighbor_suppress_radius: int = 5  # +-5 point suppression
    neighbor_suppress_gap_sq: float = 0.05  # stop suppression at range jumps
    less_flat_voxel_size: float = 0.2  # VoxelGrid leaf on less-flat cloud
    # Kept for parity with the JAX config only: the port never reads it
    # (selection always goes through ops/kernels/selection.py, which picks
    # kernel or plain version from the tensor's device).
    use_pallas_selection: str = "auto"  # "auto" (TPU only) | "on" | "off"
    # Feature cloud capacities (fixed shapes). sharp/flat are the exact
    # theoretical pick bounds for 64 rings (2|4 per subregion x 6 x 64);
    # less_sharp is ~1.8x the measured HDL-64 occupancy (~2.2k,
    # tools/measure_counts.py) — the odometry NN sweeps scale linearly
    # with these caps, so they are sized from need, not defensively.
    max_sharp: int = 768
    max_less_sharp: int = 4096
    max_flat: int = 1536
    max_less_flat: int = 32768


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan GN solve (reference: src/laserOdometry.cpp:59-66,278-499)."""

    outer_iterations: int = 2  # data re-association passes
    gn_iterations: int = 4  # Ceres max_num_iterations equivalent
    distance_sq_threshold: float = 25.0  # correspondence gate (m^2)
    nearby_scan: float = 2.5  # ring-distance window for 2nd/3rd points
    huber_delta: float = 0.1  # Huber loss scale
    skip_frame: int = 1  # mapping_skip_frame: republish cadence
    min_correspondences: int = 10  # degenerate guard (:488-491)
    distortion: bool = False  # DISTORTION 0 in reference (:59)
    # Fused associate+GN Pallas kernel (ops/pallas/gn_odometry.py): the
    # whole 2x4 relinearize/solve chain as ONE program instead of ~300
    # launch-bound XLA fusion groups. "auto" = TPU only (the XLA path
    # remains the CPU/test formulation); forced off under `distortion`
    # (per-point slerp needs the XLA factor code). Kept for parity with the JAX
    # config only: the port never reads it (ops/kernels/gn_odometry.py picks
    # kernel or plain version from the tensor's device).
    fused_gn_kernel: str = "auto"  # "auto" | "on" | "off"


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map GN refine vs a sliding-window voxel map.

    Reference keeps a 21x21x11 array of 50 m cubes and matches against the
    5x5x3 neighborhood (src/laserMapping.cpp:74-104,513-538). Here the
    matching map is a fixed-capacity voxel-deduplicated point set windowed
    around the pose, functionally equivalent to that 250x250x150 m gather.
    """

    line_resolution: float = 0.4  # corner map voxel size (mapping_line_resolution)
    plane_resolution: float = 0.8  # surf map voxel size (mapping_plane_resolution)
    # (The reference's 5x5x3-cube 250x150 m matching window is expressed
    # here by grid_xy/grid_z x cell_size below — the torus extent IS the
    # window.)
    outer_iterations: int = 2  # (:563)
    gn_iterations: int = 4  # (:713-721)
    huber_delta: float = 0.1
    knn: int = 5  # 5-NN for line/plane fits
    corner_nn_max_dist: float = 1.0  # corners: all 5 NN within 1 m (:612 via sqrDist[4]<1.0)
    surf_nn_max_dist_sq: float = 1.0  # surfs: sqrDist[4] < 1.0 gate (:655)
    edge_eig_ratio: float = 3.0  # lambda2 > 3*lambda1 edge test (:612)
    plane_fit_tol: float = 0.2  # |n.p + d| <= 0.2 validity (:670-680)
    min_corner_map: int = 10  # minimum map density guards (:555)
    min_surf_map: int = 50
    # Torus voxel-grid map (ops/gridmap.py): cells of `cell_size` m over a
    # [grid_xy, grid_xy, grid_z] torus — the 21x21x11 cube array, TPU-style.
    # Small cells keep the 8-cell neighbor gather tight: volume per gather
    # is 8 * cell_cap; must satisfy cell_size >= NN reach (1 m).
    cell_size: float = 2.0
    grid_xy: int = 96  # +-96 m matching window before torus wrap
    grid_z: int = 32
    corner_cell_cap: int = 8  # points per cell (0.4 m dedup in 2 m cells)
    surf_cell_cap: int = 16  # (0.8 m dedup in 2 m cells)
    max_corner_map: int = 65536  # flattened-extract capacities (viz/artifacts)
    max_surf_map: int = 131072
    # Downsampled input capacities. Measured: KITTI-density HDL-64 scans
    # produce ~1.6k corner / ~5.6k surf inputs after the 0.4/0.8 m filters
    # (A-LOAM sees the same; tools/measure_counts.py); the knn_grid gather
    # cost scales linearly with these, so they are sized with ~1.2-1.3x
    # headroom rather than defensively.
    max_corner_input: int = 2048
    max_surf_input: int = 6656


@dataclasses.dataclass(frozen=True)
class ScanContextConfig:
    """ScanContext descriptor + retrieval (reference: include/scancontext/Scancontext.h:83-103)."""

    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0  # sc_max_radius (20-40 indoor)
    lidar_height: float = 2.0  # added to z before binning
    search_ratio: float = 0.1  # column shift search window
    dist_threshold: float = 0.2  # sc_dist_thres (0.4 for KITTI)
    num_exclude_recent: int = 30
    num_candidates: int = 10  # ring-key KNN candidates.
    # Reference uses 3 via a KD-tree; dense matmul retrieval makes a larger,
    # strictly-better candidate set free. Set to 3 for exact parity.
    max_keyframes: int = 4096  # descriptor DB capacity
    max_input_points: int = 131072


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """SC loop candidate verification by ICP (reference: src/laserPosegraphOptimization.cpp:497-548)."""

    submap_half_keyframes: int = 25  # +-25 KF target submap (:500-504)
    icp_max_iterations: int = 20  # pcl default-style budget (ref caps at 100, converges earlier)
    icp_max_corr_dist: float = 150.0  # setMaxCorrespondenceDistance (:519)
    icp_crop_radius: float = 40.0  # crop source+submap to this radius around
    # the loop-local origin so the fixed-capacity submap fully covers the
    # source extent (the reference's uncapped PCL clouds don't need this)
    fitness_threshold: float = 0.3  # accept loop if fitness score < 0.3 (:531)
    max_submap_points: int = 65536
    max_source_points: int = 8192
    # Two-stage verification: coarse brute-force ICP on subsampled clouds
    # (wide basin), then grid-accelerated fine ICP (ops/icp.py
    # icp_point2point_grid) with the submap in a torus grid.
    coarse_source_points: int = 2048
    coarse_target_points: int = 8192
    # 30 iterations closes multi-meter drifted inits to <0.5 m on real
    # KAIST03 pairs (the reference lets PCL run up to 100, :521); 10 was
    # only enough for ~2 m offsets.
    coarse_iterations: int = 30
    icp_cell_size: float = 2.0
    icp_reach: float = 2.0
    icp_grid_xy: int = 64
    icp_grid_z: int = 32
    icp_cell_cap: int = 32
    # Device-side early exit once the pose update falls below this
    # (setTransformationEpsilon(1e-6), reference :522); 0 disables.
    transformation_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    """Pose-graph backend (reference: src/laserPosegraphOptimization.cpp:284-310,433-444,874-896)."""

    keyframe_meter_gap: float = 2.0
    keyframe_deg_gap: float = 10.0
    keyframe_voxel_size: float = 0.4  # downsample of stored keyframe clouds (:629-631)
    # Output capacity of the keyframe 0.4 m filter (feeds the SC
    # descriptor + the stored Scans/). Real 0.4 m keyframe clouds are
    # ~20-37k points (the reference's shipped KAIST03 Scans are ~37k);
    # capacity = cost on TPU: the compaction gathers exactly this many
    # rows per keyframe (sizing it at the raw-scan cap cost 12.6 ms of
    # the 21 ms per-keyframe backend budget, tools/micro_backend.py).
    keyframe_cloud_capacity: int = 65536
    # Noise variances, GTSAM ordering (rot x3, trans x3) (initNoises :284-310).
    prior_variance: float = 1e-12
    odom_rot_variance: float = 1e-6
    odom_trans_variance: float = 1e-4
    loop_variance: float = 0.5
    cauchy_k: float = 1.0  # robust Cauchy scale for loop + GPS factors
    gps_xy_variance: float = 1e9  # effectively ignore XY
    gps_z_variance: float = 250.0  # altitude-only GPS factor
    gps_time_tolerance: float = 0.1  # odom-GPS association window (:581-594)
    # Batch GN solver (replaces iSAM2; 1 Hz cadence per reference :791-808).
    # Warm-started solves accumulate across ticks, so few iterations per
    # tick at a keyframe-level cadence matches iSAM2's incremental behavior.
    gn_iterations: int = 3
    # Tiny: with the exact-chain CG preconditioner (ops/blocktri.py) the
    # bend modes loop corrections excite have curvature ~1e-3 of the
    # odometry blocks; damping at 1e-6*diag (~2 per entry) froze them
    # (measured on the KAIST03 chain: 13.3 m vs 2.8 m residual RMSE).
    lm_damping: float = 1e-9
    max_keyframes: int = 4096
    max_loops: int = 512
    optimize_every_n_keyframes: int = 2  # solve cadence of the synchronous pipeline
    # Solver selection (models/posegraph.py). "woodbury": CG preconditioned
    # by the Woodbury inverse (chain + low-rank loops) — iteration count
    # independent of #loops, the r5 fix for the 8192-tier 1 Hz cadence.
    # "chain_cg": chain-only preconditioner (r4 behavior; also the
    # automatic fallback below the node threshold or above the memory cap).
    solver: str = "woodbury"
    wb_cg_iters: int = 6  # CG iters under the near-exact Woodbury precond
    # Below this node capacity the r4 chain-CG path is already fast and
    # the Woodbury setup (6L-wide chain solve + S Cholesky) isn't worth
    # its fixed cost per optimize.
    wb_min_nodes: int = 1024
    # Memory guard: Z = C^{-1} V is [N, 6, 6L] f32; above this byte size
    # fall back to chain-CG rather than risk HBM pressure.
    wb_max_z_bytes: int = 700 * 1024 * 1024
    # Upper node bound for Woodbury: the 6L-wide multi-RHS chain solve in
    # its setup scales pathologically on this stack (tools/micro_wb.py:
    # 1.9 s at N=4096, 5.0 s at N=8192 standalone — [m, R]-shaped
    # per-level passes run ~50x below HBM peak regardless of formulation)
    # and stops paying for itself past this tier.
    wb_max_nodes: int = 4096
    # Above wb_max_nodes the chain-CG fallback runs with this reduced
    # iteration count: each 1 Hz tick then performs a PARTIAL solve that
    # the warm-started next tick refines further — the incremental-update
    # regime of the reference's iSAM2 (relinearizeThreshold 0.01,
    # laserPosegraphOptimization.cpp:881-884), chosen to keep the
    # 8192-tier optimize inside the 1 Hz cadence.
    cg_iters_large: int = 24
    # ONE GN sweep per tick above wb_max_nodes: each tick relinearizes
    # once and takes a 24-iteration truncated-Newton step — the same
    # incremental regime as the reference's single iSAM2 update per tick
    # (laserPosegraphOptimization.cpp:791-808); the 1 Hz warm-started
    # cadence supplies the outer iteration. Measured at 8192: the
    # per-tick fixed cost (linearize + Hessian-block assembly) is
    # ~520 ms/GN, so 2 GN broke the 1 s budget (1752 ms) where 1 holds it.
    gn_iterations_large: int = 1


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host pipeline behavior (reference: ROS pub/sub + worker threads)."""

    queue_depth: int = 100  # ROS queue sizes
    drop_backlog: bool = True  # laserMapping.cpp:300-304 real-time policy
    # ONE fused jit (features+odometry+mapping+gate+keyframe-prep) on a
    # single front-end thread instead of three stage threads/executables:
    # saves ~3 host dispatches (~1 ms each) + queue handoffs
    # per frame on the async runtime (models/frontend.py). The separate-
    # stage path remains for ablation and skip_frame cadences.
    fused_frontend: bool = True
    # Max frames the front-end may DISPATCH ahead of device completion.
    # Host dispatch (~3.6 ms/frame fused) outruns device compute
    # (~11 ms/frame), so an unthrottled feed queues SECONDS of device
    # work — every later synchronous fetch (cadenced SC detect, the
    # backend's lag-window gate flags) then waits out that whole backlog
    # (measured 1.4 s per detect at 160 frames deep, r5 e2e diagnostic).
    # The throttle waits (cheap is_ready() poll, no RPC) for
    # frame k - N before dispatching frame k, bounding every downstream
    # fetch to ~N frames of queued work. 0 disables.
    max_dispatch_ahead: int = 12
    loop_detection_hz: float = 1.0
    pgo_hz: float = 1.0
    stage_budget_ms: float = 100.0  # real-time alarm threshold
    save_directory: str = ""  # artifact output dir ("" = disabled)


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    scancontext: ScanContextConfig = dataclasses.field(default_factory=ScanContextConfig)
    loop: LoopClosureConfig = dataclasses.field(default_factory=LoopClosureConfig)
    pgo: PGOConfig = dataclasses.field(default_factory=PGOConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def replace(self, **kwargs) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)


def _preset(sensor: SensorConfig, sc_dist: float, kf_gap: float) -> SlamConfig:
    cfg = SlamConfig(sensor=sensor)
    cfg = cfg.replace(
        scancontext=dataclasses.replace(cfg.scancontext, dist_threshold=sc_dist),
        pgo=dataclasses.replace(cfg.pgo, keyframe_meter_gap=kf_gap),
    )
    return cfg


def kitti_hdl64() -> SlamConfig:
    """launch/aloam_velodyne_HDL_64.launch: min_range 5, sc_dist 0.4, kf gap 2 m.

    Range-image width 2304: a real HDL-64 emits ~2100-2200 returns per ring
    per 10 Hz revolution, so 2304 (18 x 128 lanes) covers it — the [rings,
    width] kernels (curvature, suppression, greedy selection) scale with
    this, so no 4096 default padding."""
    return _preset(
        SensorConfig(
            lidar_type="HDL64", n_scans=64, minimum_range=5.0,
            max_points_per_ring=2304,
        ),
        sc_dist=0.4,
        kf_gap=2.0,
    )


def mulran_os1_64() -> SlamConfig:
    """launch/aloam_mulran.launch: OS1-64, min_range 0.5, sc_dist 0.2, kf gap 1 m.

    The OS1-64 fires exactly 1024 or 2048 azimuth columns per revolution.

    Keyframe capacity is sized for the MulRan courses the reference
    benchmarks (README.md:54-67): Riverside01 is ~7 km, which at the 1 m
    keyframe gap yields ~7k keyframes — 8192 slots up front avoids the
    mid-run re-jit the tiered growth path would otherwise pay
    (models/posegraph.py grow)."""
    cfg = _preset(
        SensorConfig(
            lidar_type="OS1-64", n_scans=64, minimum_range=0.5,
            max_points_per_ring=2048,
        ),
        sc_dist=0.2,
        kf_gap=1.0,
    )
    return cfg.replace(
        pgo=dataclasses.replace(
            cfg.pgo, max_keyframes=8192, max_loops=2048
        ),
        scancontext=dataclasses.replace(cfg.scancontext, max_keyframes=8192),
    )


def vlp16() -> SlamConfig:
    """launch/aloam_velodyne_VLP_16.launch."""
    return _preset(
        SensorConfig(
            lidar_type="VLP16",
            n_scans=16,
            minimum_range=0.3,
            max_points=32768,
            max_points_per_ring=2048,
        ),
        sc_dist=0.2,
        kf_gap=2.0,
    )


def hdl32() -> SlamConfig:
    """launch/aloam_velodyne_HDL_32.launch."""
    return _preset(
        SensorConfig(
            lidar_type="HDL32",
            n_scans=32,
            minimum_range=0.3,
            max_points=65536,
            max_points_per_ring=2048,
        ),
        sc_dist=0.2,
        kf_gap=2.0,
    )


PRESETS = {
    "kitti_hdl64": kitti_hdl64,
    "mulran_os1_64": mulran_os1_64,
    "vlp16": vlp16,
    "hdl32": hdl32,
}


def from_dict(d: dict) -> SlamConfig:
    """Inverse of `dataclasses.asdict(cfg)`: one nested dict per section."""
    kwargs = {}
    for f in dataclasses.fields(SlamConfig):
        section = f.default_factory  # the section's dataclass
        kwargs[f.name] = section(**d[f.name])
    return SlamConfig(**kwargs)
