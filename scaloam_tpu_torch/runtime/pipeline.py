"""The asynchronous real-time runtime (counterpart of
scaloam_tpu/runtime/pipeline.py): the reference's ROS node graph as host
threads over two CUDA streams.

  separate:  feed -> scan_q -> [registration] -> feat_q -> [odometry]
             -> map_q -> [mapping] -> kf_q -> [backend ingest]
  fused:     feed -> scan_q -> [front end] -> kf_q -> [backend ingest]

plus, in both, the [loop] thread: ScanContext detection and pose-graph
optimisation at 1 Hz, ICP verification of a candidate outside the system
lock. The fused topology (runtime.fused_frontend with skip_frame == 1)
runs features, odometry, mapping, the gate and the keyframe prep in one
thread per frame. Under drop_backlog the mapping stage takes only the
newest frame (get_latest), the reference's real-time policy.

Streams and events: the front-end worker(s) enqueue on one CUDA stream,
backend ingest and the loop thread on a second, so the in-place appends to
the pose graph and the ScanContext database are ordered by the system lock
and the stream. Each frame's small results (poses, gate flag) are copied
`non_blocking` into pinned host memory and an event is recorded after the
copy: the dispatch-ahead throttle polls it, results are materialised once
it has completed, and the backend stream waits on it (`wait_event`) before
it touches the frame's tensors, which are also marked as in use there
(`record_stream`) so the caching allocator cannot hand their memory out
early. No worker synchronises the whole device; each read goes through the
worker's own stream. On the CPU there are no streams or events and the
same threads run the plain versions.

With a backend device (`backend_device`, a second card) the backend
stream lives there, and the backend-side threads touch the front end's
tensors on a third stream, on the front end's card: both wait on each
frame's event (cudaStreamWaitEvent crosses devices within a process), and
the keyframe's cloud and pose are handed over by a non_blocking copy that
SlamSystem issues at its stage boundary after those waits. PyTorch runs a
copy between cards on the source card's current stream and orders the
destination's current stream (the backend stream) after it;
`record_stream` marks the handed-over tensors in use on the stream that
reads them.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.models import frontend as frontend_mod
from scaloam_tpu_torch.models import mapping as mapping_mod
from scaloam_tpu_torch.models import odometry as odometry_mod
from scaloam_tpu_torch.models import pipeline as pipeline_mod
from scaloam_tpu_torch.models import posegraph as pg
from scaloam_tpu_torch.models import scancontext as scm
from scaloam_tpu_torch.models.pipeline import SlamSystem
from scaloam_tpu_torch.ops import features
from scaloam_tpu_torch.runtime.queues import BoundedQueue
from scaloam_tpu_torch.types import LidarScan, Pose
from scaloam_tpu_torch.utils.metrics import GLOBAL


def _record_event(device: torch.device):
    """An event recorded on the current stream, or None on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _card(device: torch.device):
    """The CUDA device index of `device`, or None off the GPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def _unique(*streams) -> list:
    """The distinct streams among `streams`, in order, None left out."""
    out = []
    for s in streams:
        if s is not None and all(s is not o for o in out):
            out.append(s)
    return out


def _done(event) -> bool:
    return event is None or event.query()


class _HostCopy:
    """Small tensors of one frame, flattened to float32 and copied to host
    memory: on CUDA a non_blocking copy into pinned memory followed by an
    event on the current stream (recorded after the frame's work), on the
    CPU a plain copy."""

    __slots__ = ("host", "event")

    def __init__(self, parts):
        x = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
        else:
            self.host = x
        self.event = _record_event(x.device)

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _HostView(collections.namedtuple("_HostView", "copy lo hi")):
    """Entries lo:hi of a _HostCopy: a pending per-frame result."""

    def numpy(self) -> np.ndarray:
        return self.copy.numpy()[self.lo : self.hi].copy()


def _materialize_ready(results: list, ptr: int) -> int:
    """Advance `ptr` over `results`, turning entries whose copy has landed
    into numpy without waiting; stops at the first that has not."""
    while ptr < len(results):
        t, x = results[ptr]
        if isinstance(x, _HostView):
            if not _done(x.copy.event):
                break
            results[ptr] = (t, x.numpy())
        ptr += 1
    return ptr


def _materialize_all(results: list) -> list:
    return [(t, x.numpy() if isinstance(x, _HostView) else x) for t, x in results]


class AsyncSlamPipeline:
    """Threaded wrapper over SlamSystem's stages with real-time semantics.

    `AsyncSlamPipeline(cfg, drop_backlog=None, system=None, device=None,
    backend_device=None)` runs on `cuda` unless `device` names another,
    its backend on `backend_device` (default: the same device); a passed
    `system` (e.g. SlamSystem.resume) fixes both. `feed` frames, then `finish`
    (drains every stage) or `abort` (drops the backlog); both leave
    `odom_results` / `mapped_results` as (time, translation numpy) lists.
    A worker's exception stops the pipeline and is raised by `finish`."""

    # The backend gate-checks a frame once it is this many frames old, so
    # the flag's host copy has landed and the read does not wait on the
    # front end's stream. Keyframe decisions lag by that much, which is
    # inert: the gate accumulates motion and everything downstream (SC
    # detection, PGO) runs at 1 Hz.
    _BACKEND_LAG = 6

    def __init__(self, cfg: SlamConfig, drop_backlog: Optional[bool] = None,
                 system: Optional[SlamSystem] = None, device=None, backend_device=None):
        self.cfg = cfg
        self.drop_backlog = cfg.runtime.drop_backlog if drop_backlog is None else drop_backlog
        # The fused step maps every frame, so a skip_frame cadence runs the
        # separate-stage threads.
        self.fused = cfg.runtime.fused_frontend and cfg.odometry.skip_frame == 1
        if system is not None:
            for name, want, got in (("device", device, system.device),
                                    ("backend_device", backend_device, system.backend_device)):
                if want is not None and torch.device(want) != got:
                    raise ValueError(f"{name} {want} differs from the system's {got}")
        self.sys = system if system is not None else SlamSystem(
            cfg, device=device, backend_device=backend_device)
        self.device = self.sys.device
        self.backend_device = self.sys.backend_device
        fe_card, bk_card = _card(self.device), _card(self.backend_device)
        self._fe_stream = None if fe_card is None else torch.cuda.Stream(fe_card)
        self._bk_stream = None if bk_card is None else torch.cuda.Stream(bk_card)
        # The stream on the front end's card on which the backend-side
        # threads read the front end's tensors: the backend stream itself
        # when both stages share a card.
        self._rd_stream = None
        if fe_card is not None:
            self._rd_stream = self._bk_stream if fe_card == bk_card else torch.cuda.Stream(fe_card)
        qd = cfg.runtime.queue_depth
        self.scan_q = BoundedQueue(qd, "scans")
        self.feat_q = BoundedQueue(qd, "features")
        self.map_q = BoundedQueue(qd, "mapping")
        self.kf_q = BoundedQueue(qd, "keyframes")
        self.odom_results: List = []
        self.mapped_results: List = []
        self._o_mat = 0  # materialisation pointers (_materialize_ready)
        self._m_mat = 0
        self._fed = 0
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()  # the system lock: backend state
        self._ingest_done = threading.Event()
        self._kf_flag = threading.Event()  # keyframe(s) since the last detect
        # Per-stage host busy time (seconds outside queue waits) and frame
        # counts; gate_wait is the backend's lock + gate-flag wait, the
        # loop_* entries split the loop thread's detect / ICP / optimise.
        self.stage_busy = {
            "registration": 0.0, "odometry": 0.0, "mapping": 0.0,
            "frontend": 0.0, "backend": 0.0,
            "gate_wait": 0.0, "loop_detect": 0.0, "loop_icp": 0.0,
            "loop_opt": 0.0,
        }
        self.stage_frames = dict.fromkeys(self.stage_busy, 0)

    # -- stages ---------------------------------------------------------------

    def _throttle(self, inflight) -> None:
        """Bound dispatch-ahead: before frame k, wait (polling) until frame
        k - max_dispatch_ahead has completed on the device."""
        if self.cfg.runtime.max_dispatch_ahead and len(inflight) == inflight.maxlen:
            while not _done(inflight[0]) and not self._stop.is_set():
                time.sleep(0.0005)

    def _closed(self, q: BoundedQueue) -> bool:
        """Exit on closed-and-drained input, or on abort(); never on a
        momentarily empty queue (that races with a slow upstream)."""
        return self._stop.is_set() or (q.closed and len(q) == 0)

    def _registration_worker(self):
        inflight = collections.deque(maxlen=max(self.cfg.runtime.max_dispatch_ahead, 1))
        while True:
            item = self.scan_q.get(timeout=0.2)
            if item is None:
                if self._closed(self.scan_q):
                    self.feat_q.close()
                    return
                continue
            t, frame, pts = item
            t0 = time.perf_counter()
            self._throttle(inflight)
            scan = LidarScan.from_numpy(pts, self.cfg.sensor.max_points, self.device)
            feats = features.extract_features(scan, self.cfg)
            inflight.append(_record_event(self.device))
            self.feat_q.put((t, frame, feats))
            self.stage_busy["registration"] += time.perf_counter() - t0
            self.stage_frames["registration"] += 1

    def _odometry_worker(self):
        while True:
            item = self.feat_q.get(timeout=0.2)
            if item is None:
                if self._closed(self.feat_q):
                    self.map_q.close()
                    return
                continue
            t, frame, feats = item
            t0 = time.perf_counter()
            self.sys.o_state, o_out = odometry_mod.odometry_step(self.sys.o_state, feats, self.cfg)
            self.odom_results.append((t, _HostView(_HostCopy([o_out.world.trans]), 0, 3)))
            self._o_mat = _materialize_ready(self.odom_results, self._o_mat)
            # Mapping consumes the post-step last_* clouds (moved to the
            # sweep's end under distortion), captured now as o_state moves on.
            self.map_q.put((t, frame, o_out.world, feats,
                            self.sys.o_state.last_corner, self.sys.o_state.last_surf))
            self.stage_busy["odometry"] += time.perf_counter() - t0
            self.stage_frames["odometry"] += 1

    def _mapping_worker(self):
        get = self.map_q.get_latest if self.drop_backlog else self.map_q.get
        while True:
            item = get(timeout=0.2)
            if item is None:
                if self._closed(self.map_q):
                    self.kf_q.close()
                    return
                continue
            t, frame, odom_pose, feats, reg_corner, reg_surf = item
            t0 = time.perf_counter()
            self.sys.m_state, m_out = mapping_mod.mapping_step(
                self.sys.m_state, odom_pose, reg_corner, reg_surf, self.cfg)
            fire = self.sys.gate_step(m_out.pose)  # this worker owns the gate
            copy = _HostCopy([m_out.pose.trans, m_out.pose.quat, fire])
            self.mapped_results.append((t, _HostView(copy, 0, 3)))
            self._m_mat = _materialize_ready(self.mapped_results, self._m_mat)
            self.kf_q.put((t, frame, m_out.pose, feats, copy))
            self.stage_busy["mapping"] += time.perf_counter() - t0
            self.stage_frames["mapping"] += 1

    def _fused_frontend_worker(self):
        """Features, odometry, mapping, gate and (on keyframe frames) the
        keyframe prep, per frame on one thread; pushes (time, frame,
        mapped pose, keyframe buffers, host copy) to the backend."""
        inflight = collections.deque(maxlen=max(self.cfg.runtime.max_dispatch_ahead, 1))
        while True:
            item = self.scan_q.get(timeout=0.2)
            if item is None:
                if self._closed(self.scan_q):
                    self.kf_q.close()
                    return
                continue
            t, frame, pts = item
            t0 = time.perf_counter()
            self._throttle(inflight)
            scan = LidarScan.from_numpy(pts, self.cfg.sensor.max_points, self.device)
            fe = frontend_mod.FrontendState(self.sys.o_state, self.sys.m_state,
                                            self.sys.gate_state)
            fe, out = frontend_mod.frontend_step(fe, scan, self.cfg)
            self.sys.o_state, self.sys.m_state, self.sys.gate_state = fe.o, fe.m, fe.gate
            copy = _HostCopy([out.odom_world.trans, out.mapped_pose.trans,
                              out.mapped_pose.quat, out.fire])
            inflight.append(copy.event)
            self.odom_results.append((t, _HostView(copy, 0, 3)))
            self._o_mat = _materialize_ready(self.odom_results, self._o_mat)
            self.mapped_results.append((t, _HostView(copy, 3, 6)))
            self._m_mat = _materialize_ready(self.mapped_results, self._m_mat)
            self.kf_q.put((t, frame, out.mapped_pose, (out.kf_xyz, out.kf_mask, out.kf_ext),
                           copy))
            self.stage_busy["frontend"] += time.perf_counter() - t0
            self.stage_frames["frontend"] += 1

    def _handoff(self, event, tensors) -> None:
        """Make a frame's front-end tensors safe to use on the backend side:
        order the backend-side streams after the producer's event, and keep
        the caching allocator from reusing their memory before the stream
        that reads them is done."""
        if self._rd_stream is None:
            return
        for stream in _unique(self._rd_stream, self._bk_stream):
            stream.wait_event(event)
        for t in tensors:
            t.record_stream(self._rd_stream)

    def _backend_worker(self):
        """Keyframe ingest (the PGO node's process_pg): the gate check and
        the keyframe append; loop closure and optimisation run in
        _loop_worker, so a long ICP does not stall ingest."""
        pending = collections.deque()

        def process(item):  # under the system lock
            t, frame, mapped_pose, payload, copy = item
            t0 = time.perf_counter()
            fire = bool(copy.numpy()[-1] > 0.5)
            self.stage_busy["gate_wait"] += time.perf_counter() - t0
            self.stage_frames["gate_wait"] += 1
            if fire:
                if self.fused:
                    tensors = payload
                else:
                    full = payload.full
                    tensors = (full.xyz, full.mask, full.rel_time)
                self._handoff(copy.event, (mapped_pose.quat, mapped_pose.trans) + tuple(tensors))
                self.sys.frame_idx = frame  # the keyframe's source frame
                if self.fused:
                    self.sys._add_keyframe_prepared(*payload, mapped_pose, t)
                else:
                    self.sys._add_keyframe(payload, mapped_pose, t)
                self._kf_flag.set()
            self.stage_busy["backend"] += time.perf_counter() - t0
            self.stage_frames["backend"] += 1

        while True:
            item = self.kf_q.get(timeout=0.2)
            if item is not None:
                pending.append(item)
            drained = self._closed(self.kf_q)
            # Only entries older than the lag window mid-stream; the whole
            # backlog once the input has drained.
            target = 0 if drained else self._BACKEND_LAG
            if len(pending) > target and not self._stop.is_set():
                t0 = time.perf_counter()
                # One hold for the whole ready backlog: the loop thread
                # re-takes the lock between back-to-back optimises, so a
                # hold per frame would ingest one frame per optimise and
                # let kf_q overflow. kf_q stays the bound (pending holds at
                # most the lag window plus one).
                with self._lock:
                    self.stage_busy["gate_wait"] += time.perf_counter() - t0
                    while len(pending) > target and not self._stop.is_set():
                        process(pending.popleft())
                        nxt = self.kf_q.get(timeout=0)
                        if nxt is not None:
                            pending.append(nxt)
            if item is None and drained:
                self._ingest_done.set()
                return

    def _loop_worker(self):
        """Loop closure and PGO at their cadences (the reference's
        process_lcd / process_icp / process_isam,
        src/laserPosegraphOptimization.cpp:732-808): detection is
        dispatched under the system lock and read outside it; ICP runs
        outside the lock on a pose snapshot; the loop commit, the optimise
        and the artifact flush hold it. After ingest drains, one final
        forced pass."""
        last_opt = time.time()
        last_lcd = 0.0
        lcd_period = 1.0 / max(self.cfg.runtime.loop_detection_hz, 1e-6)
        opt_period = 1.0 / max(self.cfg.runtime.pgo_hz, 1e-6)
        while True:
            done = self._ingest_done.is_set() or self._stop.is_set()
            now = time.time()
            if (self._kf_flag.is_set() and (done or now - last_lcd >= lcd_period)
                    and not self._stop.is_set()):
                # Detect on the latest keyframe at the cadence (:732-742).
                self._kf_flag.clear()
                t0 = time.perf_counter()
                with self._lock:
                    out = self.sys.sc.detect_loop_closure_dispatch()
                    curr = len(self.sys.keyframes) - 1
                idx, yaw = (-1, 0.0) if out is None else scm.read_triple(out)[:2]
                poses = None
                if idx >= 0:
                    with self._lock:
                        poses = self.sys.fetch_pose_tables()
                self.stage_busy["loop_detect"] += time.perf_counter() - t0
                self.stage_frames["loop_detect"] += 1
                if idx >= 0:
                    GLOBAL.inc("loops.proposed")
                    t0 = time.perf_counter()
                    z = self.sys._icp_verify(curr, idx, yaw, poses=poses)
                    if z is not None:
                        with self._lock:
                            self.sys.commit_loop(curr, idx, z)
                    self.stage_busy["loop_icp"] += time.perf_counter() - t0
                    self.stage_frames["loop_icp"] += 1
                last_lcd = now
            if (done or now - last_opt >= opt_period) and not self._stop.is_set():
                t0 = time.perf_counter()
                with self._lock:
                    if len(self.sys.keyframes) > 1:
                        self.sys.graph = pg.optimize(self.sys.graph, self.cfg.pgo)
                    if self.sys._writer is not None:  # per-cycle dump (:803-805)
                        self.sys.flush_artifacts()
                self.stage_busy["loop_opt"] += time.perf_counter() - t0
                self.stage_frames["loop_opt"] += 1
                last_opt = now
            if done:
                return
            time.sleep(0.02)

    # -- lifecycle ------------------------------------------------------------

    def _precompile_stages(self) -> None:
        """On the calling thread, pay what a worker would otherwise pay on
        its first frame: build and load the kernel libraries, run two
        throwaway frames on throwaway state, one throwaway optimise of a
        two-node graph with a loop at the system graph's capacities, and
        the keyframe backend's programs at the system's tiers. On the card
        these calls capture the step programs (compiled.py: the first
        frame's and the later frames', the keyframe prep, the graph's
        appends and the optimise at the graph's tier, ScanContext's append
        and detection, the loop verification) before any worker starts; a
        tier the graph grows into later is captured by the loop thread, in
        thread-local capture mode, so the front end's concurrent work
        cannot break it. The process's first optimise also carries seconds
        of one-time torch.func / library set-up, and a first loop
        verification, eager and then captured (0.9-1.1 s on an H100 beside
        the workers); paid by the loop thread under the system lock they
        would stall ingest long enough to overflow kf_q, or skip a
        detection."""
        from scaloam_tpu_torch.ops.kernels import _build

        cfg, dev = self.cfg, self.device
        if dev.type == "cuda":
            for name in _build.SOURCES:
                _build.library(name)
        scan = LidarScan.from_numpy(np.zeros((16, 3), np.float32), cfg.sensor.max_points, dev)
        if self.fused:
            fe = frontend_mod.init_state(cfg, dev)
            for _ in range(2):  # the first frame fires the gate: the prep too
                fe, _ = frontend_mod.frontend_step(fe, scan, cfg)
        else:
            o, m = odometry_mod.init_state(cfg, dev), mapping_mod.init_state(cfg, dev)
            gate = pipeline_mod.init_gate_state(dev)
            for _ in range(2):
                feats = features.extract_features(scan, cfg)
                o, o_out = odometry_mod.odometry_step(o, feats, cfg)
                m, m_out = mapping_mod.mapping_step(m, o_out.world, o.last_corner,
                                                    o.last_surf, cfg)
                gate, _ = pipeline_mod.gate_step(
                    gate, m_out.pose.quat, m_out.pose.trans,
                    float(cfg.pgo.keyframe_meter_gap), float(cfg.pgo.keyframe_deg_gap))
            full = feats.full
            pipeline_mod._prepare_keyframe(full.xyz, full.mask, full.rel_time, cfg)
        bdev, graph = self.backend_device, self.sys.graph
        g = pg.init_graph(cfg.pgo, bdev, initial_nodes=pg.node_capacity(graph),
                          initial_loops=pg.loop_capacity(graph))
        for k in range(2):
            g = pg.add_keyframe(g, Pose.identity(bdev), 0.0, False, n_nodes=k)
        g = pg.add_loop(g, 1, 0, Pose.identity(bdev), n_loops=0)
        pg.optimize(g, cfg.pgo)
        # The keyframe backend's programs at the system's tiers: ScanContext
        # on a throwaway database, a loop verification of empty clouds.
        db = scm.init_db(cfg.scancontext, bdev, initial=self.sys.sc.db.descriptors.shape[0])
        cap = cfg.pgo.keyframe_cloud_capacity
        db, _ = scm.make_and_append(db, torch.zeros((cap, 3), device=bdev),
                                    torch.zeros(cap, dtype=torch.bool, device=bdev),
                                    cfg.scancontext)
        scm.detect_latest(db, cfg.scancontext)
        empty = np.zeros((0, 3), np.float32)
        self.sys.verify_loop(empty, empty, Pose.identity(bdev, (2,)))

    def _streams(self) -> List:
        return _unique(self._fe_stream, self._rd_stream, self._bk_stream)

    def _run(self, fn, streams) -> None:
        """A worker's body with `streams` current on their cards, the last
        one's card the thread's device; an exception stops the pipeline and
        is kept for finish() to raise."""
        try:
            with contextlib.ExitStack() as ctx:
                if streams:
                    torch.cuda.set_device(streams[-1].device)
                for stream in streams:
                    ctx.enter_context(torch.cuda.stream(stream))
                fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by finish()
            self._errors.append(e)
            self._stop.set()
            for q in (self.scan_q, self.feat_q, self.map_q, self.kf_q):
                q.close()

    def start(self, precompile: bool = True) -> None:
        if precompile:
            self._precompile_stages()
        # The workers' streams start after the system's set-up and the
        # throwaway work on the caller's streams.
        for stream in self._streams():
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        fe, bk = _unique(self._fe_stream), _unique(self._rd_stream, self._bk_stream)
        if self.fused:
            workers = ((self._fused_frontend_worker, fe), (self._backend_worker, bk),
                       (self._loop_worker, bk))
        else:
            workers = ((self._registration_worker, fe), (self._odometry_worker, fe),
                       (self._mapping_worker, fe), (self._backend_worker, bk),
                       (self._loop_worker, bk))
        for fn, streams in workers:
            th = threading.Thread(target=self._run, args=(fn, streams),
                                  name=fn.__name__.strip("_"), daemon=True)
            th.start()
            self._threads.append(th)

    def feed(self, time_s: float, points: np.ndarray) -> None:
        self.scan_q.put((time_s, self._fed, points))
        self._fed += 1

    def _join(self, timeout: float) -> None:
        deadline = time.time() + timeout
        for th in self._threads:
            th.join(max(0.1, deadline - time.time()))
        # The caller's streams continue after the workers' last work.
        for stream in self._streams():
            torch.cuda.current_stream(stream.device).wait_stream(stream)
        self.odom_results = _materialize_all(self.odom_results)
        self.mapped_results = _materialize_all(self.mapped_results)

    def finish(self, timeout: float = 300.0) -> None:
        """Graceful shutdown: close the inlet and drain every stage. Raises
        if a worker failed."""
        self.scan_q.close()
        self._join(timeout)
        if self._errors:
            raise RuntimeError("an AsyncSlamPipeline worker failed") from self._errors[0]

    def abort(self, timeout: float = 30.0) -> None:
        """Hard shutdown: stages exit at their next queue poll, the backlog
        is dropped; results already dispatched are materialised."""
        self._stop.set()
        for q in (self.scan_q, self.feat_q, self.map_q, self.kf_q):
            q.close()
            q.clear()
        self._join(timeout)

    @property
    def workers_alive(self) -> int:
        return sum(th.is_alive() for th in self._threads)

    @property
    def dropped_frames(self) -> int:
        return self.scan_q.dropped + self.feat_q.dropped + self.map_q.dropped + self.kf_q.dropped
