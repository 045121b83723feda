"""What a traced run records from the benchmark's side of the program:
spans around the calls into each layer, the launches of the hand kernels
in each captured step, and the replays of each step in the window.

- Spans: `Spans.wrap(owner, attr, name)` replaces a module or class
  attribute of the program (its callers look it up at call time) with a
  wrapper that, while the spans are on, records CUDA events on the current
  stream before and after the call, the host clock, and a profiler range
  `bench.span:<name>`.
- Launches: while a step is captured (its first call), a dispatch mode sees
  every custom op of the hand kernels with its real arguments; the kernel's
  cost file (costs/<kernel>.py, matched by the op's name) turns them into
  bytes and operations. A captured graph replays exactly those launches, so
  each replay in the window adds them again. Each replay in the window runs
  inside a profiler range `bench.step:<module of the step>`, so the trace
  ties the device kernels of a graph launch to the step that launched them.
- Captures: every first call counts; the window must have none.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class Spans:
    def __init__(self):
        self.on = False
        self.records: List[tuple] = []  # (name, start event, end event, host s)
        self._undo: List[tuple] = []

    def wrap(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)
        spans = self

        def wrapper(*args, **kwargs):
            if not spans.on:
                return orig(*args, **kwargs)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench.span:{name}"):
                out = orig(*args, **kwargs)
            end.record()
            spans.records.append((name, start, end, time.perf_counter() - t0))
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def read(self) -> Dict[str, dict]:
        """{span name: {"calls", "device_ms" (summed stream time), "host_ms"
        (summed)}} over the recorded spans (the device must be synchronised)."""
        out = collections.defaultdict(lambda: {"calls": 0, "device_ms": 0.0, "host_ms": 0.0})
        for name, start, end, host_s in self.records:
            r = out[name]
            r["calls"] += 1
            r["device_ms"] += start.elapsed_time(end)
            r["host_ms"] += host_s * 1e3
        return dict(out)


class _Record(TorchDispatchMode):
    """Records (kernel, bytes, operations) of each hand-kernel op dispatched
    while the current stream captures."""

    def __init__(self, by_op: dict, sink: list):
        super().__init__()
        self.by_op, self.sink = by_op, sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kernel = self.by_op.get(func._schema.name)
        if kernel is not None and torch.cuda.is_current_stream_capturing():
            n_bytes, n_ops = kernel[1].cost(args)
            self.sink.append((kernel[0], n_bytes, n_ops))
        return func(*args, **(kwargs or {}))


class Launches:
    """Launch records of the program's captured steps (see the module
    docstring). `install(compiled)` wraps its Compiled class; `window` turns
    the replay counting on."""

    def __init__(self, costs: dict):
        # op name -> (kernel name, cost module)
        self.by_op = {c.OP: (name, c) for name, c in costs.items()}
        self.per_entry: Dict[int, tuple] = {}  # id(entry) -> (module, {kernel: [n, bytes, ops]}, entry)
        self.replays: Dict[int, int] = collections.Counter()
        self.captures = 0
        self.window = False
        self._undo = None

    def install(self, compiled_mod) -> None:
        cls = compiled_mod.Compiled
        first, replay = cls._first_call, cls._replay
        rec = self

        def first_call(step, key, *args):
            rec.captures += 1
            sink: list = []
            with _Record(rec.by_op, sink):
                out = first(step, key, *args)
            entry = step._cache.get(key)
            if entry is not None:
                per = collections.defaultdict(lambda: [0, 0.0, 0.0])
                for kernel, n_bytes, n_ops in sink:
                    row = per[kernel]
                    row[0] += 1
                    row[1] += n_bytes
                    row[2] += n_ops
                rec.per_entry[id(entry)] = (step.__wrapped__.__module__, dict(per), entry)
            return out

        def replay_(step, entry, leaves):
            if not rec.window:
                return replay(step, entry, leaves)
            rec.replays[id(entry)] += 1
            with torch.profiler.record_function(f"bench.step:{step.__wrapped__.__module__}"):
                return replay(step, entry, leaves)

        cls._first_call, cls._replay = first_call, replay_
        self._undo = (cls, first, replay)

    def restore(self) -> None:
        if self._undo is not None:
            cls, first, replay = self._undo
            cls._first_call, cls._replay = first, replay
            self._undo = None

    def totals(self, modules) -> Dict[str, list]:
        """{kernel: [launches, bytes, operations]} replayed in the window by
        the steps defined in `modules`."""
        out = collections.defaultdict(lambda: [0, 0.0, 0.0])
        for eid, n in self.replays.items():
            module, per, _ = self.per_entry.get(eid, (None, {}, None))
            if module not in modules:
                continue
            for kernel, (launches, n_bytes, n_ops) in per.items():
                row = out[kernel]
                row[0] += n * launches
                row[1] += n * n_bytes
                row[2] += n * n_ops
        return dict(out)
