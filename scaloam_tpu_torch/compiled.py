"""The port's counterpart of `jax.jit`: a step captured once per key as a
CUDA graph and replayed.

The reference compiles each step of its hot path into one executable over
fixed shapes (`jax.jit`, the state donated where it says
`donate_argnums`). Here `jit(fn, static_argnames=..., donate_argnums=...)`
keeps a cache of captured `torch.cuda.CUDAGraph`s keyed on what `jax.jit`
keys on: the static arguments' values, the pytree structure of the other
arguments, every tensor leaf's shape, dtype and device, and the value of
every other leaf (a host bool such as `OdometryState.initialized` picks a
branch as the reference's `lax.cond` does). A graph replays the same
kernels in the same order as the eager call, so its outputs are the eager
call's, bit for bit; `torch.compile` would regenerate and fuse the plain
ops and round otherwise.

- First call on a key: `fn` runs eagerly on the caller's stream (the
  call's result, and the warm-up that loads the kernel libraries and
  creates the library handles), then `fn` is captured on the step's
  capture stream over its input buffers
  (`capture_error_mode="thread_local"`, so other threads may allocate
  and synchronise meanwhile). The capture
  launches nothing. The graph ends by copying the donated state into its
  input buffers, so the pool keeps no copy of the state once the capture
  ends; keys of one tensor layout (a host flag or a static argument
  apart) share one set of buffers.
- Later calls: the inputs are copied into the buffers, the graph is
  replayed on the caller's current stream, the donated state is written
  back into the caller's tensors in place, and every other tensor output
  is returned as a clone, so no caller holds a buffer that the next
  replay overwrites. The `k`-th donated argument's new value is the `k`-th
  element of the returned tuple, or, for a step with one donated argument
  that returns a value shaped as it (`add_keyframe_jit` returns the
  graph), the returned value.
- All keys of one step share one graph memory pool a device, so a tier
  the pose graph has grown past keeps its buffers and outputs, not a
  pool of its own. So the step's replays run one at a time: each waits for
  the step's last replay, on whatever stream that ran, and has taken its
  outputs out of the pool and the buffers before the next may start.
- Launch counts: a kernel's wrapper calls `count` where it launches. While
  a thread captures a step, its launches go to the capture's tally (that
  thread's only), which the graph adds to the counters at each replay.
- A capacity tier that a table has grown past is never replayed again:
  `drop(table)` (called by the pose graph's `grow` and the ScanContext
  database's `grow_db` with the outgrown table) removes, from every step,
  each key whose arguments held a tensor layout equal to the table's (its
  leaves' shapes, dtypes and devices in order), with its graph, outputs
  and input buffers. They are freed once the step's last replay has run
  (an event behind it, polled at the step's next call or drop), so the
  step's later captures reuse their blocks of the pool.
- Spans (`utils.timing`, recorded only while a profiler session records):
  `compiled.key` (bind, flatten and key; it precedes the
  call's other span, since the key decides what the call is), then
  `compiled.capture:<step>` for a first call or `compiled.replay:<step>`
  for a replay, inside which `compiled.copy_in`, `compiled.launch` and
  `compiled.outputs` carry the bytes each part of the boundary moves.
  Those figures are fixed per key at capture (`boundary_bytes` and the
  graph's own copies), so a replay adds no per-leaf work for them.
- The wrapper calls `fn` itself on CPU tensors (the plain path the caller
  asked for), inside another capture or eager run of this module (a
  program's inner steps are part of it, as nested `jax.jit`s are), under
  a functorch transform (`torch.func.vmap`), and under `disabled()`, the
  counterpart of `jax.disable_jit()`. On the card a failed capture or
  replay raises; nothing falls back to eager.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from scaloam_tpu_torch.utils import timing

_local = threading.local()  # .inline: eager / capture depth; .disabled: disabled() depth;
# .tally: the launches of the capture running on this thread
_steps: "weakref.WeakSet[Compiled]" = weakref.WeakSet()  # every step, for drop()


def count(counter) -> None:
    """One launch of the kernel whose wrapper `counter` counts in
    `counter.launches`: onto the tally of a capture running on this
    thread, else onto the counter."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        counter.launches += 1
    else:
        tally[counter] = tally.get(counter, 0) + 1


@contextlib.contextmanager
def _tallied():
    """While active, the launches counted on this thread go to the
    yielded {counter: launches}, not to their counters."""
    outer = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = outer


def _depth(name: str) -> int:
    return getattr(_local, name, 0)


@contextlib.contextmanager
def _nested(name: str):
    setattr(_local, name, _depth(name) + 1)
    try:
        yield
    finally:
        setattr(_local, name, _depth(name) - 1)


def disabled():
    """Run every compiled step eagerly on this thread while active (the
    counterpart of `jax.disable_jit()`)."""
    return _nested("disabled")


class _Entry:
    """One captured graph: its static input buffers (None for non-tensor
    leaves), its outputs, which output leaves write back into which input
    leaves, the launch counts of one replay, and the bytes one replay
    moves at the boundary: (copied in, copied into the buffers inside the
    graph, written back, cloned)."""

    __slots__ = ("graph", "static_in", "out_leaves", "out_spec", "donated", "launches",
                 "bytes")


class Compiled:
    """`fn` under `jit`; `fn` itself stays reachable as `__wrapped__`."""

    def __init__(self, fn: Callable, static_argnames: Sequence[str] = (),
                 donate_argnums: Sequence[int] = ()):
        functools.update_wrapper(self, fn)
        self._sig = inspect.signature(fn)
        names = list(self._sig.parameters)
        self._static = tuple(static_argnames)
        for name in self._static:
            if name not in names:
                raise ValueError(f"{fn.__name__} has no argument {name!r}")
        self._donate = tuple(names[i] for i in donate_argnums)
        self._cache: Dict[Any, _Entry] = {}
        self._lock = threading.Lock()  # guards _cache, _pools, _buffers, _retired, each capture
        self._pools: Dict[torch.device, Tuple] = {}  # (graph pool, capture stream) a device
        self._buffers: Dict[Tuple, List[Optional[torch.Tensor]]] = {}  # input buffers a layout
        self._replaying = threading.Lock()  # one replay at a time
        self._done: Dict[torch.device, torch.cuda.Event] = {}  # each device's last replay
        self._retired: List[Tuple] = []  # (event or None, what it keeps alive) from drop()
        step = f"{fn.__module__.removeprefix('scaloam_tpu_torch.')}.{fn.__name__}"
        self._spans = (f"compiled.capture:{step}", f"compiled.replay:{step}")
        self.captures = 0  # graphs captured (one a key)
        self.dropped = 0  # keys dropped with an outgrown tier
        _steps.add(self)

    def __call__(self, *args, **kwargs):
        if _depth("disabled") or _depth("inline"):
            return self.__wrapped__(*args, **kwargs)
        with timing.span("compiled.key") as s:
            bound = self._sig.bind(*args, **kwargs)
            bound.apply_defaults()
            arguments = bound.arguments
            dynamic = [n for n in arguments if n not in self._static]
            per_arg = [pytree.tree_flatten(arguments[n]) for n in dynamic]
            leaves = [leaf for flat, _ in per_arg for leaf in flat]
            compiles = self._compiles([x for x in leaves if isinstance(x, torch.Tensor)])
            if compiles:
                key = (tuple((n, arguments[n]) for n in self._static),
                       tuple(spec for _, spec in per_arg),
                       tuple(_leaf_key(x) for x in leaves))
                s.add("compiled.leaves", len(leaves))
        if not compiles:
            return self.__wrapped__(*args, **kwargs)
        with self._lock:
            if self._retired:
                self._free_retired()
            entry = self._cache.get(key)
            if entry is None:
                return self._first_call(key, arguments, dynamic, per_arg, leaves)
        return self._replay(entry, leaves)

    def _compiles(self, tensors: List[torch.Tensor]) -> bool:
        if not tensors:
            return False
        if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors):
            return False
        return _on_card(tensors, self.__name__)

    def _call(self, arguments, dynamic, leaves):
        """fn on `leaves` in place of the dynamic arguments' leaves."""
        args = dict(arguments)
        pos = 0
        for name in dynamic:
            flat, spec = pytree.tree_flatten(arguments[name])
            args[name] = pytree.tree_unflatten(leaves[pos:pos + len(flat)], spec)
            pos += len(flat)
        with _nested("inline"):
            return self.__wrapped__(**args)

    def _first_call(self, key, arguments, dynamic, per_arg, leaves):
        """Run eagerly, then capture over the step's input buffers."""
        dev = next(x for x in leaves if isinstance(x, torch.Tensor)).device
        with timing.span(self._spans[0]), torch.cuda.device(dev):
            buffers = self._input_buffers(leaves)
            out = self._call(arguments, dynamic, leaves)
            if dev not in self._pools:
                # One stream for the step's captures: the caching allocator
                # reuses a freed block only on the stream that allocated it.
                self._pools[dev] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev))

            def run():
                static_out = self._call(arguments, dynamic,
                                        [b if b is not None else x for b, x in zip(buffers, leaves)])
                donated = self._donated(static_out, per_arg, dynamic)
                out_leaves, spec = pytree.tree_flatten(static_out)
                kept = _keep_in_buffers(donated, buffers, out_leaves)
                return out_leaves, spec, donated, kept

            entry = _Entry()
            with _tallied() as tally:
                entry.graph, (out_leaves, entry.out_spec, entry.donated, kept) = _capture(
                    self._pools[dev], run)
            entry.launches = list(tally.items())
            entry.static_in = buffers
            # A replay leaves the new state in the buffers; the pool's copy
            # of it is free for the step's other keys once this ends.
            entry.out_leaves = [buffers[entry.donated[o]] if o in entry.donated else y
                                for o, y in enumerate(out_leaves)]
            copy_in, write_back, clone = boundary_bytes(leaves, entry.donated, entry.out_leaves)
            entry.bytes = (copy_in, kept, write_back, clone)
            self._cache[key] = entry
            self.captures += 1
            # The eager result; an output that is a donated input keeps the
            # value it had before the donated state is written back.
            out_leaves, spec = pytree.tree_flatten(out)
            donated_in = {id(leaves[i]) for i in entry.donated.values()}
            out_leaves = [y.clone() if id(y) in donated_in else y for y in out_leaves]
            return pytree.tree_unflatten(_write_back(entry.donated, leaves, out_leaves), spec)

    def _input_buffers(self, leaves) -> List[Optional[torch.Tensor]]:
        """The static input buffers for `leaves` (None for a non-tensor
        leaf), made on the first key of their tensor layout and shared by
        every key of that layout (a new key made by a host flag or a static
        argument reads the same buffers: replays run one at a time)."""
        layout = tuple(_leaf_key(x) if isinstance(x, torch.Tensor) else None for x in leaves)
        if layout not in self._buffers:
            self._buffers[layout] = [x.clone() if isinstance(x, torch.Tensor) else None
                                     for x in leaves]
        return self._buffers[layout]

    def _replay(self, entry: _Entry, leaves: List[Any]):
        dev = next(x for x in leaves if isinstance(x, torch.Tensor)).device
        copy_in, kept, write_back, clone = entry.bytes
        with timing.span(self._spans[1]), torch.cuda.device(dev), self._replaying:
            stream = torch.cuda.current_stream()
            done = self._done.get(dev)
            if done is not None:  # the pool's last user is through with it
                stream.wait_event(done)
            with timing.span("compiled.copy_in") as s:
                _copy([b for b in entry.static_in if b is not None],
                      [x for b, x in zip(entry.static_in, leaves) if b is not None])
                s.add("compiled.copy_in_bytes", copy_in)
            with timing.span("compiled.launch") as s:
                entry.graph.replay()
                s.add("compiled.keep_bytes", kept)
            with timing.span("compiled.outputs") as s:
                out = list(entry.out_leaves)
                fresh = [o for o, y in enumerate(out)
                         if isinstance(y, torch.Tensor) and o not in entry.donated]
                for o in fresh:
                    out[o] = torch.empty_like(entry.out_leaves[o])
                _copy([out[o] for o in fresh], [entry.out_leaves[o] for o in fresh])
                out = _write_back(entry.donated, leaves, out)
                s.add("compiled.write_back_bytes", write_back)
                s.add("compiled.clone_bytes", clone)
            if done is None:
                done = self._done[dev] = torch.cuda.Event()
            done.record(stream)
            for counter, n in entry.launches:
                counter.launches += n
        return pytree.tree_unflatten(out, entry.out_spec)

    def _drop(self, layout: Tuple) -> int:
        """Retire the keys and input buffers whose leaves hold `layout` as
        a contiguous run; returns the number of keys."""
        with self._lock:
            keys = [k for k in self._cache if _holds(k[2], layout)]
            layouts = [k for k in self._buffers if _holds(k, layout)]
            gone = ([self._cache.pop(k) for k in keys], [self._buffers.pop(k) for k in layouts])
            if keys or layouts:
                self._retired.append((self._behind_last_replay(), gone))
                self.dropped += len(keys)
            self._free_retired()
        return len(keys)

    def _behind_last_replay(self):
        """An event that completes once every device's last replay of this
        step has run, or None where none was made."""
        if not self._done:
            return None
        dev = next(iter(self._done))
        side = self._pools[dev][1]
        for done in list(self._done.values()):
            side.wait_event(done)
        event = torch.cuda.Event()
        event.record(side)
        return event

    def _free_retired(self) -> None:
        """Let go of retired keys whose replays have all run."""
        self._retired = [(ev, kept) for ev, kept in self._retired
                         if ev is not None and not ev.query()]

    def _donated(self, out, per_arg, dynamic) -> Dict[int, int]:
        """{output leaf: input leaf} for the donated arguments' tensors:
        the k-th donated argument pairs with the k-th returned element (or
        a lone donated argument with the returned value, where that is
        shaped as it), leaf by leaf where both are tensors of one shape and
        dtype."""
        pairs: Dict[int, int] = {}
        if not self._donate:
            return pairs
        starts, pos = {}, 0
        for name, (flat, _) in zip(dynamic, per_arg):
            starts[name] = pos
            pos += len(flat)
        out_starts, pos = [], 0
        for elem in out:
            out_starts.append(pos)
            pos += len(pytree.tree_leaves(elem))
        for k, name in enumerate(self._donate):
            flat, spec = per_arg[dynamic.index(name)]
            whole = len(self._donate) == 1 and pytree.tree_structure(out) == spec
            got, got_spec = pytree.tree_flatten(out if whole else out[k])
            if got_spec != spec:
                raise ValueError(f"{self.__name__}: returned element {k} is not shaped "
                                 f"as the donated argument {name!r}")
            for j, (x, y) in enumerate(zip(flat, got)):
                if (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                        and x.shape == y.shape and x.dtype == y.dtype):
                    pairs[(0 if whole else out_starts[k]) + j] = starts[name] + j
        return pairs


def drop(table) -> int:
    """Retire, from every step, each key whose arguments held `table`'s
    tensor layout (see the module docstring): the capacity tier `table`
    was at has been outgrown. Returns the number of keys dropped."""
    layout = tuple(_leaf_key(x) for x in pytree.tree_leaves(table)
                   if isinstance(x, torch.Tensor))
    return sum(step._drop(layout) for step in list(_steps)) if layout else 0


def _holds(keys: Tuple, run: Tuple) -> bool:
    """Whether `run` occurs in `keys` as a contiguous run."""
    n = len(run)
    return any(keys[i:i + n] == run for i in range(len(keys) - n + 1))


def _on_card(tensors: List[torch.Tensor], name: str) -> bool:
    """True for CUDA tensors on one device outside a capture, False for
    CPU tensors; raises on a mix."""
    cuda = [t.is_cuda for t in tensors]
    if not any(cuda):
        return False
    devices = {t.device for t in tensors}
    if not all(cuda) or len(devices) != 1:
        raise ValueError(f"{name}: the tensors lie on {sorted(map(str, devices))}; "
                         "a compiled step takes them on one CUDA device")
    return not torch.cuda.is_current_stream_capturing()


def _leaf_key(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"a compiled step's non-tensor argument {x!r} is not hashable; "
                        "name it in static_argnames") from None
    return (type(x), x)


def _capture(pool: Tuple, run: Callable):
    """(graph, outputs): run() captured into a CUDA graph, in thread-local
    capture mode, on the stream of `pool` = (graph memory pool, stream)."""
    handle, side = pool
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(pool=handle, capture_error_mode="thread_local")
        try:
            out = run()
        except BaseException:
            with contextlib.suppress(RuntimeError):  # the first error is the one
                graph.capture_end()
            raise
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out


def _copy(dsts: List[torch.Tensor], srcs: List[torch.Tensor]) -> None:
    """dst.copy_(src) for each pair: one foreach copy a dtype, so a whole
    state moves in a few launches."""
    groups: Dict[torch.dtype, Tuple[list, list]] = {}
    for d, s in zip(dsts, srcs):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _keep_in_buffers(donated: Dict[int, int], buffers: List[Optional[torch.Tensor]],
                     out_leaves: List[Any]) -> int:
    """Inside the capture: copy each donated output into its input buffer,
    so the graph leaves the new state there. Any output that shares memory
    with a buffer is cloned before a copy writes one: a donated output to
    be copied, and another output that would otherwise read the new state
    where the call returns the old. Returns the bytes these copies and
    clones write at each replay."""
    pairs = [(o, i) for o, i in donated.items() if out_leaves[o] is not buffers[i]]
    ptr = lambda t: t.untyped_storage().data_ptr()
    held = {ptr(b) for b in buffers if b is not None}
    written = {ptr(buffers[i]) for _, i in pairs}
    moved = 0
    for o, y in enumerate(out_leaves):
        if isinstance(y, torch.Tensor) and o not in donated and ptr(y) in written:
            out_leaves[o] = y.clone()
            moved += y.nbytes
    srcs = [out_leaves[o].clone() if ptr(out_leaves[o]) in held else out_leaves[o]
            for o, _ in pairs]
    moved += sum(y.nbytes for (o, _), y in zip(pairs, srcs) if y is not out_leaves[o])
    _copy([buffers[i] for _, i in pairs], srcs)
    return moved + sum(buffers[i].nbytes for _, i in pairs)


def boundary_bytes(leaves: List[Any], donated: Dict[int, int],
                   out_leaves: List[Any]) -> Tuple[int, int, int]:
    """(copied in, written back, cloned): the bytes a replay moves outside
    its graph, from a key's leaves, its {output leaf: input leaf} donation
    pairs and its output leaves. Every tensor leaf is copied into its
    buffer; each donated output is written back into the caller's tensor,
    or cloned where another donated tensor shares that tensor's memory
    (`_write_back`, by the sharing the leaves show); every other tensor
    output is cloned."""
    copy_in = sum(x.nbytes for x in leaves if isinstance(x, torch.Tensor))
    ptrs = collections.Counter(leaves[i].data_ptr() for i in donated.values())
    write_back = clone = 0
    for o, y in enumerate(out_leaves):
        if not isinstance(y, torch.Tensor):
            continue
        if o in donated and ptrs[leaves[donated[o]].data_ptr()] == 1:
            write_back += y.nbytes
        else:
            clone += y.nbytes
    return copy_in, write_back, clone


def _write_back(donated: Dict[int, int], leaves: List[Any], out_leaves: List[Any]) -> List[Any]:
    """The outputs with each donated state tensor copied into the caller's
    tensor it replaces, which takes its place among the outputs. A caller
    tensor whose memory another donated tensor shares gets a fresh clone
    instead (writing both in place would leave one value in both)."""
    ptrs = collections.Counter(leaves[i].data_ptr() for i in donated.values())
    dsts, srcs = [], []
    for o, i in donated.items():
        x, y = leaves[i], out_leaves[o]
        if ptrs[x.data_ptr()] > 1:
            out_leaves[o] = y.clone()
        else:
            dsts.append(x)
            srcs.append(y)
            out_leaves[o] = x
    _copy(dsts, srcs)
    return out_leaves


def jit(fn: Optional[Callable] = None, *, static_argnames: Sequence[str] = (),
        donate_argnums: Sequence[int] = ()):
    """`fn` as a step captured once per key and replayed (see the module
    docstring); usable as `jit(fn, ...)` or as a decorator `@jit(...)`."""
    if fn is None:
        return lambda f: Compiled(f, static_argnames, donate_argnums)
    return Compiled(fn, static_argnames, donate_argnums)
