"""Runs one cell of the benchmark of `scaloam_tpu_torch` once, on the card
of the machine it starts on:

    python3 benchmark/harness.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is workloads/<cell>.json (its
configuration, traffic parameters, driver, limits); its configuration is
configs/<config>.json; its driver is drivers/<driver>.py; the metrics it
reports are the entries of BENCHMARK.json whose `workloads` name it (or
that name none), each read by metrics/<metric>.py.

A run: load the program and its kernels (built into build/kernels/ by a
checkout's first run), make the cell's scans from the seed on the card and
copy them to host memory, warm every step the traffic uses (set-up ends
here: `setup_s` counts from the process's start), then drive the traffic
for `--seconds` (with `--trace 1`, a traced window of the traffic
driver's length instead, under torch.profiler with spans on), then
compare the outputs of the sampled frames with the plain reference
(reference/) and print, as the last line of standard output, one JSON
object: correct, attempted, failed, metrics, device, breakdown (traced),
compared. Exits 1 without a result where there is no card, or too few,
where the program cannot be loaded, where a step was captured inside the
window, or where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(REPO)]
CACHE = REPO / "build" / "bench_cache"

from benchlib import guard, registry  # noqa: E402


def fail(message: str, code: int = 1):
    print(f"harness: {message}", file=sys.stderr)
    sys.exit(code)


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


class Run:
    """What a metric reader reads: the window's scans, the set-up time,
    and in a traced run the spans, the trace and the launch records."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every build and kernel cache inside the checkout, at fixed paths.
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = registry.workload(args.workload)
    config = registry.config(cell["config"])

    import torch

    torch.set_num_threads(1)  # the host's work in one thread: steadier on a shared host
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        from scaloam_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"the program cannot be loaded: {e}")
    _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    result = run(cell, config, args.seed, args.seconds, args.trace, device,
                 cell_metrics(bench, "per_layer" if args.trace else "end_to_end", cell["name"]))
    found = guard.forbidden_modules()
    if found:
        fail(f"loaded modules of JAX or the JAX package: {found}")
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def run(cell: dict, config: dict, seed: int, seconds: float, trace: int, device,
        metric_entries: list, steps: int = 0, control: bool = False,
        witness: bool = False) -> dict:
    """One run of `cell` on `device` (its program and kernels loaded): the
    result line's object. On the CPU (the tests) it runs the plain path,
    and `steps` (if not 0) fixes the untraced window's steps instead of its
    seconds. `control` adds the control's numbers (the reference in TF32
    in the program's place) under "control", `witness` the witness of each
    departed step and of two others (compare.witness) under "witness"; the
    benchmark's runs ask for neither."""
    import torch

    from scaloam_tpu_torch import compiled

    from benchlib import driving, probes, trace as trace_mod
    from reference import compare

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ctx = driving.Context(cell, config, seed, device)
    drv = registry.driver(cell["driver"]).Driver(ctx)
    costs = registry.costs()
    spans, launches = probes.Spans(), probes.Launches(costs)
    if trace:
        launches.install(compiled)
        for owner, attr, name in drv.spans:
            spans.wrap(owner, attr, name)
    drv.setup()
    sync()
    captures = lambda: sum(s.captures for s in list(compiled._steps))
    captures0 = captures()
    setup_s = time.perf_counter() - T0

    latencies = []
    # No collection inside the window: what set-up made is frozen, and the
    # collector waits until the window has closed.
    gc.collect()
    gc.freeze()
    gc.disable()
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        spans.on = launches.window = True
        with torch.profiler.record_function(trace_mod.WINDOW):
            start = time.perf_counter()
            for _ in range(drv.trace_steps()):
                latencies += drv.step()
            sync()
            window_s = time.perf_counter() - start
        spans.on = launches.window = False
    else:
        start = time.perf_counter()
        while (len(latencies) < steps if steps
               else time.perf_counter() - start < seconds):
            latencies += drv.step()
        sync()
        window_s = time.perf_counter() - start
    gc.enable()
    gc.unfreeze()
    in_window = captures() - captures0
    print(f"harness: {cell['name']}: {len(latencies)} scans in {window_s:.3f} s; steps captured "
          f"in the window: {in_window} (set-up captured {captures0})", file=sys.stderr)
    if in_window:
        fail(f"{in_window} step(s) captured inside the window")
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    run_ = Run(latencies=latencies, scans=len(latencies), window_s=window_s, setup_s=setup_s,
               spans=None, trace=None, launches=launches, costs=costs)
    breakdown = None
    if trace:
        t_read = time.perf_counter()
        prof.__exit__(None, None, None)
        run_.trace = trace_mod.read(prof.profiler.kineto_results.events())
        run_.spans = spans.read()
        prof = None
        device_info["busy_s"] = run_.trace.busy_s()
        device_info["window_s"] = run_.trace.window_s
        breakdown = {"device_ops": trace_mod.device_ops(run_.trace),
                     "idle_gaps": trace_mod.idle_gaps(run_.trace)}
        print(f"harness: trace read in {time.perf_counter() - t_read:.1f} s, "
              f"{len(run_.trace.kernels)} kernels", file=sys.stderr)
        spans.restore()
        launches.restore()

    readers = registry.metrics()
    metrics = {}
    for m in metric_entries:
        value = readers[m["name"]].read(run_)
        if value is None:
            print(f"harness: {m['name']}: nothing to read in this run", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The reference, once the window has closed, the peak read and the
    # program's state freed.
    failed = drv.failed
    drv.release()
    run_ = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compared = drv.numbers()
    numbers = compared.values()
    limits = cell["limits"]
    print(f"harness: compared steps: {json.dumps(compared.per_step)}", file=sys.stderr)
    print(f"harness: reference compared in {time.perf_counter() - t_ref:.1f} s over "
          f"{len(drv.samples)} sampled step(s)", file=sys.stderr)
    result = {"correct": bool(compare.verdict(numbers, limits) and failed == 0 and drv.samples),
              "attempted": len(latencies), "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        ctl = drv.numbers(use_tf32=True)
        result["control"] = ctl.values()
        result["steps"] = {"program": compared.per_step, "control": ctl.per_step}
    if witness:
        result["witness"] = drv.witness(compared)
    result["compared"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


if __name__ == "__main__":
    sys.exit(main())
