"""Nothing the harness, the drivers, the metrics, the costs or the
reference import is JAX or the JAX package, by top-level names compared
whole (`scaloam_tpu_torch` is the program; `scaloam_tpu` is not)."""

import json
import subprocess
import sys

from benchlib import guard, registry


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_modules(["scaloam_tpu_torch", "scaloam_tpu_torch.ops", "jaxtyping",
                                    "torch"]) == []
    assert guard.forbidden_modules(["jax", "jaxlib.xla_client", "scaloam_tpu.ops", "flax"]) == [
        "flax", "jax", "jaxlib.xla_client", "scaloam_tpu.ops"]


def test_the_benchmark_loads_nothing_of_jax():
    """In a fresh process: every module of the benchmark, every driver,
    metric and cost, and the program they drive."""
    code = f"""
import json, sys
sys.path[:0] = [{str(registry.ROOT)!r}, {str(registry.ROOT.parent)!r}]
import harness
from benchlib import guard, registry, driving, probes, stats, trace, roofline, synthetic
from reference import compare
for w in registry.workload_names():
    registry.driver(registry.workload(w)["driver"])
registry.metrics(); registry.costs()
import scaloam_tpu_torch.models.pipeline, scaloam_tpu_torch.models.frontend
import scaloam_tpu_torch.parallel.multiseq
print(json.dumps(guard.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
