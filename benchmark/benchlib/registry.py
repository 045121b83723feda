"""Cells, configurations, drivers, per-layer metrics and kernel costs, each
found by its name in a file of its own under the benchmark's folder."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT.parent)}")
    return json.loads(path.read_text())


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT.parent)}")
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    """workloads/<name>.json: config, traffic, driver, chips, why, params."""
    w = _json(ROOT / "workloads" / f"{name}.json")
    w["name"] = name
    return w


def config(name: str) -> dict:
    """configs/<name>.json: the deployment as it is run."""
    c = _json(ROOT / "configs" / f"{name}.json")
    c["name"] = name
    return c


def driver(name: str) -> ModuleType:
    """drivers/<name>.py: the traffic driver (its `Driver` class)."""
    return _module(ROOT / "drivers" / f"{name}.py")


def metrics() -> Dict[str, ModuleType]:
    """Every metrics/<name>.py by the metric's name (the file's stem)."""
    return {p.stem: _module(p) for p in sorted((ROOT / "metrics").glob("*.py"))}


def costs() -> Dict[str, ModuleType]:
    """Every costs/<kernel>.py by the kernel's name (the file's stem)."""
    return {p.stem: _module(p) for p in sorted((ROOT / "costs").glob("*.py"))}


def workload_names() -> list:
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))
