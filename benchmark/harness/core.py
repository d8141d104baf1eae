"""What every cell shares: the manifest, the configuration and traffic
files found by name, the metric readers, the device record and the
result's last line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files:

  benchmark/configs/<config>.json      the model's sizes as run
  benchmark/workloads/<cell>.json      the traffic mix and the limits of
                                       the comparison that decides
                                       ``correct``; its ``kind`` names
  benchmark/traffic/<kind>.py          the loop that drives it
  benchmark/metrics/<base>.py          one reader per metric, by the part
                                       of the metric's name before a dot

A loop returns a ``Run``; each reader takes it and returns a number or
None (nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "tooncrafter_tpu")


def process_start() -> float:
    """The process's start on the ``time.monotonic`` clock (CLOCK_BOOTTIME
    ticks from /proc; the import time where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        started = ticks / os.sysconf("SC_CLK_TCK")
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.monotonic() - since
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_of(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no config named {name!r} in BENCHMARK.json")


def mix_of(cell: dict) -> dict:
    mix = load_json(BENCH / "workloads" / f"{cell['name']}.json")
    if mix.get("traffic") != cell["traffic"]:
        raise SystemExit(f"workloads/{cell['name']}.json is traffic "
                         f"{mix.get('traffic')!r}, BENCHMARK.json says "
                         f"{cell['traffic']!r}")
    return mix


def load_module(path: Path):
    """The module of a file under benchmark/, found by its path (a name
    may hold '-' or '.'), loaded once."""
    name = f"_bench_{path.parent.name}_{path.stem}".replace("-", "_") \
        .replace(".", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def traffic_loop(kind: str):
    return load_module(BENCH / "traffic" / f"{kind}.py")


def reader(metric: str) -> Callable[["Run"], Optional[float]]:
    return load_module(BENCH / "metrics"
                       / f"{metric.split('.')[0]}.py").read


def metrics_for(man: dict, cell: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (an untraced run) or per-layer ones
    (a traced run): those whose ``workloads`` list it, or that have none
    and move an end-to-end metric the cell reports."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m
                                          and m["moves"] in names)]


@dataclasses.dataclass
class Run:
    """What one run of a loop leaves for the readers and the last line."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    units: int = 0                  # clips or training steps completed
    steps_per_unit: int = 0         # DDIM steps of a request
    requests: int = 0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_per_unit: Optional[float] = None
    memory_peak_bytes: int = 0
    # the traced run's profile of one more request or pair of steps
    trace: Optional[dict] = None
    # the comparison: name -> (value, limit); ``correct`` needs each
    # value present, finite and at most its limit
    checks: Dict[str, Tuple[Optional[float], float]] = \
        dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and self.units > 0 and bool(self.checks) \
            and all(v is not None and math.isfinite(v) and v <= lim
                    for v, lim in self.checks.values())


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules (or ``names``) whose whole top-level name is
    JAX's, Flax's or the JAX package's."""
    return sorted(n for n in (sys.modules if names is None else names)
                  if n.split(".")[0] in FORBIDDEN)


def device_record(run: Run, traced: bool) -> dict:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if traced and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    return dev


def result(run: Run, man: dict, cell: str, traced: bool,
           device: dict) -> dict:
    metrics = {}
    for m in metrics_for(man, cell, traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if traced and run.trace:
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def print_checks(run: Run) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for k, (v, lim) in run.checks.items():
        ok = v is not None and math.isfinite(v) and v <= lim
        print(f"check {k} {v} limit {lim} {'ok' if ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(f"correct {run.correct}", file=sys.stderr, flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
