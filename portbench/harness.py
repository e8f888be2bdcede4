"""What every cell's run shares: names resolved to files, the run's
context, the measured window with its traced stretch, and the device
record.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is found by its name in ``BENCHMARK.json``:

  * ``portbench/configs/<config>.json``: the model and its plain
    reference's settings;
  * ``portbench/traffic/<traffic>.json``: the ``driver`` and its
    parameters; its ``generator`` is ``portbench/traffic/gen_<name>.py``;
  * ``portbench/drivers/<driver>.py``: the timed loop of one kind of work,
    ``run(ctx) -> Outcome``;
  * ``portbench/metrics/<metric>.py``: one reader per per-layer metric,
    ``read(record) -> float or None``; where there is none, the reader of
    its stem, the name up to the first dot (``idle_share.py`` reads
    ``idle_share.train`` and ``idle_share.detect``);
  * ``portbench/limits/<workload>.json``: the limit of each number the
    cell's comparison with the reference gives.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "refinedet_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_path(name: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "configs" / f"{name}.json"


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "traffic" / f"{name}.json"


def driver_path(name: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "drivers" / f"{name}.py"


def generator_path(name: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "traffic" / f"gen_{name}.py"


def metric_path(name: str, root: Path = ROOT) -> Path:
    own = root / "portbench" / "metrics" / f"{name}.py"
    stem = root / "portbench" / "metrics" / f"{name.split('.', 1)[0]}.py"
    return own if own.is_file() or not stem.is_file() else stem


def limits_path(workload: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "limits" / f"{workload}.json"


def generator(name: str, root: Path = ROOT):
    return load_module(generator_path(name, root), f"portbench_gen_{name}")


def end_to_end_of(bench: dict, workload: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_of(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics this cell reports: those listing it, and
    those without ``workloads`` whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


@dataclasses.dataclass
class Ctx:
    """One run: the cell, its files' contents, the command line and the
    device."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    device: object
    start: float  # perf_counter at process start
    chips: int = 1


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: counts, the end-to-end candidates, the
    per-layer record, the compared numbers and the peak."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    record: dict
    checks: Dict[str, float]
    memory_peak_bytes: int
    correct: bool = True


def until(seconds: float, step: Callable[[int], None],
          trace_steps: int = 0, sync: Callable[[], None] = lambda: None
          ) -> dict:
    """The measured window: ``step(i)`` for i = 0, 1, ... until
    ``seconds`` have passed on the host clock, then ``sync()``. With
    ``trace_steps``, once 80% of the window has passed, ``trace_steps``
    more steps run under the profiler and close the window. Returns
    ``seconds`` (the whole window), ``steps``, ``untraced_steps``,
    ``untraced_seconds`` and ``trace`` (``trace.reduce``'s numbers)."""
    from portbench import trace as tr
    t0 = time.perf_counter()
    i = 0
    cut = seconds * (0.8 if trace_steps else 1.0)
    while time.perf_counter() - t0 < cut:
        step(i)
        i += 1
    sync()
    out = {"untraced_steps": i,
           "untraced_seconds": time.perf_counter() - t0}
    if trace_steps:
        first = i

        def stretch():
            for j in range(first, first + trace_steps):
                step(j)

        out["trace"] = tr.capture(stretch, sync)
        i += trace_steps
    out["seconds"] = time.perf_counter() - t0
    out["steps"] = i
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def limit_lines(checks: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, dict]:
    return {k: {"value": checks[k], "limit": limits[k]} for k in limits}


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
