"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up builds the program (the PyTorch and
CUDA port, ``refinedet_tpu_torch``) and its inputs from the seed, warms
up every shape the cell uses, then the window measures for ``--seconds``
on the host clock. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` a stretch at the end of the window
runs under the profiler and the result carries the per-layer metrics,
the device's busy and traced seconds and a breakdown. After the window
the program is freed and the plain reference (``portbench/reference``)
judges what the timed path produced; each compared number is printed
with its limit, last on standard error and under ``checks`` in the
result, whose line is the last of standard output.

A run without a CUDA card, with fewer cards than the cell asks for, or
that finds JAX or the JAX package loaded once the window has closed,
exits non-zero and prints no result.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches() -> None:
    """Every kernel and build cache at a fixed path inside the checkout
    (the port builds its own CUDA libraries into
    ``refinedet_tpu_torch/_build`` there already)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    args = parse_args(argv)
    fixed_caches()
    import torch

    from portbench import harness
    bench = harness.benchmark(ROOT)
    cell = harness.cell(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    return report(args, bench, cell, torch.device("cuda", 0))


def report(args, bench: dict, cell: dict, device, traffic_over: dict = None,
           config_over: dict = None) -> int:
    """Everything of a run after the look for a card: the driver on
    ``device``, the checks, the result line. ``traffic_over`` and
    ``config_over`` change parameters of the cell's files (for tests)."""
    import torch

    from portbench import harness, judge
    cfg = harness.load_json(harness.config_path(cell["config"], ROOT))
    traffic = harness.load_json(harness.traffic_path(cell["traffic"], ROOT))
    traffic.update(traffic_over or {})
    cfg.update(config_over or {})
    limits = harness.load_json(harness.limits_path(args.workload, ROOT))
    driver = harness.load_module(harness.driver_path(traffic["driver"], ROOT),
                                 f"portbench_driver_{traffic['driver']}")
    ctx = harness.Ctx(args.workload, args.seed, args.seconds,
                      bool(args.trace), cfg, traffic, limits, device, START,
                      cell["chips"])
    out = driver.run(ctx)

    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3

    metrics = {}
    if args.trace:
        for m in harness.per_layer_of(bench, args.workload):
            reader = harness.load_module(harness.metric_path(m["name"], ROOT),
                                         "portbench_metric")
            value = reader.read(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.end_to_end_of(bench, args.workload):
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes,
           "power_limit": harness.power_limit()}
    breakdown = None
    tr = out.record.get("window", {}).get("trace")
    if tr is not None:
        from portbench import trace
        dev["busy_s"] = tr["busy_ns"] / 1e9
        dev["window_s"] = tr["window_ns"] / 1e9
        breakdown = {"device_ops": trace.top(tr["kernel_ops"]),
                     "idle_gaps": trace.top(tr["idle_gaps"])}
    correct = out.correct and judge.verdict(out.checks, limits)
    for name, value in out.checks.items():
        if name not in limits:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr)
    for name, limit in limits.items():
        print(f"check {name}: {out.checks[name]!r} (limit {limit!r})",
              file=sys.stderr)
    print(harness.result_line(correct, out.attempted, out.failed, metrics,
                              dev, harness.limit_lines(out.checks, limits),
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
