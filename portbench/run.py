"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

With ``--trace 0`` the line's ``metrics`` are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from spans placed
around the program's layers and from a ``torch.profiler`` trace of part
of the window, with ``device.busy_s`` and ``device.window_s`` and a
``breakdown``. Every run compares what its window served with the plain
reference (``reference/``) and reports ``correct``; the numbers compared
and their limits (``limits/<cell>.json``) come last, in the line under
``checks`` and as the last lines on standard error.

``--control 1`` (calibration only, never in a benchmark run) also
reads the control, the reference in float8 put in the program's place,
and judges it in the program's stead: its numbers go through the same
comparison with the cell's limits, and ``correct`` is the control's.

The run needs a CUDA device (at least the cell's chips) and the program
beside the benchmark (``src/repro_torch``); without them it prints no
result and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time this process started (from ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def _prepare_env(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; the program beside
    the benchmark on the path; one host thread for torch's CPU ops (the
    host only feeds the device, and idle pool threads that spin beside
    the serving loop make its steps jitter)."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    src = root / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level names."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def metrics_line(cell, record: dict, traced: bool) -> dict:
    """The cell's metrics (per-layer with ``traced``), each from its
    reader; a reader that finds nothing to read is left out."""
    from portbench import spec

    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: float | None = None, shrink=None,
             control: bool = False, limits: dict | None = None,
             bench: dict | None = None, mix_over: dict | None = None) -> dict:
    """The cell's run without the look for a chip: the result's fields
    (``device`` left to the caller). ``shrink`` (configuration keys) and
    ``mix_over`` (mix keys) are the CPU tests' small sizes."""
    from portbench import checks, serving, spec

    t_start = time.time() if t_start is None else t_start
    cell = spec.find_cell(name, bench)
    if mix_over:
        cell.mix = dict(cell.mix, **mix_over)
    kind = cell.mix["kind"]
    if kind == "serve":
        out = serving.run(cell, seed, seconds, traced, device, t_start,
                          shrink=shrink, control=control)
    else:
        raise ValueError(f"no driver for mix kind {kind!r}")
    record = out["record"]
    limits = limits if limits is not None else checks.limits(name)
    compared = checks.compare(record["check"], limits,
                              prefix="control_" if control else "")
    result = dict(correct=checks.within(compared),
                  attempted=record["attempted"], failed=0,
                  metrics=metrics_line(cell, record, traced))
    if traced and "profile" in record:
        p = record["profile"]
        result["breakdown"] = dict(device_ops=p["device_ops"],
                                   idle_gaps=p["idle_gaps"])
    result["peak"] = out["peak"]
    result["record"] = record
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record-out", default=None,
                    help="also write the run's raw record here (JSON)")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    _prepare_env(root)

    from portbench import spec
    cell = spec.find_cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2
    # whatever the program prints goes to standard error: the last line
    # of standard output is the result's
    with contextlib.redirect_stdout(sys.stderr):
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t_start=t_start,
                       control=bool(args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    record = res.pop("record")
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell.chips, memory_peak_bytes=int(res.pop("peak")))
    if args.trace and "profile" in record:
        device["busy_s"] = record["profile"]["busy_s"]
        device["window_s"] = record["profile"]["window_s"]
    checks = res.pop("checks")
    line = dict(res, device=device)
    line["checks"] = checks
    if args.record_out:
        with open(args.record_out, "w") as f:
            json.dump(dict(record=record, line=line), f, default=str)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
