"""Run one cell of the benchmark in BENCHMARK.json once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (`configs/<name>.json`: the program's
settings and sizes, the comparison's limits) and a traffic mix
(`traffic/<name>.json`: the generator's parameters and the name of the
driver, `drivers/<driver>.py`, that owns the serving loop).  Per-layer
metrics are readers `metrics/<name>.py`.  All are found by name: a new
cell needs new files and a `workloads` entry, and no edit here.

The run: set-up (inputs rendered on the device from the seed, the program
built, every shape warmed up), then `--seconds` of closed-loop serving,
one call in flight and its tracks fetched to the host as a live consumer
would.  With `--trace 1` a torch.profiler capture of a steady stretch in
the middle of the window gives the per-layer metrics instead of the
end-to-end ones.  After the window the program's state is freed and the
plain reference judges a sample of the calls drawn from the seed.  The
last stdout line is the result; the numbers compared, each beside its
limit, close stderr and the result line.

`--device cpu` skips the look for a CUDA card (tests at tiny sizes only).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_mot")


def process_start_time() -> float:
    """Wall-clock time at which this process started (from /proc), or
    now when that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start_time()


def _fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the program builds its CUDA library into
    tpu_mot_torch/_build/ by itself)."""
    cache = HERE / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")


def load_cell(bench: dict, name: str, checkout: Path = CHECKOUT) -> dict:
    """The cell's entries, files and metric lists, found by name in the
    checkout that holds BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(has {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    with open(checkout / cfg_entry["file"]) as f:
        config = json.load(f)
    traffic_file = checkout / HERE.name / "traffic" / f"{cell['traffic']}.json"
    with open(traffic_file) as f:
        traffic = json.load(f)

    def here(metric):
        return name in metric.get("workloads", [name])

    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])


def metric_reader(name: str):
    """`metrics/<name>.py`'s read(rec) -> value or None."""
    return importlib.import_module(f"portbench.metrics.{name}").read


def percentile(values: list[float], pct: int) -> float:
    """The pct-th percentile by nearest rank over every value."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, (pct * len(s) + 99) // 100 - 1)]


def window_metrics(calls: list[tuple[float, float, int]], t0: float,
                   t1: float) -> dict:
    """End-to-end metrics of a window from its calls (start, tracks on the
    host, stream-frames), all on the host clock: stream-frames over the
    window's seconds, and the 95th percentile over every stream-frame of
    its call's latency."""
    frames = sum(n for _, _, n in calls)
    lat = []
    for s, e, n in calls:
        lat.extend([(e - s) * 1e3] * n)
    return {"frames_per_s": frames / (t1 - t0),
            "frame_ms_p95": percentile(lat, 95)}


class Reservoir:
    """A uniform sample of k calls of the window, drawn from the seed (the
    decision is made before each call, so the call can keep its state)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0

    def offer(self) -> int | None:
        """None to skip this call, else the slot (0..k-1) it takes."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    args = ap.parse_args(argv)

    _fixed_caches()
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    from portbench import tracing
    with open(args.bench) as f:
        bench = json.load(f)
    spec = load_cell(bench, args.workload, Path(args.bench).resolve().parent)
    chips = spec["cell"]["chips"]

    import torch

    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s), "
                  f"{cards} found", file=sys.stderr)
            return 3
    torch.set_num_threads(1)
    device = torch.device(args.device)
    driver_mod = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    drv = driver_mod.Driver(spec["config"], spec["traffic"], args.seed,
                            device)
    drv.setup()
    if args.trace:
        # The profiler's own start-up (CUPTI) is paid here, not in the
        # traced stretch.
        with tracing.profile(device.type == "cuda", False):
            torch.ones(1, device=device).add_(1)
    peak = resident = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated(device)
    setup_s = time.time() - T_START

    # ---- the measured window ---------------------------------------------
    res = Reservoir(int(spec["traffic"].get("checked_calls", 4)), args.seed)
    calls = []
    tr = spec["traffic"].get("trace", {})
    trace_at = args.seconds * float(tr.get("start_share", 0.4))
    trace_len = float(tr.get("seconds", 2.0))
    prof, phase, timing_events = None, "before", []
    t0 = time.perf_counter()
    t_end = t0 + args.seconds
    now = t0
    # A traced stretch that has begun runs to its length even past the
    # window's end (the traced run reports no end-to-end metric).
    while now < t_end or phase in ("starting", "on"):
        if args.trace and phase == "before" and now - t0 >= trace_at:
            # The first call under the profiler pays its start-up; the
            # traced stretch begins after it (tracing.reduce skips it).
            drv.before_trace()
            prof = tracing.profile(device.type == "cuda", False)
            prof.start()
            phase = "starting"
        slot = res.offer()
        s = time.perf_counter()
        n = drv.call(slot)
        now = time.perf_counter()
        calls.append((s, now, n))
        if len(calls) == 1 and device.type == "cuda":
            # The program's peak: set-up's residents and one call's working
            # set (every call has the same shapes), read before the state
            # that the check holds from the window's sample has grown.
            peak = torch.cuda.max_memory_allocated(device)
        if phase == "starting":
            t_prof, phase = now, "on"
        elif phase == "on" and now - t_prof >= trace_len:
            prof.stop()
            phase = "done"
            drv.after_trace()
            timing_events = tracing.events(prof)
    t1 = now
    e2e = window_metrics(calls, t0, t1)
    attempted = sum(n for _, _, n in calls)

    # ---- device readings, traced records ---------------------------------
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": chips if device.type == "cuda" else 0,
                "memory_peak_bytes": peak}
    if device.type == "cuda":
        print(f"portbench: memory: clips {drv.input_bytes()}, resident "
              f"after set-up {resident}, the program's peak {peak}, with "
              "the check's held state "
              f"{torch.cuda.max_memory_allocated(device)} bytes",
              file=sys.stderr)
    metrics = {}
    breakdown = None
    if args.trace:
        stack_prof = tracing.profile(device.type == "cuda", True)
        with stack_prof:
            for _ in range(2):
                drv.call(None)
        seqs = tracing.module_sequence(tracing.events(stack_prof))
        rec = tracing.reduce(timing_events, seqs[0] if seqs else None)
        print(f"portbench: traced {rec.get('calls', 0)} calls; "
              f"{len(seqs[0]) if seqs else 0} launches a call mapped to "
              "modules", file=sys.stderr)
        rec.update(drv.trace_facts())
        dev_info["busy_s"] = rec.get("busy_s", 0.0)
        dev_info["window_s"] = rec.get("window_s", 0.0)
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = tracing.breakdown(rec)
    else:
        for m in spec["end_to_end"]:
            v = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- correctness, after the window -----------------------------------
    drv.release()
    checks = drv.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # Run as a script, this folder is sys.path[0]: its modules would shadow
    # top-level ones of the same name.  Import them as the package.
    sys.path = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(CHECKOUT))
    sys.exit(main())
