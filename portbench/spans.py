"""The program's own spans in the traced run, read on the profiler's clock.

`tpu_mot_torch` marks each layer boundary and each tracker stage with a
`record_function` range while a capture is on (`serve.*`, `detector.*`,
`tracker.*`; its `utils/profiling.py` lists them).  They are host ranges
in the same capture as the card's operations, so each device operation is
put down to the innermost program span open on the serving thread when it
was launched, and each instant the card sat idle to the innermost program
span the host was in at that instant.  (The breakdown's `idle_gaps` puts a
gap down to the module of the first operation after it instead.)  An idle
interval is placed on the host's clock by the launch that ended it: on the
card the capture's device times were seen to drift from its host times by
up to milliseconds over a traced stretch (`before_launch_max_s`).

A program without these spans gives a record with no spans.  No metric of
BENCHMARK.json reads the record yet: `record_of` takes the same traced
stretch, calls and device operations as `tracing.reduce`, from the same
events, and changes none of what that gives.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs `run.py --trace 1` with those arguments and prints, on stderr, this
record as one JSON line and a table of it per step.
"""

from __future__ import annotations

import bisect
import json
import sys
from pathlib import Path

PREFIXES = ("serve.", "detector.", "tracker.")


def program_spans(evs, tid, lo: float, hi: float) -> list:
    """(start, end, name) of the program's spans on thread `tid`, clipped
    to [lo, hi]: those that lie outside it are left out."""
    out = []
    for e in evs:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(PREFIXES)
                and e.get("tid") == tid):
            s, t = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if t > s:
                out.append((s, t, e["name"]))
    return out


def innermost(spans: list) -> list:
    """Disjoint (start, end, name) pieces of time, each under the innermost
    span open then.  Spans on one thread nest; a child that outlasts its
    parent by the clock's rounding is cut at the parent's end."""
    pieces = []
    stack: list = []            # (end, name), innermost last
    t = None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            pieces.append((t, end, top))
            t = end
        if stack:
            pieces.append((t, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        pieces.append((t, end, top))
        t = end
    return [p for p in pieces if p[1] > p[0]]


def record(evs, calls: list, ops: list, busy: list, lo: float,
           hi: float) -> dict:
    """The spans' record of a timing capture's traced stretch [lo, hi]
    (microseconds): `calls` its serving calls, `ops` its device operations
    with their "launch" time, `busy` the merged busy intervals [start, end,
    the op that starts it, ...] sorted.  Times in seconds, spans in the
    order they first open:

    by_span   {name: n, host_s, self_s (less its child spans), device_s and
              launches (operations launched with it innermost), idle_s
              (idle card while it was innermost on the host)}
    idle_outside_s, launches_outside   outside every program span
    ops_before_launch, before_launch_max_s   operations that start before
              their launch, and the most by which one does (0 where the
              device's times agree with the host's)

    The card idles until the host launches the op that ends the idle
    interval, so each interval is placed on the host's clock by that
    launch: where the capture's device times drift against its host times,
    the interval still lies before the launch that ended it.
    """
    tid = calls[0].get("tid") if calls else None
    spans = sorted(program_spans(evs, tid, lo, hi),
                   key=lambda x: (x[0], -x[1]))
    pieces = innermost(spans)
    by: dict = {}

    def entry(name):
        return by.setdefault(name, dict(n=0, host_s=0.0, self_s=0.0,
                                        device_s=0.0, launches=0,
                                        idle_s=0.0))

    for s, e, name in spans:
        d = entry(name)
        d["n"] += 1
        d["host_s"] += (e - s) / 1e6
    for s, e, name in pieces:
        entry(name)["self_s"] += (e - s) / 1e6
    starts = [p[0] for p in pieces]
    launches_outside = 0
    for op in ops:
        k = bisect.bisect_right(starts, op["launch"]) - 1
        if k >= 0 and op["launch"] < pieces[k][1]:
            d = entry(pieces[k][2])
            d["launches"] += 1
            d["device_s"] += op["dur"] / 1e6
        else:
            launches_outside += 1
    idle, prev, shift = [], lo, 0.0
    for s, e, first, *_ in busy:
        if s > prev:
            shift = first["launch"] - first["ts"]
            idle.append((prev + shift, s + shift))
        prev = max(prev, e)
    if hi > prev:
        idle.append((prev + shift, hi + shift))
    idle_outside = 0.0
    for a, b in idle:
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        covered = 0.0
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                covered += part
                entry(name)["idle_s"] += part / 1e6
            k += 1
        idle_outside += b - a - covered
    leads = [op["launch"] - op["ts"] for op in ops if op["ts"] < op["launch"]]
    return {
        "by_span": by,
        "idle_outside_s": idle_outside / 1e6,
        "launches_outside": launches_outside,
        "ops_before_launch": len(leads),
        "before_launch_max_s": max(leads, default=0.0) / 1e6,
    }


def record_of(evs, skip: int = 1) -> dict:
    """The spans' record of a timing capture, over the stretch that
    `tracing.reduce(evs, ..., skip)` reads: from the start of the call
    after the first `skip` to the end of the last call or fetch, with the
    device operations that overlap it."""
    from portbench import tracing

    calls, per_call, outside = tracing.launches_by_call(evs)
    if len(calls) <= skip:
        return record(evs, [], [], [], 0.0, 0.0)
    fetches = tracing._complete(evs, ("user_annotation",), tracing.FETCH)
    calls = calls[skip:]
    lo = calls[0]["ts"]
    hi = max([c["ts"] + c["dur"] for c in calls]
             + [f["ts"] + f["dur"] for f in fetches])
    ops = [op for i, v in per_call.items() if i >= skip for op in v]
    ops = [o for o in ops + outside
           if o["ts"] + o["dur"] > lo and o["ts"] < hi]
    busy = tracing._union([(o["ts"], o["ts"] + o["dur"], o) for o in ops],
                          lo, hi)
    return record(evs, calls, ops, busy, lo, hi)


def table(rec: dict) -> str:
    """The spans' record of a traced run, per step, one line a span."""
    n = rec.get("calls") or 1
    sp = rec.get("spans") or {}
    lines = [f"{'span':<20} {'n':>6} {'self_ms':>9} {'device_ms':>10} "
             f"{'launches':>9} {'idle_ms':>8}  (per step, {n} steps)"]
    for name, d in (sp.get("by_span") or {}).items():
        lines.append(f"{name:<20} {d['n'] / n:>6.2f} "
                     f"{d['self_s'] / n * 1e3:>9.3f} "
                     f"{d['device_s'] / n * 1e3:>10.3f} "
                     f"{d['launches'] / n:>9.1f} "
                     f"{d['idle_s'] / n * 1e3:>8.3f}")
    lines.append(f"{'(outside)':<20} {'':>6} {'':>9} {'':>10} "
                 f"{sp.get('launches_outside', 0) / n:>9.1f} "
                 f"{sp.get('idle_outside_s', 0.0) / n * 1e3:>8.3f}")
    lines.append(f"ops that start before their launch: "
                 f"{sp.get('ops_before_launch', 0)}, by at most "
                 f"{sp.get('before_launch_max_s', 0.0) * 1e3:.3f} ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    """A traced run of run.py with `argv`, its spans' record on stderr."""
    from portbench import run, tracing

    recs = []
    reduce = tracing.reduce

    def keep(evs, modules, skip=1):
        rec = reduce(evs, modules, skip)
        recs.append(dict(rec, spans=record_of(evs, skip)))
        return rec

    tracing.reduce = keep
    try:
        rc = run.main(list(argv if argv is not None else sys.argv[1:])
                      + ["--trace", "1"])
    finally:
        tracing.reduce = reduce
    for rec in recs:
        keys = ("calls", "launches", "busy_s", "window_s", "spans")
        print("portbench: spans " + json.dumps({k: rec.get(k) for k in keys}),
              file=sys.stderr)
        print(table(rec), file=sys.stderr)
    return rc


if __name__ == "__main__":
    # As in run.py: this folder must not shadow top-level modules.
    HERE = Path(__file__).resolve().parent
    sys.path = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(HERE.parent))
    sys.exit(main())
