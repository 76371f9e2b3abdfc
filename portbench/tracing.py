"""The traced run's records: a torch.profiler capture of a steady stretch
of serving calls, reduced to device intervals, launches, host spans and
the program module that launched each device operation.

Two captures are made.  The timing capture (CPU and CUDA activity, no
Python stacks) gives every number that has a time in it.  A short capture
with Python stacks, taken after the window, maps each launch of one call
to the innermost frame of the program (`tpu_mot_torch/<module>.py`) that
made it; since a call launches the same sequence of operations every
time, the n-th operation of a timed call gets the module of the n-th
operation of the stack capture.  Host time inside a call is the span the
benchmark records around it (`portbench.call`); the consumer's fetch of
the tracks is `portbench.fetch`.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "portbench.call"
FETCH = "portbench.fetch"
_FRAME = re.compile(r"tpu_mot_torch/([\w/]+)\.py\(\d+\)")


def profile(activities_cuda: bool, with_stack: bool):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if activities_cuda:
        acts.append(ProfilerActivity.CUDA)
    return _profile(activities=acts, with_stack=with_stack)


def events(prof) -> list[dict]:
    """The capture's Chrome-trace events (written to a temporary file in
    TMPDIR, read and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def _complete(evs, cat=None, name=None):
    return [e for e in evs if e.get("ph") == "X"
            and (cat is None or e.get("cat") in cat)
            and (name is None or e.get("name") == name)]


def _corr(e):
    a = e.get("args") or {}
    return a.get("correlation", a.get("correlation id"))


def launches_by_call(evs) -> tuple[list, dict, list]:
    """(calls sorted by start, {call index: [device op, ...] in launch
    order}, device ops launched outside every call).  A device op is the
    trace event, with "launch" set to its host launch time."""
    calls = sorted(_complete(evs, ("user_annotation",), CALL),
                   key=lambda e: e["ts"])
    runtime = {}
    for e in evs:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
            c = _corr(e)
            if c is not None:
                runtime[c] = e
    starts = [c["ts"] for c in calls]
    per_call: dict = collections.defaultdict(list)
    outside = []
    for op in _complete(evs, DEVICE_CATS):
        r = runtime.get(_corr(op))
        op["launch"] = r["ts"] if r is not None else op["ts"]
        i = bisect.bisect_right(starts, op["launch"]) - 1
        if i >= 0 and op["launch"] <= calls[i]["ts"] + calls[i]["dur"]:
            per_call[i].append(op)
        else:
            outside.append(op)
    for ops in per_call.values():
        ops.sort(key=lambda o: (o["launch"], _corr(o) or 0))
    return calls, per_call, outside


def module_sequence(evs) -> list[list[tuple[str, str]]]:
    """For each call of a capture with Python stacks, (op name, program
    module) of each of its device ops in launch order: the module is the
    innermost program frame open on the launching thread at the
    launch."""
    calls, per_call, _ = launches_by_call(evs)
    tid = calls[0].get("tid") if calls else None
    frames = []
    for e in _complete(evs, ("python_function",)):
        m = _FRAME.search(e.get("name", ""))
        if m and (tid is None or e.get("tid") == tid):
            frames.append((e["ts"], -(e["ts"] + e["dur"]), m.group(1)))
    frames.sort()
    launches = sorted((op["launch"], i, j)
                      for i, ops in per_call.items()
                      for j, op in enumerate(ops))
    seqs = [["unknown"] * len(per_call.get(i, [])) for i in range(len(calls))]
    stack: list = []
    k = 0
    for t, i, j in launches:
        while k < len(frames) and frames[k][0] <= t:
            s, neg_end, mod = frames[k]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_end, mod))
            k += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        if stack:
            seqs[i][j] = stack[-1][1]
    return [[(op["name"], m) for op, m in zip(per_call.get(i, []), seq)]
            for i, seq in enumerate(seqs)]


def _union(intervals, lo, hi):
    """Merged [start, end) intervals clipped to [lo, hi]."""
    merged = []
    for s, e, op in sorted(intervals, key=lambda x: x[0]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
                merged[-1][3] = op
        else:
            merged.append([s, e, op, op])
    return merged


def align(known: list[tuple[str, str]], names: list[str]) -> list[str]:
    """Modules of a call's ops `names`, from a call whose ops' modules are
    `known` [(name, module)]: ops that line up by name in launch order
    take their counterpart's module, the others the module that most often
    launched an op of their name."""
    import difflib

    by_name: dict = collections.defaultdict(collections.Counter)
    for n, m in known:
        by_name[n][m] += 1
    out = [by_name[n].most_common(1)[0][0] if by_name[n] else "unknown"
           for n in names]
    sm = difflib.SequenceMatcher(None, [n for n, _ in known], names,
                                 autojunk=False)
    for a, b, size in sm.get_matching_blocks():
        for k in range(size):
            out[b + k] = known[a + k][1]
    return out


def reduce(evs, modules: list[tuple[str, str]] | None,
           skip: int = 1) -> dict:
    """Records of a timing capture: calls, device ops with their module,
    busy and window seconds, idle gaps by what the host was launching.
    The first `skip` calls (the profiler's start-up) are left out."""
    calls, per_call, outside = launches_by_call(evs)
    fetches = _complete(evs, ("user_annotation",), FETCH)
    if len(calls) <= skip:
        return {"calls": 0, "idle_gaps": collections.Counter()}
    lo = calls[skip]["ts"]
    per_call = {i - skip: v for i, v in per_call.items() if i >= skip}
    calls = calls[skip:]
    hi = max([c["ts"] + c["dur"] for c in calls]
             + [f["ts"] + f["dur"] for f in fetches])
    ops = []
    for call_ops in per_call.values():
        for op, mod in zip(call_ops, align(modules or [],
                                           [o["name"] for o in call_ops])):
            op["module"] = mod
            ops.append(op)
    for op in outside:
        op["module"] = "portbench/fetch"
        ops.append(op)
    ops = [o for o in ops if o["ts"] + o["dur"] > lo and o["ts"] < hi]
    merged = _union([(o["ts"], o["ts"] + o["dur"], o) for o in ops], lo, hi)
    busy = sum(e - s for s, e, _, _ in merged)
    gaps: collections.Counter = collections.Counter()
    prev_end = lo
    for s, e, first, _ in merged:
        if s > prev_end:
            gaps["idle:" + first["module"]] += (s - prev_end) / 1e6
        prev_end = e
    if hi > prev_end:
        gaps["idle:portbench/loop"] += (hi - prev_end) / 1e6
    return {
        "calls": len(calls),
        "call_host_s": [c["dur"] / 1e6 for c in calls],
        "launches": sum(len(v) for v in per_call.values()),
        "ops": [{"name": o["name"], "module": o["module"],
                 "cat": o.get("cat"), "s": o["dur"] / 1e6} for o in ops],
        "busy_s": busy / 1e6,
        "window_s": (hi - lo) / 1e6,
        "idle_gaps": gaps,
    }


def layer(module: str) -> str:
    """The benchmark's layer of a program module."""
    if module.startswith("models/") or module == "ops/nms":
        return "detector"
    if module.startswith(("tracker/", "ops/", "kernels/")):
        return "tracker"
    if module.startswith("parallel/"):
        return "serve"
    return "harness" if module.startswith("portbench") else "unknown"


def breakdown(rec: dict, top: int = 10) -> dict:
    """The ten device ops that took most time and the ten longest idle
    gaps by what the host was launching."""
    by_op: collections.Counter = collections.Counter()
    for o in rec.get("ops", []):
        by_op[f"{layer(o['module'])}:{o['name'][:64]}"] += o["s"]
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in
                          collections.Counter(
                              rec.get("idle_gaps", {})).most_common(top)]}
