"""The device trace of a traced run: `torch.profiler` over a few runs of the
window's entry, exported as a Chrome trace and read back.

What is kept: every device operation (kernel, copy, set) inside the traced
window, with its time, and whether the host launched it inside one of the
program's `force` spans (the launch's correlation id ties the two); the
host's operations and spans on the launching thread, to name what the host
was doing while the device sat idle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

WINDOW_SPAN = "portbench.window"
FORCE_SPAN = "force"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class DeviceOp(NamedTuple):
    name: str
    start: float  # us, on the trace's clock
    dur: float  # us
    in_force: bool


class DeviceTrace(NamedTuple):
    ops: list  # DeviceOp inside the window
    window: tuple  # (start, end) us
    host: list  # (start, end, name) on the launching thread, by start
    unlinked: int  # device ops whose launch the trace lacks

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> list:
        """Union of the device ops' intervals, sorted, in us."""
        out = []
        for op in sorted(self.ops, key=lambda o: o.start):
            s, e = op.start, op.start + op.dur
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def gaps(self) -> list:
        """(seconds, host activity) of each idle stretch of the window: the
        innermost host operation running at the stretch's middle, or
        "python" where none runs (host ops on one thread nest)."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.busy() for t in iv] + [hi]
        out, stack, k = [], [], 0
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            t = 0.5 * (s + e)
            while k < len(self.host) and self.host[k][0] <= t:
                while stack and stack[-1][1] < self.host[k][0]:
                    stack.pop()
                stack.append(self.host[k])
                k += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(((e - s) * 1e-6, stack[-1][2] if stack else "python"))
        return out


def capture(fn):
    """Run fn() under torch.profiler (host and device), inside a span that
    marks the window. Returns (fn's result, DeviceTrace)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            result = fn()
            torch.cuda.synchronize()
    return result, parse(records(prof))


def records(prof) -> list:
    """The profiler's events, exported as a Chrome trace and read back.
    (Torch's own reading of them when the profiler stops takes most of a
    trace's cost; the export and this read take a tenth of it.)"""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


def _spans(events, name):
    out = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == name)
    return out


def _inside(t: float, spans: list, starts: list) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= spans[k][1]


def parse(events: list) -> DeviceTrace:
    """A DeviceTrace from Chrome trace events (dicts with ph "X")."""
    events = [e for e in events if e.get("ph") == "X"]
    window = _spans(events, WINDOW_SPAN)
    if not window:
        raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
    lo, hi = window[0]
    tid = next(e["tid"] for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation")
    force = _spans(events, FORCE_SPAN)
    fstarts = [s for s, _ in force]
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    ops, unlinked = [], 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0))
        if s + d < lo or s > hi:
            continue
        t_launch = launch.get(e.get("args", {}).get("correlation"))
        if t_launch is None:
            unlinked += 1
        in_force = t_launch is not None and _inside(t_launch, force, fstarts)
        s0, s1 = max(s, lo), min(s + d, hi)
        ops.append(DeviceOp(e.get("name", "?"), s0, s1 - s0, in_force))
    host = sorted(((float(e["ts"]), float(e["ts"] + e.get("dur", 0)), e.get("name", "?"))
                   for e in events if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != WINDOW_SPAN and e["ts"] <= hi
                   and e["ts"] + e.get("dur", 0) >= lo),
                  key=lambda h: (h[0], -h[1]))  # an enclosing op before its first child
    return DeviceTrace(ops, (lo, hi), host, unlinked)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and parameter
    list: "void at::native::k<4, at::native::F<float> >(int, ...)" ->
    "k<4, F<float> >"."""
    name = name.removeprefix("void ")
    for ns in ("(anonymous namespace)::", "at::native::"):
        name = name.replace(ns, "")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def breakdown(trace: DeviceTrace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, in seconds, at most `top` of each."""
    dev = defaultdict(float)
    for op in trace.ops:
        dev[short_name(op.name)] += op.dur * 1e-6
    idle = defaultdict(float)
    for sec, name in trace.gaps():
        idle[name] += sec

    def most(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": most(dev), "idle_gaps": most(idle)}
