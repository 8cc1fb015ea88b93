"""The program's spans in a device trace: which named host spans were open
at a time, how much of a set of intervals falls inside a span, and each
device operation tied to the launch call that queued it.

The spans are the program's `tracing.region` names (mdbench_tpu_torch's
tracing.py lists them), recorded by the profiler as host events on the
launching thread, which `DeviceTrace.host` keeps. A device operation's
launch is kept there too, as a CUDA API call, but `DeviceOp` says
only whether it lay in a `force` span. The program queues everything on
one stream, and the device runs one stream's operations in the order the
host launched them; so the device's operations, in order, are the host's
launches in order, less those whose operations devtrace left out of the
window: the device's clock, mapped onto the host's, can run early by
microseconds to milliseconds, which puts the first operations before the
window's start (and never before their launches in fact). `tie` finds the
one run of consecutive launches that fits the operations, each launch of
the operation's kind (kernel, copy, set) and inside a `force` span exactly
when devtrace tied the operation to one by correlation id. Where devtrace
found an operation without a launch, a graph launch queued many at once,
or no run or more than one fits, it ties nothing, and says why on the
standard error, once a trace. (Times are no check for the same reason.)
"""

from __future__ import annotations

import sys

from portbench.devtrace import FORCE_SPAN, DeviceTrace, _inside

REBUILD = ("reneighbor",)
PRUNE = ("reneighbor.prune",)
STEP = ("integrate", "halo_update", "thermo")

# the CUDA API calls (`cuda*`, and the lower `cu*`) that queue device work
# (a "_ptsz" / "_ptds" suffix marks the per-thread default stream's forms)
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                   "cuLaunchCooperativeKernel")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
COPY_PREFIXES = ("cudaMemcpy", "cuMemcpy")
SET_PREFIXES = ("cudaMemset", "cuMemset")


def launch_kind(name: str):
    """"kernel", "copy", "set" or "graph" for a call that queues device
    work, else None."""
    base = name.removesuffix("_ptsz").removesuffix("_ptds")
    if base in KERNEL_LAUNCHES:
        return "kernel"
    if base in GRAPH_LAUNCHES:
        return "graph"
    if base.startswith(COPY_PREFIXES):
        return "copy"
    if base.startswith(SET_PREFIXES):
        return "set"
    return None


def op_kind(name: str) -> str:
    """What a device operation is, from the name the profiler gives it."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


def launches(trace: DeviceTrace) -> list:
    """(start, kind) of each host call that queued device work, in host
    order; a call inside another (a `cudaLaunchKernel`'s own `cuLaunchKernel`)
    counts once, as the outer one."""
    out, open_until = [], float("-inf")
    for s, e, name in trace.host:
        kind = launch_kind(name)
        if kind is None or s < open_until:
            continue
        out.append((s, kind))
        open_until = e
    return out


def intervals(trace: DeviceTrace, names) -> list:
    """The union of the host intervals of the spans called any of `names`,
    sorted, as [start, end] lists in us."""
    spans = sorted((s, e) for s, e, n in trace.host if n in names)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def open_at(trace: DeviceTrace, t: float, names) -> list:
    """Those of `names` whose spans were open at time t (us)."""
    out = []
    for name in names:
        ivs = intervals(trace, (name,))
        if _inside(t, ivs, [s for s, _ in ivs]):
            out.append(name)
    return out


def overlap_us(ivs: list, trace: DeviceTrace, names) -> float:
    """How much of the disjoint intervals `ivs` ([start, end] in us) falls
    inside the host intervals of the spans called any of `names`, in us."""
    spans = intervals(trace, names)
    total, k = 0.0, 0
    for s, e in sorted(ivs):
        while k < len(spans) and spans[k][1] <= s:
            k += 1
        j = k
        while j < len(spans) and spans[j][0] < e:
            total += min(e, spans[j][1]) - max(s, spans[j][0])
            j += 1
    return total


def idle(trace: DeviceTrace) -> list:
    """The window's stretches in which no operation ran on the device, as
    [start, end] lists in us."""
    lo, hi = trace.window
    edges = [lo] + [t for iv in trace.busy() for t in iv] + [hi]
    return [[s, e] for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def idle_share(trace: DeviceTrace, names):
    """Share of the window in which the device was idle while the host was
    inside a span called any of `names`, %; None where the trace has no
    such span."""
    if trace.window_s <= 0 or not intervals(trace, names):
        return None
    return 100.0 * overlap_us(idle(trace), trace, names) * 1e-6 / trace.window_s


_last = [None, None]  # the last trace `tie` read, and its pairs


def tie(trace: DeviceTrace):
    """[(DeviceOp, launch start in us)] for every device operation of the
    window, or None where the pairing fails its checks (module
    docstring)."""
    if _last[0] is not trace:
        pairs, why = _tie(trace)
        if why:
            print(f"spans.tie: no device op tied to its launch: {why}",
                  file=sys.stderr, flush=True)
        _last[:] = trace, pairs
    return _last[1]


def _tie(trace: DeviceTrace):
    """(pairs, None), or (None, why the pairing failed)."""
    calls = launches(trace)
    if trace.unlinked:
        return None, f"{trace.unlinked} device ops have no launch in the trace"
    graphs = sum(kind == "graph" for _, kind in calls)
    if graphs:
        return None, f"{graphs} graph launches queue ops that cannot be counted"
    force = intervals(trace, (FORCE_SPAN,))
    fstarts = [s for s, _ in force]
    ops = sorted(trace.ops, key=lambda op: op.start)
    want = [(op_kind(op.name), op.in_force) for op in ops]
    got = [(kind, _inside(t, force, fstarts)) for t, kind in calls]
    fits = [p for p in range(len(got) - len(want) + 1)
            if all(got[p + k] == w for k, w in enumerate(want))]
    if len(fits) != 1:
        return None, (f"{len(fits)} runs of the {len(got)} launches fit the "
                      f"{len(want)} ops, not one")
    return [(op, t) for op, (t, _) in zip(ops, calls[fits[0]:])], None


def device_us(trace: DeviceTrace, names):
    """Device us of the operations launched inside a span called any of
    `names`; None where the trace has no such span or `tie` fails."""
    ivs = intervals(trace, names)
    if not ivs:
        return None
    pairs = tie(trace)
    if pairs is None:
        return None
    starts = [s for s, _ in ivs]
    return sum(op.dur for op, t in pairs if _inside(t, ivs, starts))
