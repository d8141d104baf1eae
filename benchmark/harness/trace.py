"""One profiled request or pair of steps, read from torch.profiler's raw
(Kineto) events in memory; no trace file is written.

- busy: the union of device activity intervals (kernels, copies, sets);
  the window: host time from the profiled call's start to its end. Both
  from a pass that traces device activity alone: the host's ops, traced,
  slow a host-paced step (twice over for training's dispatch modes), and
  even device activity alone lengthens it, so the idle share sets busy
  against the untraced window's time for the same work
  (``untraced_wall``).
- device ops: device time summed by kernel name, the ten largest.
- idle gaps (a second pass, host ops traced too): device time with
  nothing running, each gap named by the innermost host range or op open
  at its start (the host was in it), summed by name, the ten largest;
  their seconds include the tracing's own host time.
- blocks: ``BlockRanges`` wraps every call of the chosen module classes in
  a ``record_function`` range named ``bench::<label>`` and records its
  operations and bytes (``counts.py``). A kernel belongs to a block when
  the host call that launched it (the runtime event of the same
  correlation id) started inside that block's range: this holds for the
  port's own kernels, launched through ctypes, as for aten's.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple


class BlockRanges:
    """Forward pre/post hooks on each module of ``classes`` (label ->
    (class, counter)): a ``record_function`` range around the call and the
    call's least time from ``counter(module, args)`` -> (flops, bytes)."""

    def __init__(self, root, classes: Dict[str, Tuple[type, Callable]],
                 least_s: Callable[[float, float], float]):
        import torch

        self.least = defaultdict(float)
        self._open = []
        self._handles = []
        for mod in root.modules():
            for label, (cls, counter) in classes.items():
                if isinstance(mod, cls):
                    def pre(m, args, label=label, counter=counter):
                        flops, nbytes = counter(m, args)
                        self.least[label] += least_s(flops, nbytes)
                        rf = torch.profiler.record_function(f"bench::{label}")
                        rf.__enter__()
                        self._open.append(rf)

                    def post(m, args, out):
                        self._open.pop().__exit__(None, None, None)

                    self._handles += [mod.register_forward_pre_hook(pre),
                                      mod.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")


def _kind(ev):
    """The event's activity type, where this torch's events give it."""
    try:
        return ev.activity_type()
    except AttributeError:
        return None


def _on_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def classify(events):
    """(device work, host events, launch calls). Device work is kernels,
    copies and sets, not the ranges the profiler mirrors onto the device's
    timeline: where the events give no activity type, a device event named
    as a host event is such a mirror. Launch calls are the CUDA runtime and
    driver calls (by type, else by a name that begins with "cu")."""
    host = [e for e in events if not _on_device(e)]
    host_names = {e.name() for e in host}
    dev, launches = [], []
    for e in events:
        kind = _kind(e)
        if _on_device(e):
            if (kind in DEVICE_WORK if kind is not None
                    else e.name() not in host_names):
                dev.append(e)
        elif (kind in LAUNCH_CALLS if kind is not None
              else e.name().startswith("cu")) and e.correlation_id():
            launches.append(e)
    return dev, host, launches


def profile(fn: Callable[[], object], host: bool = True) -> dict:
    """Run ``fn`` under the profiler and reduce the events: device activity
    alone (``host`` False: the least added host time, for busy and the
    window), or with the host's ops and ranges too (for naming idle gaps
    and linking kernels to blocks)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        fn()
        sync()
        wall_ns = time.perf_counter_ns() - t0
    events = prof.profiler.kineto_results.events()
    return reduce_events(events, wall_ns)


def device_pass(reduced: dict) -> dict:
    """What the device-only pass gives the result: busy, window, ops."""
    return {k: reduced[k] for k in ("busy_s", "window_s", "device_ops",
                                    "device_events")}


def untraced_wall(run):
    """The measured window's host seconds for the work the profile covered
    (its ``units``: clips or steps); None where the window completed
    none."""
    if not run.units:
        return None
    return run.window_s / run.units * run.trace["units"]


def log_busy(run) -> None:
    """Busy against both walls: the profiled call's and the untraced
    window's for the same work."""
    from benchmark.harness import core

    tr, wall = run.trace, untraced_wall(run)
    msg = (f"trace: busy {tr['busy_s']:.4f} s; profiled wall "
           f"{tr['window_s']:.4f} s (idle "
           f"{(1 - tr['busy_s'] / tr['window_s']) * 100:.2f} %)")
    if wall:
        msg += (f"; untraced wall {wall:.4f} s (idle "
                f"{(1 - tr['busy_s'] / wall) * 100:.2f} %)")
    core.log(msg)


def reduce_events(events, wall_ns: int) -> dict:
    dev, host, launches = classify(events)
    # device intervals (ns) and their union
    iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev
                if e.duration_ns() > 0)
    merged: List[List[int]] = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_ns = sum(t - s for s, t in merged)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name()] += e.duration_ns() / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # host ranges: name each idle gap by the innermost one open at its start
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in host if e.duration_ns() > 0),
                   key=lambda r: r[0])
    starts = [s for s, _, _ in spans]
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, a) - 1
        name = "(no host range)"
        # the latest-starting span that still covers a (bounded look-back)
        for j in range(i, max(-1, i - 2000), -1):
            s, t, n = spans[j]
            if t >= a:
                name = n
                break
        gaps[name] += (b - a) / 1e9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    # kernels inside bench:: ranges, by the launching runtime call's start
    launch_at = {}
    for e in launches:
        launch_at.setdefault(e.correlation_id(), e.start_ns())
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name()[len("bench::"):]) for e in host
                    if e.name().startswith("bench::"))
    rstarts = [r[0] for r in ranges]
    block_dev = defaultdict(float)
    linked = 0
    for e in dev:
        at = launch_at.get(e.correlation_id())
        if at is None:
            continue
        i = bisect.bisect_right(rstarts, at) - 1
        if i >= 0 and ranges[i][1] >= at:
            block_dev[ranges[i][2]] += e.duration_ns() / 1e9
            linked += 1
    return {"busy_s": busy_ns / 1e9, "window_s": wall_ns / 1e9,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle],
            "block_device_s": dict(block_dev), "linked_kernels": linked,
            "device_events": len(dev)}
