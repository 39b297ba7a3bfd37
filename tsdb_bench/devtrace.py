"""The traced run's device trace and host spans.

`Recorder` wraps the measured window of a `--trace 1` run:
`torch.profiler` records every kernel, copy and set on the device (CUPTI),
and a tee in front of the program's span sink (`telemetry.set_span_sink`)
keeps the name, start and end of every span the program closes, as they
pass to the sink the program had. A `user_annotation` made at a known
`time.monotonic()` puts the trace's clock on the host's.

`DeviceTrace` holds what the readers and the breakdown use: the device
intervals clipped to the window, their union (`busy_s`), time by
operation, and the idle gaps named by the innermost program span that
was open in their middle.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "tsdb_bench.clock_mark"
NO_SPAN = "no program span (client, Flight, GIL)"


class _SpanTee:
    """Keeps (name, start, end) of each span, then hands it on."""

    def __init__(self, inner):
        self.inner = inner
        self.spans: List[Tuple[str, float, float]] = []
        # span starts are perf_counter readings; the window is monotonic
        self.shift = time.monotonic() - time.perf_counter()

    def on_span_end(self, s, elapsed_ms, status):
        start = s["start"] + self.shift
        self.spans.append((s["name"], start, start + elapsed_ms / 1e3))
        if self.inner is not None:
            self.inner.on_span_end(s, elapsed_ms, status)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """The device's operations and the program's spans of one window,
    on the host's `time.monotonic()` clock."""

    def __init__(self, ops: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]], t0: float, t1: float):
        self.window_s = t1 - t0
        self.ops = [(n, max(a, t0), min(b, t1)) for n, a, b in ops
                    if b > t0 and a < t1]
        self.busy = _union([(a, b) for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in self.busy)
        self.spans = spans
        self.t0, self.t1 = t0, t1

    def op_seconds(self) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for n, a, b in self.ops:
            by[n] = by.get(n, 0.0) + (b - a)
        return sorted(by.items(), key=lambda kv: -kv[1])

    def gaps(self) -> List[Tuple[float, float]]:
        out, at = [], self.t0
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def gap_seconds_by_span(self) -> List[Tuple[str, float]]:
        spans = sorted(self.spans, key=lambda s: s[1])
        by: Dict[str, float] = {}
        for a, b in self.gaps():
            mid = (a + b) / 2
            inner = None
            for name, s0, s1 in spans:
                if s0 > mid:
                    break
                if s1 >= mid and (inner is None or s0 >= inner[1]):
                    inner = (name, s0)
            label = inner[0] if inner is not None else NO_SPAN
            by[label] = by.get(label, 0.0) + (b - a)
        return sorted(by.items(), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:160], s] for n, s in
                               self.op_seconds()[:10]],
                "idle_gaps": [[n, s] for n, s in
                              self.gap_seconds_by_span()[:10]]}


class Recorder:
    """The profiler and the span tee over a traced window."""

    def __init__(self, work_dir: str):
        self.path = os.path.join(work_dir, "trace.json")
        self.prof = None
        self.tee: Optional[_SpanTee] = None

    def start(self) -> None:
        import torch
        from greptimedb_tpu_torch.common import telemetry
        self.tee = _SpanTee(telemetry._SPAN_SINK[0])
        telemetry.set_span_sink(self.tee)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def close(self) -> None:
        """Stop a recording that `stop` did not end (a failed run)."""
        if self.prof is not None:
            from greptimedb_tpu_torch.common import telemetry
            self.prof.stop()
            telemetry.set_span_sink(self.tee.inner)
            self.prof = None

    def stop(self, t0: float, t1: float) -> DeviceTrace:
        import torch
        from greptimedb_tpu_torch.common import telemetry
        with torch.profiler.record_function(MARK):
            mark = time.monotonic()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        telemetry.set_span_sink(self.tee.inner)
        prof, self.prof = self.prof, None
        prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(self.path)
        shift = None
        for e in events:
            if e.get("name") == MARK and e.get("ph") == "X":
                shift = mark - float(e["ts"]) / 1e6
                break
        if shift is None:
            raise RuntimeError("the trace lacks the clock mark")
        ops = [(e.get("name", "?"), float(e["ts"]) / 1e6 + shift,
                (float(e["ts"]) + float(e.get("dur", 0.0))) / 1e6 + shift)
               for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        return DeviceTrace(ops, self.tee.spans, t0, t1)
