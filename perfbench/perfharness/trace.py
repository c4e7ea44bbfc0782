"""Spans and the profiled stretch of a traced run.

The harness opens a span around each call into a layer of the program,
only in a ``--trace 1`` run; a ``--trace 0`` run records nothing but the
end-to-end timings. Inside the profiled stretch each span is also a
``torch.profiler.record_function`` range, so the device's idle gaps can be
labelled by what the host was doing.

``Profile`` is what the metric readers see of the stretch: its length,
its device events as (name, start, end) in seconds on one clock, the host
spans on that clock, the waves it held, and whether it is ``short``: the
profiler on the card sometimes drops device events, and a stretch that
saw clearly fewer kernels than the program launched in it is recorded as
short, never read as an idle device.
"""
from __future__ import annotations

import contextlib
import sys
import dataclasses
import time
from typing import Dict, List, Tuple


#: the share of a kernel's launches the profiler has to have seen for the
#: stretch to count: on the H100 machine it drops about 1% of the events
#: of a busy stretch now and then (7 of 714 launches in one run), which
#: moves an idle share by hundredths of a point; more is a short trace
SEEN_SHARE = 0.98


@dataclasses.dataclass
class Profile:
    window_s: float
    waves: int
    device: List[Tuple[str, float, float]]       # kernels and copies
    spans: List[Tuple[str, float, float]]        # host spans, same clock
    launched: Dict[str, int]                     # program's own counts
    short: bool
    tries: int

    def kernels(self) -> List[Tuple[str, float, float]]:
        """Device events that are kernels (not copies or fills)."""
        return [e for e in self.device if not is_copy(e[0])]

    def busy_s(self) -> float:
        """Seconds of the stretch in which some device event ran (the union
        of their intervals, clipped to the stretch)."""
        return sum(b - a for a, b in busy_intervals(self.device))


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def busy_intervals(events) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def idle_gaps(profile: Profile) -> List[Tuple[float, float]]:
    """The stretch's intervals with no device event running."""
    gaps, t = [], 0.0
    for a, b in busy_intervals(profile.device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if profile.window_s > t:
        gaps.append((t, profile.window_s))
    return gaps


def seen_kernels(device, launched) -> Dict[str, int]:
    """Device events of each kernel name that the program counts."""
    return {k: sum(1 for n, _, _ in device if k in n) for k in launched}


def is_short(device, launched) -> bool:
    """No device event, or under ``SEEN_SHARE`` of some kernel's launches."""
    seen = seen_kernels(device, launched)
    return (not device) or any(seen[k] < SEEN_SHARE * v
                               for k, v in launched.items())


def label_at(spans, t: float) -> str:
    """The innermost host span open at ``t``, or ``other``."""
    best, width = "other", float("inf")
    for name, a, b in spans:
        if a <= t <= b and b - a < width:
            best, width = name, b - a
    return best


class Recorder:
    """Spans and set-up phases of one run. Disabled, a span is a no-op."""

    def __init__(self, enabled: bool, sync=None):
        self.enabled = enabled
        self.sync = sync or (lambda: None)
        self.spans: Dict[str, List[float]] = {}
        self.profiles: List[Profile] = []
        self.setup: Dict[str, float] = {}
        self._profiling = False

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the body on the host clock (after a device sync when
        ``sync``); in the profiled stretch, also mark it in the trace."""
        if not self.enabled:
            yield
            return
        ctx = contextlib.nullcontext()
        if self._profiling:
            from torch.profiler import record_function
            ctx = record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
            if sync:
                self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def phase(self, name: str):
        """A part of the set-up, timed in every run (``setup_split``)."""
        t0 = time.perf_counter()
        yield
        self.setup[name] = self.setup.get(name, 0.0) + time.perf_counter() - t0


class Stretch:
    """A profiled stretch: ``start()``, the waves, ``stop()``; ``result()``
    reads it once the window has closed (reading a trace takes seconds,
    which the window must not hold).

    ``result()`` marks the stretch short when the profiler saw fewer than
    ``SEEN_SHARE`` of the kernels of a name that the program counted
    launching (or no device event at all); the caller may then profile another stretch past the
    window, up to ``tries`` in all, and the last one is kept."""

    def __init__(self, rec: Recorder, torch, launch_counts, tries: int = 3):
        self.rec, self.torch = rec, torch
        self.launch_counts = launch_counts
        self.tries = tries
        self.n_tries = 0
        self._prof = None
        self._raw = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def warm_up(self):
        """The profiler's first start takes seconds (CUPTI's set-up): pay
        that before the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            self.torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self._before = dict(self.launch_counts())
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.rec._profiling = True
        self._t0 = time.perf_counter()
        self.waves = 0

    def wave(self):
        self.waves += 1

    def stop(self):
        self.torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self.rec._profiling = False
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        after = self.launch_counts()
        launched = {k: after[k] - self._before.get(k, 0) for k in after}
        self.n_tries += 1
        self._raw = (prof, window_s, launched, self.waves)

    def result(self) -> Profile:
        from torch.autograd import DeviceType

        prof, window_s, launched, waves = self._raw
        events = prof.events()
        # one clock for all, the profiler's: seconds from its first event.
        # Ranges the harness marked (record_function) come back on the
        # device's timeline too: they are host spans, not device work.
        names = set(self.rec.spans)
        starts = [e.time_range.start for e in events]
        t0 = min(starts) / 1e6 if starts else 0.0
        dev, spans = [], []
        for e in events:
            a = e.time_range.start / 1e6 - t0
            b = e.time_range.end / 1e6 - t0
            if e.name in names:
                if e.device_type == DeviceType.CPU:
                    spans.append((e.name, a, b))
                continue
            if e.device_type != DeviceType.CUDA:
                continue
            a, b = max(a, 0.0), min(b, window_s)
            if b > a:
                dev.append((e.name, a, b))
        seen = seen_kernels(dev, launched)
        short = is_short(dev, launched)
        p = Profile(window_s=window_s, waves=waves, device=dev,
                    spans=spans, launched=launched, short=short,
                    tries=self.n_tries)
        self.rec.profiles = [p]
        print(f"profile: try {self.n_tries}, {window_s:.4f} s, {waves} waves,"
              f" {len(dev)} device events, launched/seen "
              + ", ".join(f"{k} {v}/{seen[k]}" for k, v in launched.items()
                          if v or seen[k])
              + (" (short)" if short else ""), file=sys.stderr, flush=True)
        return p
