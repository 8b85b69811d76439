"""Spans and wait counters of the device search path.

``FAC_TIME=1``, read once where a search starts (:func:`search`, the root,
which ``ops/engine.DeviceEngine.search_raw`` enters), traces that search.
Each span keeps ``[name, parent index, start_ns, end_ns, attrs]`` on
``time.perf_counter_ns()``; all spans of a search share its id, a
process-wide counter. Under ``torch.profiler`` each span is also a
``record_function`` range ``fac:<name>``, so the chrome trace puts every
kernel and every idle gap of the card under the innermost span the host
was in, and a :func:`timed` block (the hit-list scan's launches, up to its
count's read) records a CUDA event pair too: ``attrs["device_ms"]`` of the
span it sits in, the stream's time between the two, a second source of the
scan's device time where the profiler drops its kernels. The events are
read once the search is over, after its rows' copy has synchronised: they
add no synchronise. At the end of the search the spans go into
``engine.last_stats["spans"]``, with ``search_id``, ``prepare_us`` and
``host_wait_us``.

While the switch is off, a span site tests a thread-local and returns one
shared null context: no span is made, no profiler op runs, no event is
recorded. :func:`wait` still counts, since ``host_waits`` (the search's
blocking device-to-host reads) is in ``last_stats`` on every search.

The spans, from the root down (PERF.md §3 names the metric each feeds):

- ``search``: the root; attrs ``lane`` (the backend) and ``bytes``;
- ``prepare``: from the root's start to the first launch (:func:`launch`):
  the grapheme view, the lane's plan and budgets, its inputs, the tables'
  caches, and ``residency`` (``utils/device_corpus``; attrs ``hit`` or
  ``upload`` bytes);
- ``hit_list``: a chunk's or slice's hit-list scan (``packed_hits``;
  ``device_ms`` under the profiler), and ``step``: its step (``many_step``
  ranges, ``dp_pipeline_ranges``, the exact lane's field expansion); attrs
  ``slice`` (their order in the search), ``hits``, ``candidates``,
  ``rows``;
- ``host_wait``: one blocking device-to-host read; attrs ``what`` and, for
  the rows' copies, ``bytes``;
- ``finish``: from the end of the device stage to the return: the rows'
  copies, the concatenation, ``decode`` (``ops/emit.decode_matches``, with
  ``decode:filter``, ``decode:sort``, ``decode:offsets``, ``decode:build``)
  and ``last_stats``;
- ``timing_sync``: the synchronise after the device stage that only a
  traced search makes, so that ``dispatch_ms`` reads host clock to a
  synchronise; the tracing's own wait, not counted in ``host_waits``.

The beam lanes make the root span alone (:func:`opaque`); the sharded
lanes (``parallel/shard_search``), which do not pass through
``DeviceEngine.search_raw``, make none. The stream lanes search each window
through it. Searches run from threads (``stream.py``'s window pool), so the
state is per thread.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

import torch

#: Spans numbered in their order in the search (``slice``).
SLICED = ("hit_list", "step")

_IDS = itertools.count(1)


class _State(threading.local):
    #: The current search's recorder while tracing is on, else None.
    rec = None
    #: Blocking device-to-host reads on this thread (all searches).
    waits = 0
    #: The current search runs a lane without spans (:func:`opaque`).
    opaque = False


_TLS = _State()


class _Null:
    """The span of a search that is not traced: does nothing, is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("rec", "i", "name", "attrs")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.i = self.rec.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.i)
        return False

    def set(self, **attrs):
        self.rec.spans[self.i][4].update(attrs)


class _Recorder:
    """The spans of one traced search."""

    def __init__(self, sid: int, profile: bool):
        self.id = sid
        self.profile = profile
        self.spans = []
        self.stack = []
        self.ranges = {}
        self.events = {}
        self.counts = {}
        self.prepare = None

    def open(self, name: str, attrs=None) -> int:
        i = len(self.spans)
        attrs = dict(attrs) if attrs else {}
        if name in SLICED:
            attrs["slice"] = self.counts.get(name, 0)
            self.counts[name] = attrs["slice"] + 1
        parent = self.stack[-1] if self.stack else -1
        self.spans.append([name, parent, time.perf_counter_ns(), None, attrs])
        self.stack.append(i)
        if self.profile:
            # ``record_function`` itself: torch's private C entries for it
            # cost less a range, but the caller's own ``record_function``
            # range then took 40-50 us more to end, outside every span.
            rf = self.ranges[i] = torch.profiler.record_function("fac:" + name)
            rf.__enter__()
        return i

    def close(self, i: int) -> None:
        if self.profile:
            self.ranges.pop(i).__exit__(None, None, None)
        self.spans[i][3] = time.perf_counter_ns()
        self.stack.remove(i)

    def device_times(self) -> None:
        """``device_ms`` of each span with a :func:`timed` block, from its
        event pair. Read where the end event has completed (the search's
        last copy to the host waited for it)."""
        for i, (start, end) in self.events.items():
            if end.query():
                self.spans[i][4]["device_ms"] = start.elapsed_time(end)
        self.events.clear()


def _event(dev):
    """A timing event recorded on ``dev``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


class _Timed:
    """An event pair around launches on ``dev`` (:func:`timed`)."""

    __slots__ = ("rec", "dev", "start")

    def __init__(self, rec, dev):
        self.rec, self.dev = rec, dev

    def __enter__(self):
        self.start = _event(self.dev)
        return self

    def __exit__(self, *exc):
        self.rec.events[self.rec.stack[-1]] = (self.start, _event(self.dev))
        return False


class _Root:
    """The root span of a search (:func:`search`)."""

    __slots__ = ("engine", "nbytes", "rec", "waits")

    def __init__(self, engine, nbytes):
        self.engine, self.nbytes = engine, nbytes

    def __enter__(self):
        t = _TLS
        self.waits = t.waits
        self.rec = None
        if os.environ.get("FAC_TIME") == "1":
            rec = self.rec = t.rec = _Recorder(next(_IDS), torch.autograd._profiler_enabled())
            rec.open("search", {"bytes": self.nbytes})
            rec.prepare = rec.open("prepare")
        return self

    def __exit__(self, exc_type, *exc):
        t = _TLS
        rec, t.rec = self.rec, None
        opaque, t.opaque = t.opaque, False
        stats = self.engine.last_stats
        if exc_type is None and stats is not None and not opaque:
            stats["host_waits"] = t.waits - self.waits
        if rec is None:
            return False
        # ``prepare`` where no launch ended it, and whatever an exception left
        # open; the root last, so that its range holds the tracing's own work.
        for i in reversed(rec.stack[1:]):
            rec.close(i)
        rec.device_times()
        spans = rec.spans
        if exc_type is None and stats is not None:
            spans[0][4]["lane"] = stats.get("backend")
            stats.update(search_id=rec.id, spans=spans,
                         prepare_us=sum(s[3] - s[2] for s in spans if s[0] == "prepare") / 1e3,
                         host_wait_us=sum(s[3] - s[2] for s in spans
                                          if s[0] == "host_wait") / 1e3)
        rec.close(0)
        return False


def search(engine, haystack: str) -> _Root:
    """The root of a device search on ``engine``: traces it where
    ``FAC_TIME=1``, and puts ``host_waits`` (and, traced, the spans) into
    ``engine.last_stats`` at its end."""
    return _Root(engine, len(haystack) if haystack.isascii() else None)


def span(name: str):
    """A span of the current search, or :data:`NULL` where it is not traced
    (false: test it before ``set(**attrs)``)."""
    rec = _TLS.rec
    if rec is None:
        return NULL
    return _Span(rec, name, None)


def timed(dev):
    """Launches on ``dev`` to time by a CUDA event pair, with no host read
    among them: their stream time becomes ``device_ms`` of the innermost
    span. :data:`NULL` unless the search is traced under the profiler on a
    CUDA device."""
    rec = _TLS.rec
    if rec is None or not rec.profile or dev.type != "cuda":
        return NULL
    return _Timed(rec, dev)


def wait(what: str, nbytes: int = 0):
    """A blocking device-to-host read: counted on every search, a
    ``host_wait`` span where the search is traced."""
    t = _TLS
    t.waits += 1
    rec = t.rec
    if rec is None:
        return NULL
    return _Span(rec, "host_wait", {"what": what, "bytes": nbytes} if nbytes else {"what": what})


def launch() -> None:
    """The search's first launch is next: ends ``prepare`` (where it is the
    innermost open span)."""
    rec = _TLS.rec
    if rec is not None and rec.prepare is not None and rec.stack[-1] == rec.prepare:
        rec.close(rec.prepare)
        rec.prepare = None


def opaque() -> None:
    """The search runs a lane without spans of its own (the beam lanes): ends
    ``prepare``, and leaves ``host_waits`` out of its ``last_stats``, which
    would count only the reads of the shared functions it calls."""
    launch()
    _TLS.opaque = True


def timing_sync(device) -> None:
    """Where the search is traced, wait for ``device``'s queued work in a
    ``timing_sync`` span (a CUDA device; nothing to wait for on the CPU)."""
    rec = _TLS.rec
    if rec is None:
        return
    with _Span(rec, "timing_sync", None):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def mark() -> int:
    """Where the spans of a stage begin (:func:`stage_stats`)."""
    rec = _TLS.rec
    return 0 if rec is None else len(rec.spans)


def stage_stats(at: int, parts) -> dict:
    """The ``FAC_TIME=1`` stage keys of the DP and many lanes' ``last_stats``
    (the JAX package's), from the spans since :func:`mark` ``at``, in ms to
    0.1: ``dispatch_ms`` from the first ``hit_list`` or ``step`` to the end
    of ``timing_sync`` (device work, synchronised), ``readback_ms`` the
    rows' copies (``host_wait`` spans of ``what="rows"``), ``decode_ms`` the
    ``decode`` span; and ``result_buf_kib``, the KiB of the rows' host
    arrays ``parts``. Empty where the search is not traced."""
    rec = _TLS.rec
    if rec is None:
        return {}
    spans = rec.spans[at:]
    t0 = next(s[2] for s in spans if s[0] in SLICED)
    t1 = next(s[3] for s in spans if s[0] == "timing_sync")
    ms = lambda ns: round(ns / 1e6, 1)
    return {
        "dispatch_ms": ms(t1 - t0),
        "readback_ms": ms(sum(s[3] - s[2] for s in spans
                              if s[0] == "host_wait" and s[4]["what"] == "rows")),
        "decode_ms": ms(next(s[3] - s[2] for s in spans if s[0] == "decode")),
        "result_buf_kib": sum(p.nbytes for p in parts) >> 10,
    }
