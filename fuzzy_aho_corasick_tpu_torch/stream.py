"""Streaming fuzzy search and replace over a byte reader
(reference: src/stream.rs); a copy of the JAX package's ``stream``.

Constant-memory windowed scan of arbitrarily large inputs with absolute
``u64`` byte offsets. Windows overlap by ``max_match_graphemes() + 1``
graphemes so no match is ever split, and each window *owns* the matches whose
start falls before its commit boundary — exactly-once emission with zero
cross-window communication (reference src/stream.rs:9-13, 262-297).

The reference parallelizes windows across a ``std::thread`` pool
(src/stream.rs:378-429); here windows are batched into a single device
search (the engine's kernels already run over all start positions), so
``search_stream_parallel`` keeps the reference's exactly-once/ordering
semantics while the parallelism lives inside the CUDA kernels. A batch joins
at most the windows that one ``search_raw`` serves on its resident lanes
(``RESIDENT_MAX`` graphemes). The parallel
replace runs its device searches on a worker thread, with the engine's
device made current there.
"""

from __future__ import annotations

import contextlib
import io
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

import torch

from .options import SearchOptions
from .structs import FuzzyMatch, NumEdits

_MISSING = object()  # sentinel: _separator_char caches None (= no free char)

#: Default per-window byte target (reference src/stream.rs:65).
DEFAULT_WINDOW = 4 * 1024 * 1024
#: Smallest read a window makes (so a window holds fewer than ``window`` +
#: ``READ_MIN`` bytes).
READ_MIN = 64 * 1024


@dataclass
class StreamMatch:
    """A match with absolute (stream-wide) byte offsets, owning its text
    (reference src/stream.rs:38-60)."""

    start: int
    end: int
    pattern_index: int
    similarity: float
    insertions: NumEdits
    deletions: NumEdits
    substitutions: NumEdits
    swaps: NumEdits
    edits: NumEdits
    text: str


class _StreamWindow:
    """An owned window: covers global bytes [base, base + len(data)); owns
    matches whose start byte is < commit (reference src/stream.rs:67-73).

    Carries the raw bytes; ``text`` decodes lazily — the table-replacement
    emit path and the byte-based batch plumbing never need the str, and the
    per-window decode was the producer thread's single largest cost."""

    __slots__ = ("base", "data", "commit", "_text")

    def __init__(self, base: int, data: bytes, commit: int, text=None):
        self.base = base
        self.data = data
        self.commit = commit
        self._text = text

    @property
    def text(self) -> str:
        if self._text is None:
            self._text = self.data.decode("utf-8")
        return self._text

    @property
    def nbytes(self) -> int:
        return len(self.data)


class WindowReader:
    """Cuts a byte stream into owned, overlapping windows at grapheme-boundary
    commit points; UTF-8-partial-codepoint safe; auto-grows when the overlap
    doesn't fit (reference src/stream.rs:76-159)."""

    def __init__(self, reader, window: int, overlap_graphemes: int):
        self.reader = _as_reader(reader)
        self.buf = bytearray()
        self.base = 0
        self.total = 0
        self.window = window
        self.overlap_graphemes = overlap_graphemes
        self.done = False

    def next_window(self) -> Optional[_StreamWindow]:
        if self.done:
            return None
        from .utils.graphemes import graphemes

        while True:
            while len(self.buf) < self.window:
                chunk = self.reader.read(
                    max(READ_MIN, self.window - len(self.buf))
                )
                if not chunk:
                    break
                self.buf.extend(chunk)
                self.total += len(chunk)
            eof = len(self.buf) < self.window

            raw = bytes(self.buf)
            if raw.isascii():
                # ASCII fast lane: always-valid, byte == grapheme — no
                # full-window decode on the producer thread (the decode is
                # lazy on _StreamWindow.text for consumers that need it).
                text, valid = None, len(raw)
                data = raw
            else:
                # Search only the valid-UTF-8 prefix; a trailing partial
                # code point waits for more bytes (reference
                # src/stream.rs:117-122).
                text, valid = _valid_utf8_prefix(raw)
                data = raw[:valid]

            if eof:
                self.done = True
                return _StreamWindow(self.base, data, valid, text)

            # Commit boundary (a byte offset): keep the last overlap_graphemes
            # graphemes so no match is split (reference src/stream.rs:133-147).
            commit = _commit_boundary(data, self.overlap_graphemes)
            if commit is None or commit <= 0:
                self.window += max(self.window, READ_MIN)
                continue
            out = _StreamWindow(self.base, data, commit, text)
            del self.buf[:commit]
            self.base += commit
            return out


def _as_reader(reader):
    if isinstance(reader, (bytes, bytearray)):
        return io.BytesIO(bytes(reader))
    if isinstance(reader, str):
        return io.BytesIO(reader.encode("utf-8"))
    return reader


def _valid_utf8_prefix(buf: bytes) -> tuple[str, int]:
    try:
        return buf.decode("utf-8"), len(buf)
    except UnicodeDecodeError as e:
        valid = e.start
        return buf[:valid].decode("utf-8"), valid


def _commit_boundary(text, overlap_graphemes: int) -> Optional[int]:
    """Byte offset of the start of the trailing ``overlap_graphemes``-th
    grapheme, or None when the text is too small (reference
    src/stream.rs:133-147). Accepts str or valid-UTF-8 bytes — only the tail
    is ever decoded/segmented."""
    from .utils.graphemes import graphemes

    # Only the suffix needs segmenting: a grapheme cluster is at most a few
    # hundred bytes in practice, but clusters are unbounded in theory, so
    # widen the tail until enough clusters are found (mirrors the reference's
    # reverse iterator, which is O(overlap)).
    tail_bytes = max(overlap_graphemes * 8, 256)
    b = text.encode("utf-8") if isinstance(text, str) else text
    n = len(b)
    while True:
        lo = max(0, n - tail_bytes)
        # Align lo down to a UTF-8 boundary.
        while lo > 0 and (b[lo] & 0xC0) == 0x80:
            lo -= 1
        tail = b[lo:].decode("utf-8")
        gs = graphemes(tail)
        if len(gs) > overlap_graphemes or lo == 0:
            if len(gs) < overlap_graphemes:
                return None  # too small to make progress
            # Offset of the grapheme that starts the overlap region.
            keep = gs[len(gs) - overlap_graphemes :]
            off = n - sum(len(g.encode("utf-8")) for g in keep)
            if off <= 0:
                return None
            return off
        tail_bytes *= 2


def _window_matches(engine, text: str, base: int, commit: int, threshold: float, out: List[StreamMatch]) -> None:
    """Window-local matches -> owned StreamMatches with absolute offsets,
    keeping only starts < commit (reference src/stream.rs:262-297)."""
    matches = engine.search(
        text,
        SearchOptions.new().with_threshold(threshold).sorted().non_overlapping(),
    )
    for m in matches:
        if m.start < commit:
            out.append(
                StreamMatch(
                    start=base + m.start,
                    end=base + m.end,
                    pattern_index=m.pattern_index,
                    similarity=m.similarity,
                    insertions=m.insertions,
                    deletions=m.deletions,
                    substitutions=m.substitutions,
                    swaps=m.swaps,
                    edits=m.edits,
                    text=m.text,
                )
            )


def search_stream(engine, reader, threshold: float, on_match: Callable[[StreamMatch], None]) -> int:
    """Single-threaded streaming search; returns total bytes read
    (reference src/stream.rs:319-335)."""
    wr = WindowReader(reader, DEFAULT_WINDOW, engine.stream_overlap())
    batch: List[StreamMatch] = []
    while True:
        w = wr.next_window()
        if w is None:
            break
        batch.clear()
        _window_matches(engine, w.text, w.base, w.commit, threshold, batch)
        for m in batch:
            on_match(m)
    return wr.total


class StreamMatches:
    """Lazy iterator over stream matches (reference src/stream.rs:165-204).

    Yields :class:`StreamMatch`; an IO error from the reader propagates once,
    then iteration ends.
    """

    def __init__(self, engine, reader, threshold: float):
        self.engine = engine
        self.reader = WindowReader(reader, DEFAULT_WINDOW, engine.stream_overlap())
        self.threshold = threshold
        self.pending: deque[StreamMatch] = deque()
        self.errored = False

    def __iter__(self) -> Iterator[StreamMatch]:
        return self

    def __next__(self) -> StreamMatch:
        while True:
            if self.pending:
                return self.pending.popleft()
            if self.errored:
                raise StopIteration
            try:
                w = self.reader.next_window()
            except Exception:
                # Reader IO errors propagate ONCE, then iteration ends
                # (reference src/stream.rs:165-204).
                self.errored = True
                raise
            if w is None:
                raise StopIteration
            batch: List[StreamMatch] = []
            _window_matches(self.engine, w.text, w.base, w.commit, self.threshold, batch)
            self.pending.extend(batch)


def _separator_char(engine) -> Optional[str]:
    """A char no pattern contains — window regions joined by a run of it
    longer than any possible match span are mutually invisible. ``None``
    when the patterns collectively contain every control char (pathological;
    the batch path then falls back to per-window searches)."""
    sep = getattr(engine, "_stream_sep_char", _MISSING)
    if sep is _MISSING:
        used = set()
        for p in engine._patterns:
            used.update(p.pattern)
        sep = next((chr(c) for c in range(32) if chr(c) not in used), None)
        engine._stream_sep_char = sep
    return sep


def _batch_window_matches(engine, windows: List[_StreamWindow], threshold: float):
    """Per-window match lists for a whole batch from ONE engine search.

    The device fan-out (reference thread pool: src/stream.rs:378-429):
    window texts are joined with dead-separator runs longer than
    ``max_match_graphemes()`` — no match can span two windows, so the
    superwindow's raw matches restricted to one window's byte region are
    exactly that window's own ``search_raw`` results. Order/Overlap
    post-processing then runs per window, preserving the sequential API's
    byte-identical semantics (windows see identical match sets either way).
    """
    from .matches import FuzzyMatches

    sep_char = _separator_char(engine)
    if len(windows) == 1 or sep_char is None:
        return [
            _apply_window(engine, w.text, engine.search_raw(w.text, threshold))
            for w in windows
        ]

    sep = sep_char * (engine.max_match_graphemes() + 1)
    sep_blen = len(sep)  # ASCII control char: 1 byte each
    offs: List[int] = []
    pos = 0
    parts: List[str] = []
    for i, w in enumerate(windows):
        offs.append(pos)
        parts.append(w.text)
        pos += w.nbytes
        pos += sep_blen
        parts.append(sep)
    super_text = "".join(parts)

    raw = engine.search_raw(super_text, threshold)
    per_window: List[List[FuzzyMatch]] = [[] for _ in windows]
    bounds = [
        (offs[i], offs[i] + w.nbytes)
        for i, w in enumerate(windows)
    ]
    import bisect

    starts = [b[0] for b in bounds]
    for m in raw:
        i = bisect.bisect_right(starts, m.start) - 1
        if i < 0:
            continue
        lo, hi = bounds[i]
        if m.start >= lo and m.end <= hi:
            per_window[i].append(
                FuzzyMatch(
                    insertions=m.insertions, deletions=m.deletions,
                    substitutions=m.substitutions, swaps=m.swaps, edits=m.edits,
                    pattern_index=m.pattern_index, pattern=m.pattern,
                    start=m.start - lo, end=m.end - lo,
                    similarity=m.similarity, text=m.text,
                )
            )
    return [
        _apply_window(engine, w.text, ms) for w, ms in zip(windows, per_window)
    ]


def _apply_window(engine, text: str, raw_matches):
    """The sequential path's per-window post-processing: Default order +
    NonOverlapping (reference src/stream.rs:262-297)."""
    from .matches import FuzzyMatches
    from .options import Order, Overlap

    fm = FuzzyMatches(text, list(raw_matches))
    fm.apply(Order.Default, Overlap.NonOverlapping)
    return list(fm)


class _WindowProducer:
    """Background reader thread filling a bounded window queue — the
    reference's producer thread over a bounded channel
    (src/stream.rs:386-420). Reading the next windows overlaps with the
    device search of the current batch."""

    def __init__(self, wr: WindowReader, depth: int):
        import queue
        import threading

        self.wr = wr
        self.q: "queue.Queue" = queue.Queue(maxsize=max(2, depth))
        self.exc: Optional[BaseException] = None
        self.eof = False

        def run():
            try:
                while True:
                    w = wr.next_window()
                    self.q.put(w)
                    if w is None:
                        return
            except BaseException as e:  # propagate IO errors once (stream.rs:165-204)
                self.exc = e
                self.q.put(None)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def next_batch(self, n: int, slack: int = 0) -> List[_StreamWindow]:
        """Up to ``n`` windows (blocking), plus up to ``slack`` more that are
        available without blocking — so a short stream tail folds into the
        final batch instead of paying a whole dispatch for one straggler."""
        import queue as _queue

        out: List[_StreamWindow] = []
        budget = n + slack
        while len(out) < budget and not self.eof:
            if len(out) < n:
                w = self.q.get()
            else:
                try:
                    w = self.q.get_nowait()
                except _queue.Empty:
                    break
            if w is None:
                self.eof = True
                if self.exc is not None:
                    exc, self.exc = self.exc, None
                    raise exc
                break
            out.append(w)
        return out


def search_stream_parallel(
    engine, reader, threshold: float, shards: int, on_match: Callable[[StreamMatch], None]
) -> int:
    """Parallel streaming search (reference src/stream.rs:378-429).

    Device form of the reference's producer + N-worker pool: a producer
    thread reads/segments windows ahead of the device (bounded queue,
    2 x shards like the reference's sync_channel), and each batch of
    ``shards`` windows is joined with dead separators into ONE device
    dispatch — the kernels are data-parallel over every start position, so
    the batch IS the fan-out. A batch holds at most the windows one
    ``search_raw`` serves (:func:`_windows_per_search`). Results are
    byte-identical to :func:`search_stream` (same window geometry, same
    per-window post-processing) and arrive in stream order.
    """
    shards = max(1, shards)
    wr = WindowReader(reader, DEFAULT_WINDOW, engine.stream_overlap())
    prod = _WindowProducer(wr, depth=2 * shards)
    sep_len = engine.max_match_graphemes() + 1
    while True:
        batch_windows = prod.next_batch(min(shards, _windows_per_search(wr.window, sep_len)))
        if not batch_windows:
            break
        batches = _batch_window_matches(engine, batch_windows, threshold)
        for w, ms in zip(batch_windows, batches):
            for m in ms:
                if m.start < w.commit:
                    on_match(
                        StreamMatch(
                            start=w.base + m.start,
                            end=w.base + m.end,
                            pattern_index=m.pattern_index,
                            similarity=m.similarity,
                            insertions=m.insertions,
                            deletions=m.deletions,
                            substitutions=m.substitutions,
                            swaps=m.swaps,
                            edits=m.edits,
                            text=m.text,
                        )
                    )
    return wr.total


def _windows_per_search(window: int, sep_len: int) -> int:
    """Most windows one superwindow may join so that a single ``search_raw``
    takes it on the resident lanes: at most ``RESIDENT_MAX`` graphemes (a
    window holds fewer than ``window + READ_MIN`` bytes, a grapheme at least
    one byte). Past that a fuzzy search leaves the DP lane for the beam
    frontier, which gives the same matches more slowly, so the stream keeps
    each batch under it (the JAX package joins ``shards`` windows)."""
    from .ops.packed_bitap import RESIDENT_MAX

    return max(1, RESIDENT_MAX // (window + READ_MIN + sep_len))


def _worker_scope(engine):
    """A factory of the context the search worker thread runs ``search_raw``
    in: the engine's CUDA device made current there (a new thread starts on
    device 0; an index-less ``cuda`` device means the calling thread's
    current one), nothing for a CPU engine or a host without CUDA, where the
    search itself raises if it needs the card."""
    dev = engine.device
    if dev.type != "cuda" or not torch.cuda.is_available():
        return contextlib.nullcontext
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return lambda: torch.cuda.device(idx)


class _BatchPrep:
    """A search-ready batch: windows plus the pre-assembled superwindow
    (bytes + decoded str + per-window byte offsets). Built on the producer
    thread so the search worker's critical path is transcode + dispatch only
    (the join/decode of a batch sits on the critical path otherwise)."""

    __slots__ = ("windows", "super_bytes", "super_text", "offs", "view")

    def __init__(self, windows, super_bytes=None, super_text=None, offs=None,
                 view=None):
        self.windows = windows
        self.super_bytes = super_bytes
        self.super_text = super_text
        self.offs = offs
        self.view = view


class _PrepProducer:
    """Producer thread: segments stream windows AND assembles batch preps —
    the reference's producer thread over a bounded channel
    (src/stream.rs:386-420), here also owning the superwindow join so the
    device worker never touches it."""

    def __init__(self, wr: WindowReader, max_batch_windows: int,
                 sep_b: Optional[bytes], case_insensitive: bool = False,
                 depth: int = 2):
        import queue
        import threading

        self.wr = wr
        self.maxw = max_batch_windows
        self.sep_b = sep_b
        self.case_insensitive = case_insensitive
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.exc: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _collect(self) -> List[_StreamWindow]:
        out: List[_StreamWindow] = []
        while len(out) < self.maxw:
            w = self.wr.next_window()
            if w is None:
                break
            out.append(w)
        return out

    def _prep(self, windows: List[_StreamWindow]) -> _BatchPrep:
        if self.sep_b is None or len(windows) == 1:
            return _BatchPrep(windows)
        sep_b = self.sep_b
        sep_blen = len(sep_b)
        offs: List[int] = []
        pos = 0
        bparts: List[bytes] = []
        for w in windows:
            offs.append(pos)
            pos += w.nbytes
            bparts.append(w.data)
            pos += sep_blen
            bparts.append(sep_b)
        sb = b"".join(bparts)
        # One decode for the whole batch (windows are valid UTF-8 by
        # WindowReader construction; separators are ASCII control chars).
        st = sb.decode("utf-8")
        # Build the haystack view HERE — the search worker finds it by
        # identity (register_view), so its critical path never touches it.
        # ASCII batches skip view_of entirely: its content key is
        # ``hash(str)``, a siphash of the whole batch buying an LRU hit that
        # an ASCII view (zero-copy, bytes seeded below) doesn't need.
        # Non-ASCII views carry a real segmentation pass, so the
        # content-keyed cache stays worth the hash for them.
        from .utils.graphemes import HaystackView, register_view, view_of

        if st.isascii():
            view = HaystackView(st, self.case_insensitive)
            view._bytes = sb
        else:
            view = view_of(st, self.case_insensitive)
            if view._bytes is None and view.ascii:
                view._bytes = sb
        register_view(view)
        return _BatchPrep(windows, sb, st, offs, view)

    def _run(self) -> None:
        try:
            # Prime the pipeline with a small first batch: the search worker
            # idles until prep 1 lands, and a full prep (segment + join +
            # decode) is dead startup time per call. FAC_PRIME_DIV divides
            # the first batch's window count.
            import os as _os_p

            prime = int(_os_p.environ.get("FAC_PRIME_DIV", "1"))
            self.maxw, full = max(1, self.maxw // max(prime, 1)), self.maxw
            cur = self._collect()
            self.maxw = full
            while cur:
                nxt = self._collect()
                # Fold a short stream tail into the previous batch instead of
                # paying a dispatch for it. Geometry stays deterministic
                # (batch splits decide superwindow CONTENT, which keys the
                # device residency cache and the compiled bucket shapes).
                if nxt and len(nxt) * 6 <= self.maxw:
                    cur = cur + nxt
                    nxt = self._collect()
                self.q.put(self._prep(cur))
                cur = nxt
            self.q.put(None)
        except BaseException as e:  # propagate IO errors once (stream.rs:165-204)
            self.exc = e
            self.q.put(None)

    def next(self) -> Optional[_BatchPrep]:
        p = self.q.get()
        if p is None and self.exc is not None:
            exc, self.exc = self.exc, None
            raise exc
        return p


def _search_prep(engine, prep: _BatchPrep, threshold: float, scope):
    """One batched device search (worker thread, inside ``scope()``: see
    :func:`_worker_scope`): returns the raw superwindow result — per-window
    post-processing happens on the emit side (:func:`_post_replace_batch`),
    keeping this thread dispatch-bound.

    Seeds the haystack view's byte cache with the producer's already-joined
    bytes: the ASCII transcodes and the match decode all consume
    ``view.hay_bytes()``, and re-encoding the batch str per consumer is
    memcpy waste."""
    with scope():
        if prep.super_text is None:
            return [
                _window_replace_matches(engine, w.text, w.commit, threshold)
                for w in prep.windows
            ]
        # prep.view was built (and its bytes seeded) on the producer thread;
        # view_of inside the search hits it by object identity.
        return engine.search_raw(prep.super_text, threshold)


def _post_replace_batch(engine, prep: _BatchPrep, raw):
    """Per-window owned, non-overlapping, position-sorted match lists for
    replacement, from one batch's raw superwindow result — struct-of-arrays
    throughout.

    The object path (:func:`_split_super_matches` + per-window
    ``FuzzyMatches.apply``) constructs a FuzzyMatch per raw emission and
    sorts Python objects; at streaming match densities that Python work
    dominates the wall clock. Here the windowing, Default ranking and the
    greedy non-overlap pass all run on the search's SoA columns (reference
    semantics: src/matches.rs:24-38 ranking, 86-112 interval scheduling,
    src/stream.rs:496-517 ownership) and only the finally-kept matches are
    materialized for the user callback.
    """
    import bisect as _bisect

    from .structs import LazyMatchList

    if prep.super_text is None:
        return raw  # _search_prep already produced per-window owned lists

    windows, offs = prep.windows, prep.offs
    if not (isinstance(raw, LazyMatchList) and raw.unmaterialized):
        # Host-oracle result (plain objects): the classic per-window path.
        per = _split_super_matches(engine, windows, offs, raw)
        out = []
        for w, ms in zip(windows, per):
            fm = _apply_window(engine, w.text, ms)
            owned = [m for m in fm if m.start < w.commit]
            owned.sort(key=lambda m: (m.start, m.end))
            out.append(owned)
        return out

    import numpy as np

    s, e, pat, sim, plens = raw.columns()
    cnts = np.asarray(raw._cnts)
    los = np.asarray(offs, dtype=np.int64)
    his = los + np.asarray([w.nbytes for w in windows], dtype=np.int64)
    wi = np.searchsorted(los, s, side="right") - 1
    wis = np.maximum(wi, 0)
    ok = (wi >= 0) & (s >= los[wis]) & (e <= his[wis])
    if not ok.any():
        return [[] for _ in windows]
    s, e, pat, sim, plens, cnts, wi = (
        s[ok], e[ok], pat[ok], sim[ok], plens[ok], cnts[ok], wi[ok]
    )
    sl = s - los[wi]
    el = e - los[wi]

    # Default order within each window (window-major lexsort — wi is the
    # PRIMARY key, so the sorted rows are contiguous per window): similarity
    # desc, pattern len desc, text len desc, start, end, pattern index.
    order = np.lexsort(
        (pat, el, sl, -(el - sl), -plens, -sim.astype(np.float64), wi)
    )
    # Greedy interval scheduling per window in that order. Native byte-
    # occupancy pass when available (windows are disjoint superwindow byte
    # ranges, so global-coordinate greedy == per-window greedy); pure-Python
    # bisect loop otherwise.
    from .utils import native as _native

    s_o, e_o, wi_o = s[order], e[order], wi[order]
    keep = _native.greedy_nonoverlap(s_o, e_o, int(his[-1]))
    if keep is None:
        keep = np.zeros(len(order), dtype=bool)
        w_starts: dict[int, list] = {}
        w_ends: dict[int, list] = {}
        sl_o, el_o = sl[order], el[order]
        for r in range(len(order)):
            w = int(wi_o[r])
            ss, ee = int(sl_o[r]), int(el_o[r])
            starts = w_starts.setdefault(w, [])
            ends = w_ends.setdefault(w, [])
            p = _bisect.bisect_left(starts, ss)
            if (p == 0 or ends[p - 1] <= ss) and (p == len(starts) or starts[p] >= ee):
                starts.insert(p, ss)
                ends.insert(p, ee)
                keep[r] = True
    kept_rows = order[keep]
    wi_kept = wi_o[keep]  # non-decreasing (window-major sort)
    bounds_w = np.searchsorted(wi_kept, np.arange(len(windows) + 1))

    patterns = raw._patterns
    out = []
    for widx, w in enumerate(windows):
        r = kept_rows[bounds_w[widx] : bounds_w[widx + 1]]
        if not len(r):
            out.append([])
            continue
        # ownership + final (start, end) order (starts are unique post
        # non-overlap, so a start sort is total). The kept matches become a
        # window-local LazyMatchList: FuzzyMatch objects only materialize if
        # the callback path needs them.
        sl_w = s[r] - los[widx]
        own = sl_w < w.commit
        r = r[own]
        order_w = np.argsort(sl_w[own], kind="stable")
        r = r[order_w]
        out.append(
            LazyMatchList(
                patterns, w.data, s[r] - los[widx], e[r] - los[widx],
                pat[r], sim[r], cnts[r],
            )
        )
    return out


def _split_super_matches(engine, windows, offs, raw):
    """Split a superwindow's raw object matches back to per-window lists
    (rebased); shared by the object fallback paths."""
    import bisect

    bounds = [
        (offs[i], offs[i] + w.nbytes)
        for i, w in enumerate(windows)
    ]
    starts = [b[0] for b in bounds]
    per: List[List[FuzzyMatch]] = [[] for _ in windows]
    for m in raw:
        i = bisect.bisect_right(starts, m.start) - 1
        if i < 0:
            continue
        lo, hi = bounds[i]
        if m.start >= lo and m.end <= hi:
            per[i].append(
                FuzzyMatch(
                    insertions=m.insertions, deletions=m.deletions,
                    substitutions=m.substitutions, swaps=m.swaps, edits=m.edits,
                    pattern_index=m.pattern_index, pattern=m.pattern,
                    start=m.start - lo, end=m.end - lo,
                    similarity=m.similarity, text=m.text,
                )
            )
    return per


def _window_replace_matches(engine, text: str, commit: int, threshold: float) -> List[FuzzyMatch]:
    """The matches a window owns for replacement: non-overlapping, start <
    commit, sorted by position (reference src/stream.rs:496-517)."""
    matches = engine.search(
        text,
        SearchOptions.new().with_threshold(threshold).sorted().non_overlapping(),
    )
    owned = [m for m in matches if m.start < commit]
    owned.sort(key=lambda m: (m.start, m.end))
    return owned


class _ReplaceCursor:
    """Tracks output progress across windows (reference src/stream.rs:641-705)."""

    def __init__(self):
        self.emitted = 0
        self.written = 0

    def emit_window_table(self, writer, table, base: int, data: bytes,
                          commit: int, sb, eb, pat, rt=None) -> None:
        """Table-replacement emit: no FuzzyMatch objects, no callback — the
        replacement is ``table[pattern_index]`` bytes (None = keep). One
        join + one write per window; far less Python per match than the
        callback path, which is what lets a GIL-bound pipeline keep pace
        with the device search (the reference's FuzzyReplacer fast path,
        src/replacer.rs:35-52). With ``rt`` (a native.ReplacementTable) and
        the native library present, the whole window assembles in one C pass
        straight into a buffer — one copy instead of slice + join + write."""
        cur = self.emitted - base
        if rt is not None:
            from .utils import native as _native

            res = _native.replace_emit_table(data, cur, commit, sb, eb, pat, rt)
            if res is not None:
                out_arr, new_cur = res
                writer.write(out_arr)
                self.written += len(out_arr)
                self.emitted = base + new_cur
                return
        parts = []
        nt = len(table)
        for s, e_, p in zip(sb.tolist(), eb.tolist(), pat.tolist()):
            if s < cur:
                continue  # an earlier window's match extended past commit
            if cur < s:
                parts.append(data[cur:s])
            r = table[p] if p < nt else None
            parts.append(r if r is not None else data[s:e_])
            cur = e_
        if cur < commit:
            parts.append(data[cur:commit])
            cur = commit
        out = b"".join(parts)
        writer.write(out)
        self.written += len(out)
        self.emitted = base + cur

    def emit_window(self, writer, callback, base: int, text: str, commit: int, matches) -> None:
        data = text.encode("utf-8")
        for m in matches:
            match_start = base + m.start
            if match_start < self.emitted:
                continue  # earlier window's match extended past its commit; it won
            if self.emitted < match_start:
                lo = self.emitted - base
                writer.write(data[lo : m.start])
                self.written += m.start - lo
            repl = callback(m)
            if repl is not None:
                rb = repl.encode("utf-8") if isinstance(repl, str) else bytes(repl)
                writer.write(rb)
                self.written += len(rb)
            else:
                writer.write(data[m.start : m.end])
                self.written += m.end - m.start
            self.emitted = base + m.end
        commit_abs = base + commit
        if self.emitted < commit_abs:
            lo = self.emitted - base
            writer.write(data[lo:commit])
            self.written += commit - lo
            self.emitted = commit_abs


def replace_stream(engine, reader, writer, threshold: float, callback) -> int:
    """Streaming find-and-replace in constant memory; returns bytes written
    (reference src/stream.rs:465-492)."""
    wr = WindowReader(reader, DEFAULT_WINDOW, engine.stream_overlap())
    cursor = _ReplaceCursor()
    while True:
        w = wr.next_window()
        if w is None:
            break
        matches = _window_replace_matches(engine, w.text, w.commit, threshold)
        cursor.emit_window(writer, callback, w.base, w.text, w.commit, matches)
    return cursor.written


def _as_replacement_table(callback):
    """A non-callable ``callback`` is a pattern-indexed replacement table
    (the FuzzyReplacer form, reference src/replacer.rs:9-52): item i replaces
    matches of pattern i (None = keep). Returns encoded bytes or None."""
    if callable(callback) or callback is None:
        return None
    return [
        None if r is None else (r.encode("utf-8") if isinstance(r, str) else bytes(r))
        for r in callback
    ]


#: Bytes of windows one ``replace_stream_parallel`` dispatch joins: each
#: dispatch carries a fixed host cost, so batches are big enough to amortize it.
BATCH_BYTES = 48 << 20


def _replace_producer(engine, wr: WindowReader, shards: int) -> _PrepProducer:
    """``replace_stream_parallel``'s producer thread over ``wr``: batches of
    at most ``2 * shards`` windows and ~``BATCH_BYTES``, joined by the
    engine's separator run, two preps queued ahead so the search worker
    never waits on the join."""
    max_batch_windows = max(1, min(2 * shards, -(-BATCH_BYTES // wr.window)))
    sep_char = _separator_char(engine)
    sep_b = (
        None if sep_char is None
        else (sep_char * (engine.max_match_graphemes() + 1)).encode("ascii")
    )
    return _PrepProducer(wr, max_batch_windows, sep_b, engine.case_insensitive, depth=2)


def replace_stream_parallel(engine, reader, writer, shards: int, threshold: float, callback) -> int:
    """Parallel replace with in-stream-order reassembly; byte-identical to
    :func:`replace_stream` (reference src/stream.rs:533-638).

    Four-stage pipeline (the reference's producer + worker pool + seq-tagged
    collector, src/stream.rs:533-638, shaped for one device):

    * producer thread — reads/segments windows AND assembles superwindow
      batches (bytes join + one str decode), ahead of the device;
    * ONE search worker (``FAC_REPLACE_WORKERS`` for more) — transcode +
      slice upload + kernel dispatch only, on the engine's device;
    * the calling thread — per-window SoA post-processing
      (:func:`_post_replace_batch`) + strictly in-stream-order byte emit.

    Batches group windows to ~BATCH_BYTES per dispatch — the kernels are
    data-parallel over starts, so batching is pure overhead amortization —
    and two batches stay in flight so every stage has work.
    """
    shards = max(1, shards)
    import os as _os
    import time as _time
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from .structs import LazyMatchList

    table = _as_replacement_table(callback)
    rt = None
    _ebuf = None
    from .utils import native as _native

    if table is not None:
        rt = _native.ReplacementTable(table)
        _ebuf = _native._BatchEmitBuf()
    wr = WindowReader(reader, DEFAULT_WINDOW, engine.stream_overlap())
    cursor = _ReplaceCursor()
    prod = _replace_producer(engine, wr, shards)

    scope = _worker_scope(engine)
    _timing = _os.environ.get("FAC_TIME") == "1"
    _wait_s = _post_s = _emit_s = 0.0
    nw = int(_os.environ.get("FAC_REPLACE_WORKERS", "1"))
    with ThreadPoolExecutor(max_workers=max(1, nw)) as pool:
        inflight: deque = deque()  # (prep, future), stream order
        eof = False
        while inflight or not eof:
            while not eof and len(inflight) < 1 + max(1, nw):
                prep = prod.next()
                if prep is None:
                    eof = True
                    break
                inflight.append(
                    (prep, pool.submit(_search_prep, engine, prep, threshold, scope))
                )
            if not inflight:
                break
            prep, fut = inflight.popleft()
            _tw = _time.perf_counter() if _timing else 0.0
            raw = fut.result()
            _tp = _time.perf_counter() if _timing else 0.0
            owned_lists = _post_replace_batch(engine, prep, raw)
            _te = _time.perf_counter() if _timing else 0.0
            batchable = (
                rt is not None
                and prep.super_bytes is not None
                and all(
                    isinstance(o, LazyMatchList) and o.unmaterialized
                    for o in owned_lists
                )
            )
            if batchable:
                # One C pass emits the whole batch (the per-window wrapper
                # cost — buffer alloc, marshal, slice, write — times the
                # windows of a batch was the emit stage's dominant term).
                sbs, ebs, pats, wids = [], [], [], []
                for i, o in enumerate(owned_lists):
                    k = len(o._start)
                    if k:
                        sbs.append(np.asarray(o._start, dtype=np.int64))
                        ebs.append(np.asarray(o._end, dtype=np.int64))
                        pats.append(np.asarray(o._pat, dtype=np.int32))
                        wids.append(np.full(k, i, dtype=np.int32))
                cat = lambda xs, dt: (
                    np.concatenate(xs) if xs else np.zeros(0, dtype=dt)
                )
                res = _native.replace_emit_batch(
                    prep.super_bytes, cursor.emitted, prep.offs,
                    [w.base for w in prep.windows],
                    [w.commit for w in prep.windows],
                    cat(sbs, np.int64), cat(ebs, np.int64),
                    cat(pats, np.int32), cat(wids, np.int32), rt, buf=_ebuf,
                )
                if res is not None:
                    mv, new_emitted = res
                    writer.write(mv)
                    cursor.written += len(mv)
                    cursor.emitted = new_emitted
                    batchable = False  # emitted; skip the per-window loop
                    owned_lists = ()
            for w, owned in zip(prep.windows, owned_lists):
                if table is not None and isinstance(owned, LazyMatchList) \
                        and owned.unmaterialized:
                    cursor.emit_window_table(
                        writer, table, w.base, owned._hay_bytes, w.commit,
                        np.asarray(owned._start), np.asarray(owned._end),
                        np.asarray(owned._pat), rt=rt,
                    )
                else:
                    cursor.emit_window(
                        writer,
                        callback if table is None
                        else (lambda m: callback[m.pattern_index]
                              if m.pattern_index < len(callback) else None),
                        w.base, w.text, w.commit, owned,
                    )
            if _timing:
                _wait_s += _tp - _tw
                _post_s += _te - _tp
                _emit_s += _time.perf_counter() - _te
    if _timing:
        import sys as _sys

        print(
            f"[FAC_TIME replace] wait={_wait_s * 1e3:.1f}ms "
            f"post={_post_s * 1e3:.1f}ms emit={_emit_s * 1e3:.1f}ms",
            file=_sys.stderr,
        )
        # Stage budget: wait = the calling thread blocked on the search
        # worker's result, post/emit = host-side SoA ranking and byte
        # assembly on the calling thread. The time it blocks on the
        # producer's queue (``prod.next()``) is in none of the three.
        engine.last_stats = {
            "backend": "replace-stream-parallel",
            "wait_ms": round(_wait_s * 1e3, 1),
            "post_ms": round(_post_s * 1e3, 1),
            "emit_ms": round(_emit_s * 1e3, 1),
            "written": cursor.written,
        }
    # Drop the producer's identity-registered superwindow views — each pins
    # a batch str (+ seeded bytes) that is dead once the stream ends.
    from .utils.graphemes import clear_registered_views

    clear_registered_views()
    return cursor.written
