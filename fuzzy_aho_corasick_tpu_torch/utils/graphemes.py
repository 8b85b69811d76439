"""Grapheme segmentation, case folding, and transcoding (host side).

Host copy of the JAX package's grapheme layer
(reference: src/grapheme.rs, src/search.rs:398-416, src/prefilter.rs:251-281).
The device only ever sees dense integer symbol streams produced here; all
Unicode handling stays on the host.

Two paths, mirroring the reference's monomorphized storage:

* **ASCII fast path** (reference src/grapheme.rs:76-125): every byte of an
  all-ASCII haystack is its own grapheme; case folding is ``byte | 0x20`` for
  letters. Transcoding is a single vectorized table lookup over the byte
  array — no segmentation, no hashing.
* **Unicode path** (reference src/search.rs:398-416): extended grapheme
  clusters via the ``regex`` module's ``\\X`` (UAX #29 — the same definition
  as the reference's ``unicode-segmentation`` crate), lowercased per grapheme
  when case-insensitive.

``regex`` is imported lazily, only by the Unicode paths that need full
segmentation. ASCII text segments without it: one grapheme per char, except
that ``"\\r\\n"`` is one cluster (UAX #29 GB3).
"""

from __future__ import annotations

import threading

import numpy as np

_GRAPHEME_RE = None


def _grapheme_re():
    """The compiled ``\\X`` pattern; raises ImportError naming ``regex``
    when the module is missing and the text needs full segmentation."""
    global _GRAPHEME_RE
    if _GRAPHEME_RE is None:
        try:
            import regex
        except ImportError as e:
            raise ImportError(
                "Unicode grapheme segmentation needs the 'regex' module "
                "(ASCII and single-code-point text work without it)"
            ) from e
        _GRAPHEME_RE = regex.compile(r"\X")
    return _GRAPHEME_RE


def _ascii_graphemes(text: str) -> list[str]:
    """UAX #29 clusters of an all-ASCII string: every char alone, except
    CR LF, which is one cluster."""
    if "\r\n" not in text:
        return list(text)
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        if text[i] == "\r" and i + 1 < n and text[i + 1] == "\n":
            out.append("\r\n")
            i += 2
        else:
            out.append(text[i])
            i += 1
    return out


# Vectorized ASCII lower-case table: byte -> folded byte.
_ASCII_LOWER = np.arange(256, dtype=np.uint8)
_ASCII_LOWER[ord("A") : ord("Z") + 1] += 32


#: Per-256-code-point blocks of the "grapheme singleton" property: True when
#: a code point always forms its own extended grapheme cluster next to any
#: other singleton code point. Derived empirically from the same UAX #29
#: engine used by the slow path (regex '\X'), so the two paths can never
#: disagree: cp is a singleton iff it breaks against itself, after 'a' and
#: before 'a' — which rules out Extend/ZWJ/SpacingMark (no break after a
#: base), Prepend (no break before a base), hangul jamo and regional
#: indicators (no break against themselves). CR is excluded explicitly
#: (CR+LF is one cluster but both probe as singletons).
_SINGLETON_BLOCKS: dict[int, "np.ndarray"] = {}


def _singleton_block(block: int) -> "np.ndarray":
    tbl = _SINGLETON_BLOCKS.get(block)
    if tbl is None:
        tbl = np.zeros(256, dtype=bool)
        base = block << 8
        findall = _grapheme_re().findall
        for i in range(256):
            cp = base + i
            if cp == 0x0D or cp > 0x10FFFF or 0xD800 <= cp <= 0xDFFF:
                continue
            ch = chr(cp)
            tbl[i] = (
                len(findall(ch + ch)) == 2
                and len(findall("a" + ch)) == 2
                and len(findall(ch + "a")) == 2
            )
        _SINGLETON_BLOCKS[block] = tbl
    return tbl


def _all_singletons(cps: "np.ndarray") -> bool:
    """True when every code point is a grapheme singleton (see above) — the
    whole string then segments as one cluster per code point and the
    vectorized view path applies (Cyrillic, Greek, CJK, kana ... — anything
    without combining marks, joiners, jamo or emoji sequences)."""
    mx = int(cps.max(initial=0))
    # One stitched table over [0, mx] + a single gather: the per-block probe
    # cost is paid once per block ever; bincount finds the present blocks in
    # one pass so absent blocks stay unprobed.
    n_blocks = (mx >> 8) + 1
    present = np.flatnonzero(np.bincount(cps >> 8, minlength=n_blocks))
    full = np.zeros(n_blocks << 8, dtype=bool)
    for block in present:
        full[block << 8 : (block + 1) << 8] = _singleton_block(int(block))
    return bool(full[cps].all())


def graphemes(text: str) -> list[str]:
    """Split ``text`` into extended grapheme clusters (UAX #29).

    Matches the reference's ``UnicodeSegmentation::graphemes(s, true)``.
    """
    if text.isascii():
        return _ascii_graphemes(text)
    return _grapheme_re().findall(text)


def grapheme_len(text: str) -> int:
    """Number of extended grapheme clusters in ``text``."""
    if text.isascii():
        # The reference counts pattern graphemes with full segmentation even
        # for ASCII, where CRLF is the one multi-char cluster.
        return len(text) - text.count("\r\n")
    return len(_grapheme_re().findall(text))


def fold_graphemes(text: str, case_insensitive: bool) -> list[str]:
    """Case-fold (when requested) + grapheme-split, matching the builder's trie
    construction (reference src/builder.rs:195-205, src/prefilter.rs:377-385).
    """
    gs = graphemes(text)
    if case_insensitive:
        return [g.lower() for g in gs]
    return gs


def is_ascii(text: str) -> bool:
    return text.isascii()


_VIEW_LRU: "dict[tuple, object]" = {}
_VIEW_LRU_MAX = 4
# Total *weighted* cached bytes: a non-ASCII view materializes per-grapheme
# Python lists many times the corpus size, so Unicode entries are charged
# 8x their length. Keeps cycling through large Unicode corpora from pinning
# multiple GB of host memory.
_VIEW_LRU_MAX_BYTES = 256 << 20


#: Guards ``_VIEW_LRU`` and ``_VIEW_BY_ID``: searches run on several threads
#: (the parallel streams' workers), and the caps' sums iterate the dicts.
_VIEW_LOCK = threading.Lock()


def _view_cost(view: "HaystackView") -> int:
    return len(view.haystack) * (1 if view.ascii else 8)


#: Identity-keyed registry of pre-built views (streaming superwindows):
#: skips the content hash entirely — hash(str) of a fresh multi-MiB batch
#: str sits on the critical path. Entries keep their str alive, so an id()
#: cannot be reused while its entry lives; the `is` check rejects impostors.
_VIEW_BY_ID: "dict[int, HaystackView]" = {}
_VIEW_BY_ID_MAX = 8
# Registered superwindow views pin their str plus (often) a same-size seeded
# _bytes; a count-only cap of 8 could hold hundreds of MiB of large batches.
# Evict by accumulated weight like _VIEW_LRU.
_VIEW_BY_ID_MAX_BYTES = 192 << 20


def _registered_cost(view: "HaystackView") -> int:
    c = _view_cost(view)
    if view._bytes is not None:
        c += len(view._bytes)
    return c


def register_view(view: "HaystackView") -> None:
    """Pre-register a view for identity-based lookup (producer threads build
    views ahead of the search; see stream._PrepProducer)."""
    with _VIEW_LOCK:
        _VIEW_BY_ID[id(view.haystack)] = view
        while len(_VIEW_BY_ID) > 1 and (
            len(_VIEW_BY_ID) > _VIEW_BY_ID_MAX
            or sum(_registered_cost(v) for v in _VIEW_BY_ID.values())
            > _VIEW_BY_ID_MAX_BYTES
        ):
            _VIEW_BY_ID.pop(next(iter(_VIEW_BY_ID)))


def clear_registered_views() -> None:
    """Drop all identity-registered views (streaming drivers call this when a
    stream completes so finished superwindow batches don't stay pinned)."""
    with _VIEW_LOCK:
        _VIEW_BY_ID.clear()


def view_of(haystack: str, case_insensitive: bool) -> "HaystackView":
    """Small content-keyed LRU cache of :class:`HaystackView` instances.

    The device deployment model searches the same resident corpus many times
    (utils/device_corpus); a fresh view per search re-pays ``str.encode`` of
    the whole haystack in the match decode and, for Unicode,
    the full segmentation pass. Keyed like the device-corpus cache —
    ``hash(str)`` is cached inside the str object, equality guards collisions.
    """
    v = _VIEW_BY_ID.get(id(haystack))
    if v is not None and v.haystack is haystack \
            and v.case_insensitive == case_insensitive:
        return v
    key = (hash(haystack), len(haystack), case_insensitive)
    with _VIEW_LOCK:
        hit = _VIEW_LRU.get(key)
        if hit is not None and (hit.haystack is haystack or hit.haystack == haystack):
            # True LRU: refresh recency so hot views survive eviction.
            _VIEW_LRU.pop(key)
            _VIEW_LRU[key] = hit
            return hit
    # Built outside the lock: two threads that miss on one key both build,
    # and the second insert replaces the first.
    view = HaystackView(haystack, case_insensitive)
    with _VIEW_LOCK:
        _VIEW_LRU.pop(key, None)
        _VIEW_LRU[key] = view
        # Evict oldest entries past either cap (never the one just inserted).
        while len(_VIEW_LRU) > 1 and (
            len(_VIEW_LRU) > _VIEW_LRU_MAX
            or sum(_view_cost(v) for v in _VIEW_LRU.values()) > _VIEW_LRU_MAX_BYTES
        ):
            _VIEW_LRU.pop(next(iter(_VIEW_LRU)))
    return view


class HaystackView:
    """A segmented, optionally case-folded view of a haystack.

    Unifies the reference's two ``GraphemeStorage`` implementations
    (src/grapheme.rs:33-125): exposes per-grapheme byte offsets, folded text,
    and folded first chars, with a zero-copy ASCII fast path.
    """

    __slots__ = (
        "haystack", "ascii", "case_insensitive", "_texts", "_offsets",
        "_chars", "_offsets_np", "_bytes", "_folded", "_folded_cps",
    )

    def __init__(self, haystack: str, case_insensitive: bool):
        self.haystack = haystack
        self.case_insensitive = case_insensitive
        self.ascii = haystack.isascii()
        self._offsets_np = None
        self._bytes = None
        self._folded = None
        self._folded_cps = None
        if self.ascii:
            self._texts = None
            self._offsets = None
            self._chars = None
            return
        # Single-code-point fast path: when every code point is a grapheme
        # SINGLETON (see :func:`_all_singletons` — Latin below U+0300 passes
        # trivially, and so do Cyrillic, Greek, CJK, kana: any script
        # without combining marks, joiners, jamo or emoji sequences in the
        # actual text), every code point IS one extended grapheme cluster —
        # segmentation becomes vectorized arithmetic instead of a regex pass.
        # Case folding must also be length-preserving (e.g. U+0130 lowers to two code points — falls
        # back to the general path).
        cps = np.frombuffer(haystack.encode("utf-32-le"), dtype=np.uint32)
        mx = int(cps.max(initial=0))
        if (
            (mx < 0x300 and "\r" not in haystack)
            or (mx >= 0x300 and _all_singletons(cps))
        ):
            folded = haystack.lower() if case_insensitive else haystack
            if len(folded) == len(haystack):
                self._texts = None
                self._chars = None
                self._folded = folded
                # UTF-8 length per code point; exclusive prefix sum =
                # inclusive cumsum minus the element (cumsum into a strided
                # out= slice hits a numpy slow path).
                blen = (
                    1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000)
                ).astype(np.int64)
                cs = np.cumsum(blen)
                cs -= blen
                self._offsets = cs
                return
        texts: list[str] = []
        offsets: list[int] = []
        pos = 0
        for g in _grapheme_re().findall(haystack):
            offsets.append(pos)
            pos += len(g.encode("utf-8"))
            if case_insensitive and not (g.isascii() and not any("A" <= c <= "Z" for c in g)):
                texts.append(g.lower())
            else:
                texts.append(g)
        self._texts = texts
        self._offsets = offsets
        self._chars = [t[0] if t else "\0" for t in texts]

    def __len__(self) -> int:
        if self.ascii or self._folded is not None:
            return len(self.haystack)
        return len(self._texts)

    def hay_bytes(self) -> bytes:
        """UTF-8 bytes of the (unfolded) haystack, encoded once per view —
        re-encoding the whole haystack per search is avoidable work."""
        if self._bytes is None:
            self._bytes = self.haystack.encode("utf-8")
        return self._bytes

    def byte_offset(self, idx: int) -> int:
        """Byte offset of grapheme ``idx`` (reference src/grapheme.rs:36,57,96)."""
        if self.ascii:
            return idx
        return int(self._offsets[idx])

    def offsets_array(self, total_bytes: int):
        """np.int64 [n+1] byte offsets with a ``total_bytes`` sentinel at n —
        vectorized grapheme->byte conversion for match decode. None for the
        ASCII path (offsets are the identity there)."""
        if self.ascii:
            return None
        if self._offsets_np is None:
            self._offsets_np = np.concatenate(
                [np.asarray(self._offsets, dtype=np.int64), [total_bytes]]
            )
        return self._offsets_np

    def text(self, idx: int) -> str:
        """The (folded) grapheme at ``idx`` (reference src/grapheme.rs:61,100)."""
        if self.ascii:
            ch = self.haystack[idx]
            return ch.lower() if self.case_insensitive else ch
        if self._folded is not None:
            return self._folded[idx]
        return self._texts[idx]

    def first_char(self, idx: int) -> str:
        """First char of the folded grapheme at ``idx`` (src/grapheme.rs:65,111)."""
        if self.ascii:
            ch = self.haystack[idx]
            return ch.lower() if self.case_insensitive else ch
        if self._folded is not None:
            return self._folded[idx]
        return self._chars[idx]

    def chars(self) -> list[str]:
        """All folded first-chars, mirroring the reference's per-search
        ``text_chars`` cache (src/search.rs:203)."""
        if self.ascii:
            h = self.haystack
            return list(h.lower() if self.case_insensitive else h)
        if self._folded is not None:
            return list(self._folded)
        return list(self._chars)


def map_singleton_chars(view: "HaystackView", char_map, dtype=np.uint8):
    """Vectorized grapheme->id transcode for singleton-fast-path views
    (``view._folded`` set): builds a code-point lookup from ``char_map``
    (ids for its single-char keys, 0 otherwise) and gathers — the numpy form
    of the per-grapheme ``dict.get`` loop. Returns None when the view is not
    on the fast path."""
    if view._folded is None:
        return None
    cps = view._folded_cps
    if cps is None:
        cps = np.frombuffer(
            view._folded.encode("utf-32-le"), dtype=np.uint32
        )
        view._folded_cps = cps
    mx = int(cps.max(initial=0))
    tab = np.zeros(mx + 2, dtype=np.int32)
    for ch, cid in char_map.items():
        if len(ch) == 1:
            o = ord(ch)
            if o <= mx:
                tab[o] = cid
    return tab[cps].astype(dtype)


def transcode_ascii(haystack: str, table: np.ndarray) -> np.ndarray:
    """Map an all-ASCII haystack to a symbol-id stream via a 256-entry table.

    Vectorized equivalent of the reference's byte fast path
    (src/prefilter.rs:253-259). ``table`` must already encode case folding.
    """
    raw = np.frombuffer(haystack.encode("ascii"), dtype=np.uint8)
    return table[raw]
