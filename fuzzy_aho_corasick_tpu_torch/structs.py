"""Public data types: similarity tables, limits, penalties, patterns, matches.

Host copy of the JAX package's data model (reference: src/structs.rs).
The reference packs a pointer-rich ``Node`` graph; here the automaton is
compiled to dense NumPy arrays and torch device tables (see
:mod:`fuzzy_aho_corasick_tpu_torch.builder`) and these classes carry only
configuration and results.

All scoring arithmetic is float32 to match the reference bit-for-bit
(similarity = ``(N - penalties) / N * weight`` in f32 — reference
src/search.rs:696-699, src/lib.rs:15-17).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable, Mapping, Optional, Tuple, Union

import numpy as np

from .utils.graphemes import grapheme_len

f32 = np.float32

#: Index of a pattern within the automaton's pattern list (reference src/lib.rs:104).
PatternIndex = int

#: Edit count type (reference src/structs.rs:161).
NumEdits = int


class Similarity:
    """Char-pair similarity: dense 128x128 f32 ASCII table + dict fallback.

    Mirrors the reference's combined similarity data (src/structs.rs:9-93):
    ``get(a, b)`` is the score for substituting pattern char ``a`` with text
    char ``b``; the diagonal is 1.0, unlisted pairs are 0.0.
    """

    __slots__ = ("map", "ascii_table")

    def __init__(self, pairs: Union[Mapping[Tuple[str, str], float], Iterable[Tuple[Tuple[str, str], float]], None] = None):
        if pairs is None:
            pairs = {}
        if not isinstance(pairs, Mapping):
            pairs = dict(pairs)
        self.map: dict[tuple[str, str], np.float32] = {k: f32(v) for k, v in pairs.items()}
        table = np.zeros((128, 128), dtype=np.float32)
        np.fill_diagonal(table, 1.0)
        for (a, b), sim in self.map.items():
            ia, ib = ord(a), ord(b)
            if ia < 128 and ib < 128:
                table[ia, ib] = sim
        self.ascii_table = table

    @classmethod
    def from_map(cls, pairs) -> "Similarity":
        """Build from ``(char, char) -> score`` pairs (reference src/structs.rs:30-54)."""
        return cls(pairs)

    def max_off_diagonal(self) -> np.float32:
        """Largest non-diagonal similarity, bounding the cheapest substitution
        for the prefilter (reference src/structs.rs:61-76)."""
        t = self.ascii_table.copy()
        np.fill_diagonal(t, 0.0)
        m = f32(t.max()) if t.size else f32(0.0)
        for (a, b), sim in self.map.items():
            if a != b and sim > m:
                m = f32(sim)
        return f32(m)

    def get(self, a: str, b: str) -> np.float32:
        """Similarity between two chars (reference src/structs.rs:82-92)."""
        ia, ib = ord(a), ord(b)
        if ia < 128 and ib < 128:
            return self.ascii_table[ia, ib]
        if a == b:
            return f32(1.0)
        return self.map.get((a, b), f32(0.0))


def default_similarity() -> Similarity:
    """The default vowel/consonant/OCR-confusion table
    (reference src/builder.rs:492-526)."""
    m: dict[tuple[str, str], float] = {}
    vowels = "aeiou"
    consonants = [chr(b) for b in range(ord("a"), ord("z") + 1) if chr(b) not in vowels]
    for a in vowels:
        for b in vowels:
            if a != b:
                m[(a, b)] = 0.6
    for a in consonants:
        for b in consonants:
            if a != b:
                m[(a, b)] = 0.4
    for a, b, s in [("o", "0", 0.6), ("0", "o", 0.6), ("l", "1", 0.7), ("1", "l", 0.7),
                    ("i", "1", 0.6), ("1", "i", 0.6), ("s", "5", 0.5), ("5", "s", 0.5)]:
        m[(a, b)] = s
    return Similarity(m)


_DEFAULT_SIMILARITY: Optional[Similarity] = None


def DEFAULT_SIMILARITY() -> Similarity:
    """Lazily-initialised default similarity singleton (reference src/builder.rs:492)."""
    global _DEFAULT_SIMILARITY
    if _DEFAULT_SIMILARITY is None:
        _DEFAULT_SIMILARITY = default_similarity()
    return _DEFAULT_SIMILARITY


@dataclass(frozen=True)
class FuzzyLimits:
    """Caps on how far a fuzzy match may deviate from a pattern
    (reference src/structs.rs:283-363).

    Either a total :meth:`edits` budget (any mix of types), or per-type caps —
    and, unless a total budget exists, each *unset* per-type cap defaults to 0
    after :meth:`finalize` (reference src/structs.rs:317-335).
    """

    insertions_: Optional[int] = None
    deletions_: Optional[int] = None
    substitutions_: Optional[int] = None
    swaps_: Optional[int] = None
    edits_: Optional[int] = None

    @staticmethod
    def new() -> "FuzzyLimits":
        return FuzzyLimits()

    def insertions(self, num: int) -> "FuzzyLimits":
        return replace(self, insertions_=num)

    def deletions(self, num: int) -> "FuzzyLimits":
        return replace(self, deletions_=num)

    def substitutions(self, num: int) -> "FuzzyLimits":
        return replace(self, substitutions_=num)

    def swaps(self, num: int) -> "FuzzyLimits":
        return replace(self, swaps_=num)

    def edits(self, num: int) -> "FuzzyLimits":
        return replace(self, edits_=num)

    def finalize(self) -> "FuzzyLimits":
        """Fill defaults the search expects (reference src/structs.rs:319-335)."""
        if self.edits_ is not None:
            return self
        return FuzzyLimits(
            insertions_=0 if self.insertions_ is None else self.insertions_,
            deletions_=0 if self.deletions_ is None else self.deletions_,
            substitutions_=0 if self.substitutions_ is None else self.substitutions_,
            swaps_=0 if self.swaps_ is None else self.swaps_,
            edits_=None,
        )


@dataclass(frozen=True)
class FuzzyPenalties:
    """Cost per edit kind (reference src/structs.rs:365-420).

    Defaults are the reference's hand-tuned set, computed in f32 exactly as
    the reference does (``1.1 * 1.3`` etc. — src/structs.rs:381-393).
    """

    substitution: np.float32 = field(default_factory=lambda: f32(f32(1.1) * f32(1.3)))
    insertion: np.float32 = field(default_factory=lambda: f32(f32(0.4) * f32(1.3)))
    deletion: np.float32 = field(default_factory=lambda: f32(f32(0.7) * f32(1.3)))
    swap: np.float32 = field(default_factory=lambda: f32(f32(0.4) * f32(1.3)))

    @staticmethod
    def default() -> "FuzzyPenalties":
        return FuzzyPenalties()

    def with_insertion(self, p: float) -> "FuzzyPenalties":
        return replace(self, insertion=f32(p))

    def with_deletion(self, p: float) -> "FuzzyPenalties":
        return replace(self, deletion=f32(p))

    def with_substitution(self, p: float) -> "FuzzyPenalties":
        return replace(self, substitution=f32(p))

    def with_swap(self, p: float) -> "FuzzyPenalties":
        return replace(self, swap=f32(p))


@dataclass
class Pattern:
    """One search pattern plus its per-pattern settings
    (reference src/structs.rs:594-754)."""

    pattern: str
    grapheme_len: int = 0
    weight: np.float32 = field(default_factory=lambda: f32(1.0))
    limits: Optional[FuzzyLimits] = None
    custom_unique_id: Optional[int] = None

    def __post_init__(self):
        if self.grapheme_len == 0 and self.pattern:
            self.grapheme_len = grapheme_len(self.pattern)
        self.weight = f32(self.weight)

    # --- From conversions (reference src/structs.rs:660-754) ---
    @staticmethod
    def of(spec: Union["Pattern", str, tuple]) -> "Pattern":
        if isinstance(spec, Pattern):
            return spec
        if isinstance(spec, str):
            return Pattern(pattern=spec)
        if isinstance(spec, tuple):
            if len(spec) == 2:
                s, w = spec
                return Pattern(pattern=s, weight=f32(w))
            if len(spec) == 3:
                s, w, max_edits = spec
                return Pattern(
                    pattern=s,
                    weight=f32(w),
                    limits=FuzzyLimits().edits(int(max_edits)).finalize(),
                )
        raise TypeError(f"cannot build Pattern from {spec!r}")

    def as_str(self) -> str:
        return self.pattern

    def __len__(self) -> int:
        return len(self.pattern.encode("utf-8"))

    def is_empty(self) -> bool:
        return len(self.pattern) == 0

    def with_weight(self, weight: float) -> "Pattern":
        self.weight = f32(weight)
        return self

    def fuzzy(self, limits: FuzzyLimits) -> "Pattern":
        self.limits = limits.finalize()
        return self

    def with_custom_unique_id(self, id_: int) -> "Pattern":
        self.custom_unique_id = id_
        return self

    def __str__(self) -> str:
        return self.pattern


@dataclass
class FuzzyMatch:
    """Result of a search (reference src/structs.rs:756-781).

    ``start``/``end`` are byte offsets into the haystack; ``similarity`` is
    the f32 score ``(N - penalties) / N * weight``.
    """

    insertions: NumEdits
    deletions: NumEdits
    substitutions: NumEdits
    swaps: NumEdits
    edits: NumEdits
    pattern_index: PatternIndex
    pattern: Pattern
    start: int
    end: int
    similarity: np.float32
    text: str


class LazyMatchList:
    """List of :class:`FuzzyMatch` materialized on demand from
    struct-of-arrays columns.

    The device kernels return match tuples as numpy columns (start/end byte
    offsets, pattern index, f32 similarity, packed edit counts). All match
    DATA is fully computed; only the Python object per match is deferred —
    ``len()``, emptiness and slicing metadata cost nothing, and a caller that
    never touches individual matches (counting, threshold sweeps) skips the
    per-object construction entirely. First element access materializes the
    whole list once and the object then behaves as a plain list.
    """

    __slots__ = ("_patterns", "_hay_bytes", "_start", "_end", "_pat", "_sim", "_cnts", "_list")

    def __init__(self, patterns, hay_bytes, start, end, pat, sim, cnts):
        self._patterns = patterns
        self._hay_bytes = hay_bytes
        self._start = start
        self._end = end
        self._pat = pat
        self._sim = sim
        self._cnts = cnts
        self._list = None

    def _mat(self) -> list:
        if self._list is None:
            pats = self._patterns
            hb = self._hay_bytes
            cn = np.asarray(self._cnts, dtype=np.int64)
            ins = cn & 0xFF
            de = (cn >> 8) & 0xFF
            su = (cn >> 16) & 0xFF
            sw = (cn >> 24) & 0xFF
            ed = ins + de + su + sw
            sim = np.asarray(self._sim, dtype=np.float32)
            self._list = [
                FuzzyMatch(
                    insertions=int(i_), deletions=int(d_), substitutions=int(u_),
                    swaps=int(w_), edits=int(e_), pattern_index=int(p_),
                    pattern=pats[int(p_)], start=int(s_), end=int(t_),
                    similarity=m_, text=hb[int(s_):int(t_)].decode("utf-8"),
                )
                for i_, d_, u_, w_, e_, p_, s_, t_, m_ in zip(
                    ins, de, su, sw, ed, self._pat, self._start, self._end, sim
                )
            ]
        return self._list

    def __len__(self) -> int:
        return len(self._list) if self._list is not None else len(self._start)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __repr__(self) -> str:
        return repr(self._mat())

    def __eq__(self, other):
        return self._mat() == (other._mat() if isinstance(other, LazyMatchList) else other)

    def sort(self, *a, **kw):
        self._mat().sort(*a, **kw)

    def append(self, x):
        self._mat().append(x)

    def extend(self, xs):
        self._mat().extend(xs)

    # --- vectorized helpers (used by FuzzyMatches.apply before
    # materialization; no-ops once _mat() has run) ------------------------
    @property
    def unmaterialized(self) -> bool:
        return self._list is None

    def columns(self):
        """(start, end, pattern_index, similarity f32, pattern grapheme
        lens) as numpy arrays — for vectorized ranking."""
        pat = np.asarray(self._pat, dtype=np.int64)
        plens = np.asarray(
            [len(p) for p in self._patterns], dtype=np.int64
        )[pat]
        return (
            np.asarray(self._start, dtype=np.int64),
            np.asarray(self._end, dtype=np.int64),
            pat,
            np.asarray(self._sim, dtype=np.float32),
            plens,
        )

    def reorder(self, order) -> None:
        """Permute the columns in place (pre-materialization sort)."""
        assert self._list is None
        self._start = np.asarray(self._start)[order]
        self._end = np.asarray(self._end)[order]
        self._pat = np.asarray(self._pat)[order]
        self._sim = np.asarray(self._sim)[order]
        self._cnts = np.asarray(self._cnts)[order]


@dataclass
class UnmatchedSegment:
    """An unmatched run of the haystack (reference src/structs.rs:814-822)."""

    start: int
    end: int
    text: str


class Segment:
    """Either a matched span or an unmatched gap (reference src/structs.rs:785-846)."""

    __slots__ = ("_m", "_u")

    def __init__(self, matched: Optional[FuzzyMatch] = None, unmatched: Optional[UnmatchedSegment] = None):
        self._m = matched
        self._u = unmatched

    @staticmethod
    def of_match(m: FuzzyMatch) -> "Segment":
        return Segment(matched=m)

    @staticmethod
    def of_unmatched(u: UnmatchedSegment) -> "Segment":
        return Segment(unmatched=u)

    def matched(self) -> Optional[FuzzyMatch]:
        return self._m

    def unmatched(self) -> Optional[UnmatchedSegment]:
        return self._u

    @property
    def is_matched(self) -> bool:
        return self._m is not None

    def as_str(self) -> str:
        return self._m.text if self._m is not None else self._u.text

    def __len__(self) -> int:
        return len(self.as_str().encode("utf-8"))

    def is_empty(self) -> bool:
        return len(self.as_str()) == 0

    def __repr__(self) -> str:
        if self._m is not None:
            return f"Segment.Matched({self._m!r})"
        return f"Segment.Unmatched({self._u!r})"


def unique_id_of(m: FuzzyMatch) -> tuple:
    """Pattern identity for unique overlap resolution (reference src/structs.rs:586-592):
    the ``custom_unique_id`` when set, else the pattern index."""
    if m.pattern.custom_unique_id is not None:
        return ("custom", m.pattern.custom_unique_id)
    return ("auto", m.pattern_index)
