"""Device search engine: dispatch layer over the CUDA kernels.

Same contract and the same eligibility as the JAX package's
``ops/engine.py``: ``supports`` says whether the device path serves an
(engine, haystack) pair, ``search_raw`` serves it. An engine is claimed by a
lane exactly when the JAX package claims it (the host-only spec builders of
``ops/verify_dp`` decide the mapped and typed lanes, as there); everything
else is served by the host oracle.

Lanes: exact (``ops/exact``: the packed lane, then the goto walk), the DP
family of ``ops/verify_dp`` — the FAST fuzzy lane (``ops/fuzzy``; beamed
engines too), and the forbid, typed and mapped lanes — the large-dictionary
lane (``ops/many``) and, for FAST engines that those decline, the beam
frontier (``ops/fuzzy.beam_search``). Where the JAX package itself falls
back to the oracle, so does the port.
"""

from __future__ import annotations

from typing import List, Optional

from ..structs import FuzzyMatch
from ..utils import trace


def _max_edit_budget(engine) -> Optional[int]:
    """Maximum total-edit budget across global/per-pattern limits
    (reference limit semantics: src/structs.rs:283-335)."""

    def edits_of(lim) -> int:
        if lim.edits_ is not None:
            return lim.edits_
        return (
            (lim.insertions_ or 0)
            + (lim.deletions_ or 0)
            + (lim.substitutions_ or 0)
            + (lim.swaps_ or 0)
        )

    budget = 0
    for p in engine._patterns:
        lim = p.limits if p.limits is not None else engine.limits
        if lim is not None:
            budget = max(budget, edits_of(lim))
    return budget


class DeviceEngine:
    """Per-engine device dispatcher (lazily constructed by
    :class:`fuzzy_aho_corasick_tpu_torch.automaton.FuzzyAhoCorasick`)."""

    def __init__(self, engine):
        self.engine = engine
        e = engine
        # Exact mode: no edit budget anywhere -> the packed shift-AND lane,
        # or the goto walk where the dictionary does not pack.
        self._exact_ok = _max_edit_budget(e) == 0 and not e.mappings
        # Beam configs (beam_width / auto_beam) are the reference's speed
        # knobs bounding the host BFS frontier (src/search.rs:578-589); the
        # device DP has no frontier to bound, so beamed engines are served by
        # the exact DP lane, and fall back to the (beamed) host oracle whole
        # where it declines.
        self._beamed = e.beam_width is not None or e.auto_beam is not None
        # Fuzzy fast-path mode: global total-edits budget 1..6, no
        # per-pattern limits, no mappings (reference src/builder.rs:446-468).
        self._fuzzy_ok = (
            1 <= e.max_edits_fast <= 6
            and not e.has_pattern_limits
            and not e.mappings
            and not e.nodes[0].output  # no empty patterns
        )
        # Mapped mode: FAST budget + multi-char mappings, where MappedSpec
        # models the engine (single-byte edges, pb <= 3, |ha - pb| <= 1).
        self._mapped_ok = False
        if (
            1 <= e.max_edits_fast <= 6
            and not e.has_pattern_limits
            and e.mappings
            and not e.nodes[0].output
        ):
            from .verify_dp import mapped_spec_of

            self._mapped_ok = mapped_spec_of(e) is not None
        # Typed mode: per-type caps and/or per-pattern limits, where
        # TypedSpec and the packed prefilter model hold the engine.
        self._typed_ok = False
        if (
            not self._exact_ok
            and not self._fuzzy_ok
            and not self._mapped_ok
            and not e.mappings
            and not e.nodes[0].output
        ):
            from .packed_bitap import packed_fuzzy_of
            from .verify_dp import typed_spec_of, verify_fields_of

            self._typed_ok = (
                typed_spec_of(e) is not None
                and packed_fuzzy_of(e) is not None
                and verify_fields_of(e) is not None
            )

    def supports(self, haystack: str) -> bool:
        """Whether the device path serves this (engine, haystack) pair with
        results identical to the oracle (possibly via host fallback for
        haystacks outside a lane's model, as in the JAX package)."""
        if not (self._exact_ok or self._fuzzy_ok or self._typed_ok
                or self._mapped_ok):
            return False
        # Root-output (empty-pattern) exact configs keep the oracle's NaN
        # semantics; not worth a kernel.
        if self._exact_ok and self.engine.nodes[0].output:
            return False
        return True

    def search_raw(self, haystack: str, threshold: float) -> List[FuzzyMatch]:
        """The lane's search, under the root span of ``utils/trace``: every
        device lane's ``last_stats`` gets ``host_waits``, and where
        ``FAC_TIME=1`` the search's spans."""
        with trace.search(self.engine, haystack):
            return self._search_raw(haystack, threshold)

    def _search_raw(self, haystack: str, threshold: float) -> List[FuzzyMatch]:
        from .. import oracle
        from ..automaton import checked_device
        from ..utils.graphemes import view_of

        e = self.engine
        checked_device(e.device)
        if self._exact_ok:
            from .exact import exact_search_device

            return exact_search_device(e, haystack, threshold)
        if self._fuzzy_ok:
            if not self._beamed:
                from .fuzzy import fuzzy_search_device

                return fuzzy_search_device(e, haystack, threshold)
            # Beamed: the DP lane, then the large-dictionary lane if the
            # engine does not pack; where they decline, the beamed host
            # oracle (the JAX package's order).
            from .many import fuzzy_search_many
            from .packed_bitap import packed_fuzzy_of
            from .verify_dp import fuzzy_search_dp

            view = view_of(haystack, e.case_insensitive)
            n = len(view)
            if n == 0:
                return []
            res = fuzzy_search_dp(e, haystack, threshold, view, n)
            if res is None and packed_fuzzy_of(e) is None:
                res = fuzzy_search_many(e, haystack, threshold, view, n)
            if res is None:
                return oracle.search_raw(e, haystack, threshold)
            return res
        if self._mapped_ok:
            from .verify_dp import fuzzy_search_mapped_device

            return fuzzy_search_mapped_device(e, haystack, threshold)
        from .verify_dp import fuzzy_search_typed_device

        return fuzzy_search_typed_device(e, haystack, threshold)
