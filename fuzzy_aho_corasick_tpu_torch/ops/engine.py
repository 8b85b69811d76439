"""Device search engine: dispatch layer over the CUDA kernels.

Same contract as the JAX package's ``ops/engine.py``: ``supports`` says
whether the device path serves an (engine, haystack) pair, ``search_raw``
serves it. The port carries the exact lane. The JAX package's other device
lanes (fuzzy, beamed, mapped, typed) are still to port; an engine that would
reach one of them is *supported* here and ``search_raw`` raises
``NotImplementedError`` naming the lane, so a device-sized haystack never
runs on the pure-Python oracle in their place. ``supports`` is False only
where the JAX package itself routes to the host.
"""

from __future__ import annotations

from typing import List, Optional

from ..structs import FuzzyMatch


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
        no_root = not e.nodes[0].output
        fast = 1 <= e.max_edits_fast <= 6 and not e.has_pattern_limits
        # Exact mode: no edit budget anywhere -> the packed shift-AND lane.
        self._exact_ok = _max_edit_budget(e) == 0 and not e.mappings
        # The JAX package's other lanes, by its own eligibility conditions
        # (ops/engine.py there): fuzzy fast path (beamed or not), mapped,
        # typed. The mapped and typed lanes also consult their DP specs
        # there; the port, not having them, treats every engine in their
        # envelope as theirs.
        if self._exact_ok:
            self._pending = None
        elif fast and not e.mappings and no_root:
            self._pending = (
                "beamed fuzzy DP lane (ROADMAP queue A item 4)"
                if e.beam_width is not None or e.auto_beam is not None
                else "fuzzy DP lane (ROADMAP queue A item 3)"
            )
        elif fast and e.mappings and no_root:
            self._pending = "mapped DP lane (ROADMAP queue A item 4)"
        elif not e.mappings and no_root:
            self._pending = "typed DP lane (ROADMAP queue A item 4)"
        else:
            self._pending = None

    def supports(self, haystack: str) -> bool:
        """Whether the device path serves this (engine, haystack) pair."""
        if self._pending is not None:
            return True
        # Root-output (empty-pattern) exact configs keep the oracle's NaN
        # semantics; not worth a kernel.
        return self._exact_ok and not self.engine.nodes[0].output

    def search_raw(self, haystack: str, threshold: float) -> List[FuzzyMatch]:
        from ..automaton import checked_device

        if self._pending is not None:
            raise NotImplementedError(
                f"this engine needs the {self._pending}, which is not ported "
                "to the torch package yet"
            )
        checked_device(self.engine.device)
        from .exact import exact_search_device

        return exact_search_device(self.engine, haystack, threshold)
