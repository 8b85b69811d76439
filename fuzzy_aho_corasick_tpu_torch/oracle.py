"""Conformance oracle: exact re-implementation of the reference search semantics.

This is the pure-host engine that defines the *behavior* the device kernels must
reproduce (SURVEY §7 build order, step 1). It mirrors the reference's
per-start-position BFS (reference: src/search.rs:418-1119) including:

* state dedup keyed by ``(node, j, span, edit-type counts)`` -> min penalty
  (src/search.rs:31-50, 608-628),
* per-node prune ceilings ``pen > prune_len - prune_len_over_weight * theta``
  (src/search.rs:637-642) and global push-time guards (src/search.rs:646-648),
* the 2-gram window-skip for 1-edit searches (src/search.rs:504-552),
* all edit branches: exact, substitution (similarity-scaled, weakest-link
  floor, dead-end filter), multi-char mappings, swap, insertion, deletion
  (src/search.rs:776-1089),
* beam / auto-beam frontier bounding (src/search.rs:578-589, 1096-1103),
* best-per-(start, end, pattern) emission (src/search.rs:659-737).

All scoring arithmetic is float32 (numpy scalars) so similarities match the
reference bit-for-bit. Positions are grapheme indices; emitted offsets are
byte offsets, as in the reference.

Determinism notes (differences that cannot change the accepted match set):
* edge iteration order is trie-insertion order rather than the reference's
  FxHash bucket order — observable only through tie-breaking under an
  explicit ``beam_width`` and in which equal-similarity edit *breakdown* wins
  a span (the (pattern, span, similarity) tuples are identical);
* beam truncation keeps the ``bw`` lowest-penalty states via a stable sort
  rather than Rust's unstable selection (same set when penalties are unique).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .errors import HaystackTooLarge
from .structs import FuzzyLimits, FuzzyMatch, f32
from .utils.graphemes import HaystackView

U32_MAX = 0xFFFFFFFF


def _within_limits(engine, limits: Optional[FuzzyLimits], edits, ins, dels, subs, swaps) -> bool:
    """Emission-time limit check (reference src/search.rs:151-169)."""
    mx = limits if limits is not None else engine.limits
    if mx is None:
        return edits == 0 and ins == 0 and dels == 0 and subs == 0 and swaps == 0
    return (
        (mx.edits_ is None or edits <= mx.edits_)
        and (mx.insertions_ is None or ins <= mx.insertions_)
        and (mx.deletions_ is None or dels <= mx.deletions_)
        and (mx.substitutions_ is None or subs <= mx.substitutions_)
        and (mx.swaps_ is None or swaps <= mx.swaps_)
    )


def _within_subst(engine, limits, edits, subs) -> bool:
    """Substitution ahead-check (reference src/search.rs:134-146)."""
    mx = limits if limits is not None else engine.limits
    if mx is None:
        return edits == 0 and subs == 0
    return (mx.edits_ is None or edits < mx.edits_) and (
        mx.substitutions_ is None or subs < mx.substitutions_
    )


def _within_ahead(engine, limits, edits, count, field: str) -> bool:
    """Insertion/deletion/swap ahead-checks (reference src/search.rs:87-130)."""
    mx = limits if limits is not None else engine.limits
    if mx is None:
        return False
    cap = getattr(mx, field)
    return (mx.edits_ is None or edits < mx.edits_) and (cap is None or count < cap)


def _node_limits(engine, node: int) -> Optional[FuzzyLimits]:
    """Per-node pattern limits (reference src/search.rs:67-71)."""
    pi = engine.nodes[node].pattern_index
    if pi is None:
        return None
    return engine._patterns[pi].limits


def search_raw(
    engine, haystack: str, similarity_threshold: float, only_first_window: bool = False
) -> list[FuzzyMatch]:
    """Core fuzzy search producing raw best-per-span matches
    (reference src/search.rs:187-395 -> 418-1119).

    ``only_first_window`` restricts the outer loop to start position 0 — used
    by the device path's beam-overflow rescue, where a single start window is
    re-searched on the host.

    Raises :class:`HaystackTooLarge` if the haystack has more than ``u32::MAX``
    grapheme clusters (reference src/search.rs:198-202).
    """
    thr = f32(similarity_threshold)
    view = HaystackView(haystack, engine.case_insensitive)
    text_len = len(view)
    if text_len > U32_MAX:
        raise HaystackTooLarge(text_len)
    if text_len == 0:
        return []

    text_chars = view.chars()
    nodes = engine.nodes
    patterns = engine._patterns
    pens = engine.penalties
    similarity = engine.similarity
    mappings = engine.mappings
    MAPPINGS = bool(mappings)
    has_pattern_limits = engine.has_pattern_limits
    min_symbol_similarity = engine.min_symbol_similarity

    # Fast-path dispatch (reference src/search.rs:204-393): values 1..=6 use
    # the monomorphized fast ceiling; anything else takes the general path.
    mef = engine.max_edits_fast
    MEF = mef if 1 <= mef <= 6 else 255
    FAST = MEF != 255
    WINDOW_SKIP = MEF == 1

    # Per-node prune ceilings for this threshold, f32 (reference src/search.rs:637-642):
    # prune_len - prune_len_over_weight * thr, each op f32-rounded.
    node_ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    max_penalties = node_ceil[0]
    p_sub, p_ins, p_del, p_swap = pens.substitution, pens.insertion, pens.deletion, pens.swap

    # 2-gram window skip precompute (reference src/search.rs:504-521).
    window_skip = None
    root = nodes[0]
    if WINDOW_SKIP and not MAPPINGS and not root.output:
        first = root.single_char_edge_bits()
        second = 0
        child_output = False
        for _fc, nxt, _sb in root.edges:
            child = nodes[nxt]
            child_bits = child.single_char_edge_bits()
            second |= child_bits
            first |= child_bits
            if child.output:
                child_output = True
        if not child_output:
            window_skip = (first, second)

    effective_beam = engine.beam_width
    auto_beam = engine.auto_beam
    states_expanded = 0

    best: dict[tuple[int, int, int], FuzzyMatch] = {}
    sim_get = similarity.get
    ZERO = f32(0.0)
    hay_bytes = haystack.encode("utf-8")
    hay_byte_len = len(hay_bytes)

    # Observability (reference: the cfg(test) trace! macro, src/search.rs:52-61,
    # and per-state debug notes): cheap counters always; verbose expansion
    # tracing when FAC_TRACE is set.
    import os

    trace_on = bool(os.environ.get("FAC_TRACE"))
    stats = {"backend": "oracle", "windows": 0, "windows_skipped": 0,
             "states_expanded": 0, "states_deduped": 0, "states_pruned": 0}

    start_range = range(1) if only_first_window else range(text_len)
    for start0 in start_range:
        stats["windows"] += 1
        if window_skip is not None:
            ch = text_chars[start0]
            ch_idx = ord(ch)
            if ch_idx < 128 and not (window_skip[0] >> ch_idx) & 1:
                nxt_idx = start0 + 1
                if nxt_idx >= text_len:
                    stats["windows_skipped"] += 1
                    continue
                next_ch = text_chars[nxt_idx]
                next_ch_idx = ord(next_ch)
                if next_ch_idx < 128 and not (window_skip[1] >> next_ch_idx) & 1:
                    stats["windows_skipped"] += 1
                    continue

        # State tuple: (node, j, matched_start, matched_end, penalties,
        #               edits, ins, dels, subs, swaps)
        queue: list[tuple] = [(0, start0, start0, start0, ZERO, 0, 0, 0, 0, 0)]
        visited: dict[tuple, np.float32] = {}
        q_idx = 0

        while q_idx < len(queue):
            if effective_beam is not None:
                remaining_states = len(queue) - q_idx
                if remaining_states > effective_beam * 2:
                    tail = queue[q_idx:]
                    tail.sort(key=lambda s: s[4])
                    queue[q_idx:] = tail[:effective_beam]

            node, j, ms, me, penalties, edits, ins, dels, subs, swaps = queue[q_idx]
            q_idx += 1

            # State dedup (reference src/search.rs:608-628).
            dk = (node, j, ms, me, ins, dels, subs, swaps)
            prev = visited.get(dk)
            if prev is not None and prev <= penalties:
                stats["states_deduped"] += 1
                continue
            visited[dk] = penalties

            node_ref = nodes[node]
            # Per-node prune ceiling (reference src/search.rs:637-642).
            if penalties > node_ceil[node]:
                stats["states_pruned"] += 1
                continue
            stats["states_expanded"] += 1
            if trace_on:
                print(
                    f"trace: start={start0} node={node} j={j} span=[{ms},{me}) "
                    f"pen={float(penalties):.3f} e={edits} i={ins} d={dels} s={subs} w={swaps}"
                )

            output = node_ref.output
            edges = node_ref.edges
            remaining = max_penalties - penalties

            node_limits = _node_limits(engine, node) if has_pattern_limits else None

            if output:
                sb = view.byte_offset(ms) if ms < text_len else 0
                eb = view.byte_offset(me) if me < text_len else hay_byte_len
                for pattern_index in output:
                    if FAST:
                        if edits > MEF:
                            continue
                    elif not _within_limits(
                        engine, patterns[pattern_index].limits, edits, ins, dels, subs, swaps
                    ):
                        continue
                    pat = patterns[pattern_index]
                    total = f32(pat.grapheme_len)
                    # Empty patterns give 0/0 = NaN, matching the reference's
                    # f32 semantics (NaN < threshold is false, so the match is
                    # kept) — suppress only the numpy warning, not the NaN.
                    with np.errstate(invalid="ignore", divide="ignore"):
                        sim = np.float32(np.float32(np.float32(total - penalties) / total) * pat.weight)
                    if sim < thr:
                        continue
                    key = (sb, eb, pattern_index)
                    entry = best.get(key)
                    if entry is None or sim > entry.similarity:
                        best[key] = FuzzyMatch(
                            insertions=ins, deletions=dels, substitutions=subs,
                            swaps=swaps, edits=edits, pattern_index=pattern_index,
                            pattern=pat, start=sb, end=eb, similarity=sim, text="",
                        )

            is_last_edit = FAST and edits + 1 >= MEF
            current_ch = text_chars[j] if j < text_len else "\0"

            if j < text_len:
                if is_last_edit and edits < MEF and j + 1 < text_len:
                    next_ch_opt = text_chars[j + 1]
                else:
                    next_ch_opt = None
                ms_next = j if me == ms else ms

                # Exact transition (reference src/search.rs:776-798).
                exact_next = _find_transition(node_ref, view, j, current_ch, MAPPINGS)
                if exact_next is not None:
                    queue.append((exact_next, j + 1, ms_next, j + 1, penalties,
                                  edits, ins, dels, subs, swaps))

                # Substitutions (reference src/search.rs:803-874).
                if FAST:
                    subst_ok = edits < MEF
                else:
                    subst_ok = _within_subst(engine, node_limits, edits, subs)
                if subst_ok:
                    for first_char, next_node, _sb_edge in edges:
                        if next_node == exact_next:
                            continue
                        sim = f32(1.0) if first_char == current_ch else sim_get(first_char, current_ch)
                        if sim < min_symbol_similarity:
                            continue
                        penalty = np.float32(p_sub * np.float32(1.0 - sim))
                        if penalty > remaining:
                            continue
                        if is_last_edit:
                            child = nodes[next_node]
                            if not child.output and (
                                next_ch_opt is None or not child.has_matching_edge_char(next_ch_opt)
                            ):
                                continue
                        queue.append((next_node, j + 1, ms_next, j + 1,
                                      np.float32(penalties + penalty),
                                      edits + 1, ins, dels, subs + 1, swaps))

                    # Multi-character mappings (reference src/search.rs:883-923).
                    if MAPPINGS:
                        mts = mappings.get(node)
                        if mts is not None:
                            for mt in mts:
                                hlen = len(mt.haystack)
                                if j + hlen > text_len:
                                    continue
                                if any(view.text(j + k) != g for k, g in enumerate(mt.haystack)):
                                    continue
                                new_pen = np.float32(penalties + mt.penalty)
                                if new_pen > max_penalties:
                                    continue
                                queue.append((mt.next, j + hlen, ms_next, j + hlen,
                                              new_pen, edits + 1, ins, dels, subs + 1, swaps))

                # Swap / transposition (reference src/search.rs:935-989).
                if j + 1 < text_len and p_swap <= remaining and (not FAST or edits < MEF):
                    next_ch = next_ch_opt if next_ch_opt is not None else text_chars[j + 1]
                    mid = _find_transition(node_ref, view, j + 1, next_ch, MAPPINGS)
                    node2 = None
                    if mid is not None:
                        node2 = _find_transition(nodes[mid], view, j, current_ch, MAPPINGS)
                    if node2 is not None and (
                        FAST
                        or _within_ahead(engine, _node_limits(engine, node2), edits, swaps, "swaps_")
                    ):
                        queue.append((node2, j + 2, ms, j + 2,
                                      np.float32(penalties + p_swap),
                                      edits + 1, ins, dels, subs, swaps + 1))

                # Insertion (reference src/search.rs:994-1029).
                if (
                    (ms != me or ms != j)
                    and p_ins <= remaining
                    and (edits < MEF if FAST else _within_ahead(engine, node_limits, edits, ins, "insertions_"))
                    and not (
                        is_last_edit
                        and not output
                        and (next_ch_opt is None or not node_ref.has_matching_edge_char(next_ch_opt))
                    )
                ):
                    queue.append((node, j + 1, ms, me,
                                  np.float32(penalties + p_ins),
                                  edits + 1, ins + 1, dels, subs, swaps))

            # Deletion — even at j == len (reference src/search.rs:1035-1089).
            if p_del <= remaining and (
                edits < MEF if FAST else _within_ahead(engine, node_limits, edits, dels, "deletions_")
            ):
                current_ch_opt = current_ch if (is_last_edit and j < text_len) else None
                for _first_char, next_node2, _sb_edge in edges:
                    if is_last_edit:
                        child = nodes[next_node2]
                        if not child.output and (
                            current_ch_opt is None
                            or not child.has_matching_edge_char(current_ch_opt)
                        ):
                            continue
                    queue.append((next_node2, j, ms, me,
                                  np.float32(penalties + p_del),
                                  edits + 1, ins, dels + 1, subs, swaps))

        # Auto-beam budget accounting (reference src/search.rs:1096-1103).
        if auto_beam is not None and effective_beam is None:
            states_expanded += len(queue)
            if states_expanded > auto_beam[0]:
                effective_beam = auto_beam[1]

    out = list(best.values())
    for m in out:
        m.text = hay_bytes[m.start : m.end].decode("utf-8")
    stats["matches"] = len(out)
    engine.last_stats = stats
    return out


def _find_transition(node, view: HaystackView, idx: int, ch: str, MAPPINGS: bool) -> Optional[int]:
    """Exact-transition lookup, matching the reference's monomorphized paths
    (reference src/search.rs:776-780, src/grapheme.rs:69-71, 120-124,
    src/structs.rs:499-519)."""
    if MAPPINGS:
        if view.ascii:
            # Single-byte edges only (find_transition_char).
            for first_char, nxt, single in node.edges:
                if single and first_char == ch:
                    return nxt
            return None
        return node.transitions.get(view.text(idx))
    # No mappings: first-char scan over all edges (find_transition_char_no_mappings).
    for first_char, nxt, _single in node.edges:
        if first_char == ch:
            return nxt
    return None
