"""Host-side automaton compiler (reference: src/builder.rs).

Builds the trie over case-folded grapheme clusters, BFS failure links with
output/weight merging, the Horák fail-chain weight pass, per-node reachability
pruning coefficients, precomputed multi-character mapping transitions, and the
fast-path edit ceiling — then hands the result to
:class:`fuzzy_aho_corasick_tpu_torch.automaton.FuzzyAhoCorasick`.

This phase is pure host logic (the reference's whole build is single-threaded
host code too); the dense arrays for the device kernels are derived lazily in
:mod:`fuzzy_aho_corasick_tpu_torch.ops.dense`.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .structs import (
    DEFAULT_SIMILARITY,
    FuzzyLimits,
    FuzzyPenalties,
    Pattern,
    Similarity,
    f32,
)
from .utils.graphemes import fold_graphemes


class Node:
    """One automaton node (reference src/structs.rs:249-281), host form.

    ``transitions`` maps folded grapheme -> child index; ``edges`` is the same
    in flat iteration-friendly form ``(first_char, next, single_byte)``
    (reference src/structs.rs:186-229: the packed 8-byte Edge — here a plain
    tuple, since the device form is dense arrays, not this object graph).
    """

    __slots__ = (
        "transitions",
        "edges",
        "output",
        "fail",
        "weight",
        "prune_len",
        "prune_len_over_weight",
        "pattern_index",
        "depth",
    )

    def __init__(self, depth: int = 0):
        self.transitions: dict[str, int] = {}
        self.edges: list[tuple[str, int, bool]] = []
        self.output: list[int] = []
        self.fail: int = 0
        self.weight: np.float32 = f32(0.0)
        self.prune_len: np.float32 = f32(0.0)
        self.prune_len_over_weight: np.float32 = f32(0.0)
        self.pattern_index: Optional[int] = None
        self.depth = depth

    def find_transition(self, grapheme: str) -> Optional[int]:
        """Exact transition lookup (reference src/structs.rs:452-464)."""
        return self.transitions.get(grapheme)

    def has_matching_edge_char(self, ch: str) -> bool:
        """Whether any single-ASCII-byte edge starts with ``ch``
        (reference src/structs.rs:471-476)."""
        for first_char, _next, single in self.edges:
            if single and first_char == ch:
                return True
        return False

    def single_char_edge_bits(self) -> int:
        """Bitmap of single-ASCII-byte edge chars (reference src/structs.rs:482-493)."""
        bits = 0
        for first_char, _next, single in self.edges:
            if single:
                idx = ord(first_char)
                if idx < 128:
                    bits |= 1 << idx
        return bits


class MappingTransition:
    """A precomputed multi-char mapping transition (reference src/structs.rs:234-242)."""

    __slots__ = ("haystack", "next", "penalty")

    def __init__(self, haystack: tuple[str, ...], next_: int, penalty: np.float32):
        self.haystack = haystack
        self.next = next_
        self.penalty = penalty


def _pmf(weight: np.float32, word_len: int, prefix_len: int) -> np.float32:
    """Prefix-membership weight (reference src/builder.rs:148-150)."""
    return f32(weight * f32(f32(word_len - prefix_len + 1) / f32(word_len)))


class FuzzyAhoCorasickBuilder:
    """Builder for the fuzzy Aho-Corasick engine (reference src/builder.rs:23-143)."""

    def __init__(self):
        self._similarity: Optional[Similarity] = None
        self._limits: Optional[FuzzyLimits] = None
        self._penalties: FuzzyPenalties = FuzzyPenalties()
        self._case_insensitive: bool = False
        self._beam_width: Optional[int] = None
        self._auto_beam: Optional[Tuple[int, int]] = None
        self._mappings: List[Tuple[str, str, float]] = []
        self._min_symbol_similarity: float = 0.0
        self._device = "cuda"

    @staticmethod
    def new() -> "FuzzyAhoCorasickBuilder":
        return FuzzyAhoCorasickBuilder()

    def similarity(self, similarity: Similarity) -> "FuzzyAhoCorasickBuilder":
        self._similarity = similarity
        return self

    def fuzzy(self, limits: FuzzyLimits) -> "FuzzyAhoCorasickBuilder":
        self._limits = limits.finalize()
        return self

    def penalties(self, penalties: FuzzyPenalties) -> "FuzzyAhoCorasickBuilder":
        self._penalties = penalties
        return self

    def case_insensitive(self, value: bool) -> "FuzzyAhoCorasickBuilder":
        self._case_insensitive = value
        return self

    def beam_width(self, width: int) -> "FuzzyAhoCorasickBuilder":
        self._beam_width = width
        return self

    def auto_beam(self, budget: int, width: int) -> "FuzzyAhoCorasickBuilder":
        self._auto_beam = (budget, width)
        return self

    def mapping(self, a: str, b: str) -> "FuzzyAhoCorasickBuilder":
        """Bidirectional multi-char equivalence, score 1.0 (reference src/builder.rs:116-118)."""
        return self.mapping_scored(a, b, 1.0)

    def mapping_scored(self, a: str, b: str, score: float) -> "FuzzyAhoCorasickBuilder":
        self._mappings.append((a, b, score))
        return self

    def min_symbol_similarity(self, min_: float) -> "FuzzyAhoCorasickBuilder":
        self._min_symbol_similarity = min_
        return self

    def device(self, device) -> "FuzzyAhoCorasickBuilder":
        """The torch device the engine's kernel tables live on (default
        ``"cuda"``; see :meth:`FuzzyAhoCorasick.to`)."""
        self._device = device
        return self

    def build_replacer(self, pairs) -> "FuzzyReplacer":
        """Build a turnkey replacer from (pattern, replacement) pairs — any
        iterable of 2-tuples, or a dict (reference src/builder.rs:156-168)."""
        from .replacer import FuzzyReplacer

        if isinstance(pairs, dict):
            pairs = pairs.items()
        patterns = []
        replacements = []
        for p, r in pairs:
            patterns.append(p)
            replacements.append(r)
        return FuzzyReplacer(self.build(patterns), replacements)

    def build(self, inputs: Iterable) -> "FuzzyAhoCorasick":
        """Compile the pattern set into an immutable engine
        (reference src/builder.rs:181-484)."""
        from .automaton import FuzzyAhoCorasick

        patterns: List[Pattern] = [Pattern.of(x) for x in inputs]
        similarity = self._similarity if self._similarity is not None else DEFAULT_SIMILARITY()

        nodes: List[Node] = [Node(depth=0)]

        # --- trie insertion over case-folded graphemes (reference src/builder.rs:195-237)
        for i, pattern in enumerate(patterns):
            current = 0
            word_iter = fold_graphemes(pattern.pattern, self._case_insensitive)
            for j, grapheme in enumerate(word_iter):
                nxt = nodes[current].transitions.get(grapheme)
                if nxt is None:
                    nxt = len(nodes)
                    nodes[current].transitions[grapheme] = nxt
                    nodes.append(Node(depth=nodes[current].depth + 1))
                if nodes[nxt].pattern_index is None:
                    nodes[nxt].pattern_index = i
                current = nxt
                updated_weight = _pmf(pattern.weight, len(word_iter), j + 1)
                if updated_weight > nodes[current].weight:
                    nodes[current].weight = updated_weight
            nodes[current].output.append(i)
            if pattern.weight > nodes[current].weight:
                nodes[current].weight = f32(pattern.weight)

        # --- BFS failure links + output merge + weight max (reference src/builder.rs:239-276)
        queue: deque[int] = deque()
        for child in nodes[0].transitions.values():
            nodes[child].fail = 0
            queue.append(child)
        while queue:
            current = queue.popleft()
            for g, nxt in list(nodes[current].transitions.items()):
                fail = nodes[current].fail
                while fail != 0 and g not in nodes[fail].transitions:
                    fail = nodes[fail].fail
                fallback = nodes[fail].transitions.get(g, 0)
                nodes[nxt].fail = fallback
                for entry in nodes[fallback].output:
                    if entry not in nodes[nxt].output:
                        nodes[nxt].output.append(entry)
                if nodes[nxt].weight < nodes[fallback].weight:
                    nodes[nxt].weight = nodes[fallback].weight
                queue.append(nxt)

        # --- fail-chain weight propagation, Horák pass (reference src/builder.rs:279-284)
        for i in range(len(nodes) - 1, 0, -1):
            fidx = nodes[i].fail
            if nodes[fidx].weight > nodes[i].weight:
                nodes[i].weight = nodes[fidx].weight

        # --- effective limits from per-pattern maxima (reference src/builder.rs:287-329)
        effective_limits = self._limits
        if effective_limits is None:
            maxes = {"edits_": None, "insertions_": None, "deletions_": None,
                     "substitutions_": None, "swaps_": None}
            any_pattern_limits = False
            for p in patterns:
                if p.limits is not None:
                    any_pattern_limits = True
                    for k in maxes:
                        v = getattr(p.limits, k)
                        if v is not None:
                            maxes[k] = v if maxes[k] is None else max(maxes[k], v)
            if any_pattern_limits:
                effective_limits = FuzzyLimits(**maxes)

        # --- flat edges from transitions (reference src/builder.rs:336-342).
        # Ordering note: the reference iterates its FxHashMap (deterministic
        # bucket order); here insertion order — equally deterministic, and
        # result-identical except for ties under an explicit beam.
        for node in nodes:
            node.edges = [
                (g[0] if g else "\0", nxt, len(g.encode("utf-8")) == 1)
                for g, nxt in node.transitions.items()
            ]

        # --- per-node reachability pruning coefficients (reference src/builder.rs:344-381)
        n = len(nodes)
        reach_len = np.zeros(n, dtype=np.int64)
        reach_weight = np.zeros(n, dtype=np.float32)
        for i, node in enumerate(nodes):
            for p in node.output:
                reach_len[i] = max(reach_len[i], patterns[p].grapheme_len)
                reach_weight[i] = max(reach_weight[i], patterns[p].weight)
        changed = True
        while changed:
            changed = False
            for i in range(n - 1, -1, -1):
                best_len, best_weight = reach_len[i], reach_weight[i]
                for child in nodes[i].transitions.values():
                    if reach_len[child] > best_len:
                        best_len = reach_len[child]
                    if reach_weight[child] > best_weight:
                        best_weight = reach_weight[child]
                if best_len > reach_len[i] or best_weight > reach_weight[i]:
                    reach_len[i] = best_len
                    reach_weight[i] = best_weight
                    changed = True
        with np.errstate(divide="ignore", invalid="ignore"):
            for i, node in enumerate(nodes):
                length = f32(reach_len[i])
                node.prune_len = length
                node.prune_len_over_weight = f32(length / reach_weight[i]) if reach_weight[i] != 0 else (
                    f32(0.0) if length == 0 else f32(np.inf)
                )

        # --- mapping transitions precompute (reference src/builder.rs:383-442)
        mappings: dict[int, list[MappingTransition]] = {}
        if self._mappings:
            directed: list[tuple[list[str], tuple[str, ...], np.float32]] = []
            for a, b, score in self._mappings:
                ga = fold_graphemes(a, self._case_insensitive)
                gb = fold_graphemes(b, self._case_insensitive)
                if not ga or not gb or ga == gb:
                    continue
                penalty = f32(self._penalties.substitution * f32(1.0 - f32(score)))
                directed.append((ga, tuple(gb), penalty))
                directed.append((gb, tuple(ga), penalty))
            for start in range(len(nodes)):
                mts: list[MappingTransition] = []
                for pat, hay, penalty in directed:
                    cur = start
                    ok = True
                    for g in pat:
                        nx = nodes[cur].transitions.get(g)
                        if nx is None:
                            ok = False
                            break
                        cur = nx
                    if ok:
                        mts.append(MappingTransition(hay, cur, penalty))
                if mts:
                    mappings[start] = mts

        has_pattern_limits = any(p.limits is not None for p in patterns)

        # --- fast-path edit ceiling (reference src/builder.rs:446-468)
        if has_pattern_limits:
            max_edits_fast = 255
        elif effective_limits is None:
            max_edits_fast = 0
        else:
            lim = effective_limits
            if (
                lim.edits_ is not None
                and lim.insertions_ is None
                and lim.deletions_ is None
                and lim.substitutions_ is None
                and lim.swaps_ is None
            ):
                max_edits_fast = lim.edits_
            else:
                max_edits_fast = 255

        engine = FuzzyAhoCorasick(
            nodes=nodes,
            patterns=patterns,
            similarity=similarity,
            limits=effective_limits,
            penalties=self._penalties,
            case_insensitive=self._case_insensitive,
            has_pattern_limits=has_pattern_limits,
            max_edits_fast=max_edits_fast,
            mappings=mappings,
            beam_width=self._beam_width,
            auto_beam=self._auto_beam,
            min_symbol_similarity=f32(self._min_symbol_similarity),
        )
        engine.device = torch.device(self._device)
        return engine
