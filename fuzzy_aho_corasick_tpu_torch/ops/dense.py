"""Dense device tables compiled from the host automaton.

The reference's pointer-rich ``Node`` graph (src/structs.rs:249-281) becomes
flat arrays the device kernels gather from:

* a **char-class** alphabet: every edge first-char gets its own class
  (transition identity), and every other representable char (ASCII bytes +
  similarity-map chars) is grouped by its *similarity column* against the
  edge chars — two hay chars that no transition distinguishes and whose
  substitution costs agree everywhere share one class. Class 0 = "other"
  (no transitions, similarity 0 against everything — the same conservative
  bucket as the prefilter's symbol id 0, reference src/prefilter.rs:70-76).
  Compression keeps the alphabet small for typical dictionaries (vs 129+
  when every ASCII byte had its own class), which keeps the packed exact
  tables within their 128-symbol limit;
* ``goto[num_nodes, num_classes]`` int32 (-1 = no edge) reproducing the
  no-mappings first-char transition scan (reference src/structs.rs:511-519,
  first matching edge in edge order wins);
* padded per-node edge lists for the substitution/deletion scans
  (reference src/search.rs:813-874, 1035-1089);
* CSR outputs, per-node prune coefficients, per-pattern length/weight, and
  the dense class-pair similarity matrix.

Transcoding a haystack to class ids is a single vectorized table lookup for
ASCII (every byte its own grapheme — reference src/grapheme.rs:76-125).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class DenseAutomaton:
    """Flat array form of a compiled engine, shared by all device kernels."""

    __slots__ = (
        "num_nodes",
        "num_classes",
        "char_class",
        "ascii_class",
        "goto",
        "edge_target",
        "edge_class",
        "max_degree",
        "out_start",
        "out_count",
        "out_patterns",
        "out_list",
        "max_out",
        "prune_len",
        "prune_len_over_weight",
        "pat_len",
        "pat_weight",
        "sim",
        "max_depth",
        "max_pattern_len",
        "case_insensitive",
        "ascii_class_u8",
        "sb_edge",
        "has_multibyte_edges",
    )

    @classmethod
    def from_engine(cls, engine) -> "DenseAutomaton":
        self = cls()
        nodes = engine.nodes
        patterns = engine._patterns
        n = len(nodes)
        self.num_nodes = n
        self.case_insensitive = engine.case_insensitive

        # --- char classes. Edge first-chars each get their own class (they
        # are the only chars the kernels ever use as a *pattern-side* symbol:
        # transitions and substitution rows index by them). Every other
        # representable hay char — ASCII bytes plus both sides of the
        # similarity map — is grouped by its similarity COLUMN against the
        # edge chars: chars with equal columns are indistinguishable to every
        # kernel (no transition matches them, substitution costs agree), so
        # they share a class. All-zero columns collapse into class 0.
        char_class: dict[str, int] = {}
        class_repr: list[str] = [""]  # class id -> representative char
        edge_char_list: list[str] = []  # the true pattern-side symbols
        for node in nodes:
            for first_char, _t, _s in node.edges:
                if first_char not in char_class:
                    char_class[first_char] = len(class_repr)
                    class_repr.append(first_char)
                    edge_char_list.append(first_char)
        # Mapping haystack-side chars need their OWN classes: the mapped DP
        # lane (ops/verify_dp MappedSpec) tests haystack symbols for exact
        # char identity against a mapping's haystack graphemes
        # (reference src/search.rs:895-903), which class equality only
        # provides when the char is never merged into a similarity group.
        # Multi-char mapping graphemes are excluded (the mapped lane's
        # haystack gate makes them unmatchable).
        for mts in engine.mappings.values():
            for mt in mts:
                for g in mt.haystack:
                    if len(g) == 1 and g not in char_class:
                        char_class[g] = len(class_repr)
                        class_repr.append(g)

        sim_get = engine.similarity.get
        universe: list[str] = [chr(b) for b in range(128)]
        seen_u = set(universe)
        for (a, b) in engine.similarity.map.keys():
            for ch in (a, b):
                if ch not in seen_u:
                    universe.append(ch)
                    seen_u.add(ch)
        col_groups: dict[tuple, int] = {}
        for ch in universe:
            if ch in char_class:
                continue
            col = tuple(np.float32(sim_get(p, ch)) for p in edge_char_list)
            if not any(col):
                continue  # class 0
            cid = col_groups.get(col)
            if cid is None:
                cid = len(class_repr)
                col_groups[col] = cid
                class_repr.append(ch)
            char_class[ch] = cid
        self.char_class = char_class
        C = len(class_repr)
        self.num_classes = C

        # ASCII transcode table: byte -> class, with case folding baked in.
        ascii_class = np.zeros(256, dtype=np.int32)
        for byte in range(128):
            ch = chr(byte)
            folded = ch.lower() if engine.case_insensitive else ch
            ascii_class[byte] = char_class.get(folded, 0)
        self.ascii_class = ascii_class
        self.ascii_class_u8 = ascii_class.astype(np.uint8) if C <= 256 else None

        # --- similarity matrix over classes (diagonal 1.0, reference
        # src/structs.rs:82-92 via src/search.rs:76-82). Rows are only ever
        # indexed by edge-char classes (the pattern side); group-class rows
        # use the representative (harmless, never read).
        sim = np.zeros((C, C), dtype=np.float32)
        for i in range(1, C):
            for j in range(1, C):
                if i == j:
                    sim[i, j] = 1.0
                else:
                    sim[i, j] = engine.similarity.get(class_repr[i], class_repr[j])
        sim[0, 0] = 1.0
        self.sim = sim

        # --- goto + edge arrays.
        max_deg = max((len(node.edges) for node in nodes), default=0)
        self.max_degree = max_deg
        goto = np.full((n, C), -1, dtype=np.int32)
        edge_target = np.full((n, max_deg), -1, dtype=np.int32)
        edge_class = np.zeros((n, max_deg), dtype=np.int32)
        for i, node in enumerate(nodes):
            for d, (first_char, target, _single) in enumerate(node.edges):
                cid = char_class[first_char]
                if goto[i, cid] == -1:
                    goto[i, cid] = target  # first edge in order wins
                edge_target[i, d] = target
                edge_class[i, d] = cid
        self.goto = goto
        self.edge_target = edge_target
        self.edge_class = edge_class

        # --- single-byte-edge table for the last-edit dead-end filters.
        # The reference's ``has_matching_edge_char`` (src/structs.rs:471-476)
        # credits ONLY single-ASCII-byte edges — a multi-byte edge that WOULD
        # advance does not rescue the state, which changes results for
        # Unicode patterns (e.g. one-edit 'éllo' never matches 'héllo' in
        # the reference). Bug-for-bug parity requires the kernels to filter
        # with this table, not ``goto`` (src/search.rs:839-847, 1005-1007,
        # 1050-1063).
        sb_edge = np.zeros((n, C), dtype=np.int8)
        has_mb = False
        for i, node in enumerate(nodes):
            for first_char, _t, single in node.edges:
                if single:
                    sb_edge[i, char_class[first_char]] = 1
                else:
                    has_mb = True
        self.sb_edge = sb_edge
        self.has_multibyte_edges = has_mb

        # --- outputs (CSR + fixed-width padded list).
        out_start = np.zeros(n + 1, dtype=np.int32)
        flat: list[int] = []
        for i, node in enumerate(nodes):
            out_start[i] = len(flat)
            flat.extend(node.output)
        out_start[n] = len(flat)
        self.out_start = out_start
        self.out_patterns = np.asarray(flat, dtype=np.int32) if flat else np.zeros(0, np.int32)
        self.out_count = (out_start[1:] - out_start[:-1]).astype(np.int32)
        max_out = int(self.out_count.max()) if n else 0
        self.max_out = max(max_out, 1)
        out_list = np.full((n, self.max_out), -1, dtype=np.int32)
        for i, node in enumerate(nodes):
            for k, p in enumerate(node.output):
                out_list[i, k] = p
        self.out_list = out_list

        # --- prune coefficients + pattern scalars.
        self.prune_len = engine.prune_len_arr
        self.prune_len_over_weight = engine.prune_len_over_weight_arr
        self.pat_len = np.asarray([p.grapheme_len for p in patterns], dtype=np.float32)
        self.pat_weight = np.asarray([p.weight for p in patterns], dtype=np.float32)

        self.max_depth = max((node.depth for node in nodes), default=0)
        self.max_pattern_len = max((p.grapheme_len for p in patterns), default=0)
        return self

    # ------------------------------------------------------------------
    def transcode_ascii(self, haystack: str, data: bytes = None) -> np.ndarray:
        """All-ASCII haystack -> class-id stream (native C loop when built,
        NumPy otherwise); uint8 when the alphabet fits, else int32.
        ``data``: pre-encoded bytes, skips the encode copy."""
        from ..utils import native

        if data is None:
            data = haystack.encode("ascii")
        if self.ascii_class_u8 is not None:
            return native.transcode_bytes_u8(data, self.ascii_class_u8)
        return native.transcode_bytes_i32(data, self.ascii_class)

    def transcode(self, haystack: str, view=None) -> Optional[np.ndarray]:
        """Haystack -> class-id stream, or None if not transcodable (device
        paths currently require per-grapheme first-char classes).

        For non-ASCII haystacks the folded first char of each grapheme maps to
        its class (class 0 = unknown), mirroring the oracle's ``text_chars``
        cache (reference src/search.rs:203).
        """
        if haystack.isascii():
            # A view with cached bytes (streaming superwindows seed it)
            # saves the 48 MiB-scale re-encode.
            data = getattr(view, "_bytes", None) if view is not None else None
            return self.transcode_ascii(haystack, data)
        from ..utils.graphemes import HaystackView, map_singleton_chars

        if view is None:
            view = HaystackView(haystack, self.case_insensitive)
        fast = map_singleton_chars(
            view, self.char_class,
            dtype=np.uint8 if self.num_classes <= 256 else np.int32,
        )
        if fast is not None:
            return fast
        get = self.char_class.get
        return np.asarray([get(c, 0) for c in view.chars()], dtype=np.int32)
