"""Checkpointing: save/load a compiled automaton (a copy of the JAX
package's ``serialize``, in its ``.npz`` format byte for byte).

The reference has no persistence — the automaton is rebuilt from patterns.
Here the compiled trie (nodes, edges, failure links, weights, prune
coefficients, outputs, mapping transitions) plus the full configuration
serializes to a single ``.npz``, so large pattern sets compile once and load
everywhere without re-running the builder. The format carries no device
state: an engine saved by the JAX package loads here (and the other way
round) and searches the same; the loaded engine builds its kernel tables on
the torch device it is given.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from .builder import MappingTransition, Node
from .structs import FuzzyLimits, FuzzyPenalties, Pattern, Similarity, f32

_FORMAT_VERSION = 1


def _limits_to_json(lim: Optional[FuzzyLimits]):
    if lim is None:
        return None
    return {
        "insertions": lim.insertions_,
        "deletions": lim.deletions_,
        "substitutions": lim.substitutions_,
        "swaps": lim.swaps_,
        "edits": lim.edits_,
    }


def _limits_from_json(d) -> Optional[FuzzyLimits]:
    if d is None:
        return None
    return FuzzyLimits(
        insertions_=d["insertions"],
        deletions_=d["deletions"],
        substitutions_=d["substitutions"],
        swaps_=d["swaps"],
        edits_=d["edits"],
    )


def save(engine, path: str) -> None:
    """Serialize a compiled engine to ``path`` (.npz)."""
    nodes = engine.nodes
    n = len(nodes)

    # Grapheme string table shared by edges and mapping haystacks.
    strings: dict[str, int] = {}

    def sid(s: str) -> int:
        i = strings.get(s)
        if i is None:
            i = len(strings)
            strings[s] = i
        return i

    edge_src, edge_g, edge_dst = [], [], []
    for i, node in enumerate(nodes):
        for g, dst in node.transitions.items():
            edge_src.append(i)
            edge_g.append(sid(g))
            edge_dst.append(dst)

    out_start = np.zeros(n + 1, dtype=np.int64)
    out_flat: list[int] = []
    for i, node in enumerate(nodes):
        out_start[i] = len(out_flat)
        out_flat.extend(node.output)
    out_start[n] = len(out_flat)

    map_entries = []
    for src, mts in engine.mappings.items():
        for mt in mts:
            map_entries.append(
                {"src": src, "next": mt.next, "penalty": float(mt.penalty),
                 "hay": [sid(g) for g in mt.haystack]}
            )

    config = {
        "version": _FORMAT_VERSION,
        "patterns": [
            {
                "pattern": p.pattern,
                "grapheme_len": p.grapheme_len,
                "weight": float(p.weight),
                "limits": _limits_to_json(p.limits),
                "custom_unique_id": p.custom_unique_id,
            }
            for p in engine._patterns
        ],
        "limits": _limits_to_json(engine.limits),
        "penalties": {
            "substitution": float(engine.penalties.substitution),
            "insertion": float(engine.penalties.insertion),
            "deletion": float(engine.penalties.deletion),
            "swap": float(engine.penalties.swap),
        },
        "case_insensitive": engine.case_insensitive,
        "has_pattern_limits": engine.has_pattern_limits,
        "max_edits_fast": engine.max_edits_fast,
        "beam_width": engine.beam_width,
        "auto_beam": list(engine.auto_beam) if engine.auto_beam else None,
        "min_symbol_similarity": float(engine.min_symbol_similarity),
        "similarity_map": [[a, b, float(v)] for (a, b), v in engine.similarity.map.items()],
        "strings": sorted(strings, key=strings.get),
        "mappings": map_entries,
        "node_pattern_index": [node.pattern_index for node in nodes],
    }

    np.savez_compressed(
        path,
        config=np.frombuffer(json.dumps(config).encode("utf-8"), dtype=np.uint8),
        fail=np.asarray([node.fail for node in nodes], dtype=np.int64),
        depth=np.asarray([node.depth for node in nodes], dtype=np.int64),
        weight=np.asarray([node.weight for node in nodes], dtype=np.float32),
        prune_len=np.asarray([node.prune_len for node in nodes], dtype=np.float32),
        prune_len_over_weight=np.asarray(
            [node.prune_len_over_weight for node in nodes], dtype=np.float32
        ),
        edge_src=np.asarray(edge_src, dtype=np.int64),
        edge_g=np.asarray(edge_g, dtype=np.int64),
        edge_dst=np.asarray(edge_dst, dtype=np.int64),
        out_start=out_start,
        out_flat=np.asarray(out_flat, dtype=np.int64),
    )


def load(path: str, device="cuda"):
    """Load a compiled engine saved by :func:`save` (by either package); its
    device tables live on ``device`` (``cuda`` unless the caller asks for
    the CPU, as for a built engine)."""
    from .automaton import FuzzyAhoCorasick

    z = np.load(path)
    config = json.loads(bytes(z["config"]).decode("utf-8"))
    if config["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {config['version']}")
    strings = config["strings"]

    n = len(z["fail"])
    nodes = [Node(depth=int(d)) for d in z["depth"]]
    for node, fail, weight, pl, plw, pi in zip(
        nodes, z["fail"], z["weight"], z["prune_len"],
        z["prune_len_over_weight"], config["node_pattern_index"],
    ):
        node.fail = int(fail)
        node.weight = f32(weight)
        node.prune_len = f32(pl)
        node.prune_len_over_weight = f32(plw)
        node.pattern_index = pi

    for src, g, dst in zip(z["edge_src"], z["edge_g"], z["edge_dst"]):
        grapheme = strings[int(g)]
        nodes[int(src)].transitions[grapheme] = int(dst)
    for node in nodes:
        node.edges = [
            (g[0] if g else "\0", nxt, len(g.encode("utf-8")) == 1)
            for g, nxt in node.transitions.items()
        ]

    out_start, out_flat = z["out_start"], z["out_flat"]
    for i in range(n):
        nodes[i].output = [int(p) for p in out_flat[out_start[i] : out_start[i + 1]]]

    patterns = []
    for p in config["patterns"]:
        patterns.append(
            Pattern(
                pattern=p["pattern"],
                grapheme_len=p["grapheme_len"],
                weight=f32(p["weight"]),
                limits=_limits_from_json(p["limits"]),
                custom_unique_id=p["custom_unique_id"],
            )
        )

    mappings: dict[int, list[MappingTransition]] = {}
    for e in config["mappings"]:
        mappings.setdefault(e["src"], []).append(
            MappingTransition(
                tuple(strings[i] for i in e["hay"]), e["next"], f32(e["penalty"])
            )
        )

    pen = config["penalties"]
    engine = FuzzyAhoCorasick(
        nodes=nodes,
        patterns=patterns,
        similarity=Similarity({(a, b): v for a, b, v in config["similarity_map"]}),
        limits=_limits_from_json(config["limits"]),
        penalties=FuzzyPenalties(
            substitution=f32(pen["substitution"]),
            insertion=f32(pen["insertion"]),
            deletion=f32(pen["deletion"]),
            swap=f32(pen["swap"]),
        ),
        case_insensitive=config["case_insensitive"],
        has_pattern_limits=config["has_pattern_limits"],
        max_edits_fast=config["max_edits_fast"],
        mappings=mappings,
        beam_width=config["beam_width"],
        auto_beam=tuple(config["auto_beam"]) if config["auto_beam"] else None,
        min_symbol_similarity=f32(config["min_symbol_similarity"]),
    )
    engine.device = torch.device(device)
    return engine
