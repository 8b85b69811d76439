"""The comparison that decides ``correct``: a search's output against the
reference's match set, every match of it.

A match is held equal where its (pattern, start, end) is the reference's,
its similarity has the reference's float32 bits, and its edit counts are
one of the breakdowns that reach that similarity (at a tie the crate's
pick follows its queue's order; any of the tied breakdowns is the match).
Every number compared has the limit 0.
"""

from __future__ import annotations

import numpy as np

#: The numbers compared, each with its limit, in the order they print.
LIMITS = {"missing": 0, "extra": 0, "similarity_bits": 0, "edit_counts": 0,
          "searches_with_other_count": 0}


def output_rows(matches) -> list:
    """(pattern, start, end, similarity float32, (ins, dels, subs, swaps),
    edits) of each match a search returned."""
    return [(m.pattern_index, m.start, m.end, np.float32(m.similarity),
             (m.insertions, m.deletions, m.substitutions, m.swaps), m.edits) for m in matches]


def compare(rows, ref: dict) -> dict:
    """The counts of matches that differ, by kind."""
    seen = {}
    extra = 0
    bits = counts = 0
    for q, s, e, sim, bd, edits in rows:
        key = (q, s, e)
        if key in seen or key not in ref:
            extra += 1
            continue
        seen[key] = True
        want_sim, want_bds = ref[key]
        if np.float32(sim).tobytes() != np.float32(want_sim).tobytes():
            bits += 1
        elif bd not in want_bds or edits != sum(bd):
            counts += 1
    return {"missing": len(ref) - len(seen), "extra": extra, "similarity_bits": bits,
            "edit_counts": counts}


def tied(ref: dict) -> int:
    """Matches of the reference that more than one breakdown reaches."""
    return sum(len(v[1]) > 1 for v in ref.values())
