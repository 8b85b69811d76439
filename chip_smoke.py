#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card.

Drives the port's main paths (the exact lane, the four lanes of the DP
family, the large-dictionary lane and the beam frontier) once each at full
size, through the
entry points a user calls (build an engine, ``search_raw``; the streaming
search and replace, the prefilter, save / load and the small-haystack host
path above it), and checks every CUDA kernel they run against its plain
torch version. Phases:

1. card: ``nvidia-smi`` name and power limit, CUDA version, device name;
2. build: compile the nine sources of ``csrc/`` with nvcc (sm_90a, one
   process per source, in parallel) from the checkout; report build seconds
   and ptxas registers / spills;
3. kernel vs plain on the card, bit for bit. The hit-list scan's three
   kernels (``scan_bits``, ``block_offsets``, ``hit_words``): the headline
   dictionary's exact tables over a 4 MiB slice; k = 1 Damerau, k = 2 and
   k = 3 Damerau tables over planted 1- and 2-edit words, and over views
   that start 1 and 5 bytes off alignment; a text without hits; a text
   where every position hits; streams of 1, 15, 16, 17 and 33 symbols;
   words ending one before, on and one after the edges of the scan's blocks
   and chunks, at each chunk length. The DP-only kernel (``banded_dp``) on the candidates of the
   headline ``edits(1)`` and ``edits(2)`` engines and of a dictionary with
   multi-byte edges (the dead-end filter) over a Unicode corpus. The
   expansion + DP + emission kernel (``dp_pipeline``) on the same three, on
   int32 ids, on views 3 bytes off alignment, at a threshold that a
   similarity ties exactly (also checked against the oracle), on a text
   without hits and on one with a hit run at every word, each time with
   ``block_offsets`` held on the count pass's counts. The forbid, mapped
   and typed variants (``lane_kernel_checks``): ``banded_dp`` and
   the count-channel list step (``compare_step_kernels``: ``typed_expand``,
   ``count_dp``, ``count_emit``, each alone, and the whole step) with each
   forbid flag (``edits(1)`` (G = 8), ``edits(2)``, ``edits(3)`` (G = 32)
   and ``edits(4)`` (shared rows) without swaps; ``edits(2)`` without
   insertions, deletions, substitutions), on int32 ids, at a tied
   threshold, on a range with h0 = 1 and tags, and with mapping arrivals
   (rn <-> m on the headline dictionary + ``modern``; ß <-> ss and æ <-> ae,
   drift +1 and -1 in both directions; a scored mapping; ``edits(2)`` and
   ``edits(3)`` (G = 32) mapped; ``edits(4)``-``(6)`` mapped, the rows
   form with mapping arrivals behind scan budgets of 8-12 rows;
   ``edits(2)`` with sch <-> tsch, a 4-symbol side, k = 8, and ``edits(3)``
   with sch <-> sh, k = 9; and a mapped ``edits(4)`` search through
   ``search_raw`` on the card's lane, its launches counted, against the
   oracle), and for ``edits(2)``
   with swaps and a multi-byte-edge dictionary at ``edits(2)``;
   ``banded_dp_typed``
   and the typed step (``typed_expand``, ``typed_dp``, ``typed_emit``, each
   also alone) on ``substitutions(1)`` (2 channels),
   ``insertions(1).deletions(1)``, ``edits(2).substitutions(1)`` (14),
   ``edits(4).substitutions(1)`` (55) and a dictionary with three limits
   classes; the DP-only kernels on int32 ids too; a threshold that a typed
   match's similarity ties; the typed step on the second half of a hit list
   (a first hit h0 and the rows' tags); a text without hits per lane; the
   typed DP past 32 cells (``typed_rows_checks``): each of the 16
   instances of ``typed_dp_rows_kernel<E, S, G>`` (E = 2..6, 14-96
   channels), at 14, 55 and 96 channels on int32 ids too, a tied threshold,
   filler only, and the first 16 MiB of the corpus, whose candidate list is
   longer than any grid of resident groups; its ptxas registers and spills;
   ``block_offsets`` at 1, 2, 31, 1023-1025 counts, one tile (16,384) and
   one either side, 129,864 and 2^22 + 7 counts, all zeros, a total just
   under 2^31 and an unaligned view. The large-dictionary lane
   (``many_kernel_checks``): the wide scan's kernels (``scan_bits_wide``,
   ``hit_words_wide``, ``wide_kernel_checks``) on streams of 50,013 symbols
   at k = 0 at every edge of the k = 0 instance table (W = 9, 16, 17, 24, 25,
   31, 32, 33, 40, 41, 43, 48, 49, 56, 57, 64) at alphabets of 27 and 128
   symbols, the library's instance table against ``wide_scan_instance``,
   and at k = 1 and 2 with and without the Damerau
   rows, 4 with and 6 without at W = 9, 31, 32, 64; a stream whose first
   tile holds over 300 hits (k = 0 and k = 1 Damerau) and one without a
   hit; per chunk of the folded and the plain layout, over 1 MiB of the
   many1k corpus, over 3-letter words (no containment test), over filler
   only (hits without candidates) and with 300 many1k words at
   ``edits(2)``, the chunk step ``many_step`` (expansion, DP and emission in
   one kernel) with and without the containment test and the whole chunk
   (``many_pipeline``), and on the first chunk the step on a range handed
   its preceding hit (h0 = 1) and the chunk in 3 ranges. The wide
   kernels past six rows (``deep_kernel_checks``): the library's instance
   table at W = 1..64, k = 7..24; the scan and the replay at k = 7, 8, 12,
   13 and 24 and W = 1, 8, 9, 31 and 64, with and without the Damerau rows,
   at W = 2 and 4, at W = 33 (two limbs a lane) with k = 13 and 24, on
   2^18-symbol streams at W = 33, k = 24 and W = 64, k = 17, on a stream
   without a hit and on segments
   with halos; ``fuzzy_anchors_packed`` at a budget of 8 rows against the
   same call on the CPU, resident and in segments. Mapped4's text and
   plain-scan windows are made here, and the oracle's searches over them
   begun (``mapped4_start``);
4. exact main path: the headline 16-word case-insensitive dictionary
   searched exact (threshold 0.5) over a 96 MiB seeded corpus, two warm-up
   searches then three timed ones, the plain versions locked out; the match
   set must equal an independent ``str.find`` count; the scan's three launch
   counters must be > 0; kernel launches, copies and host waits per search
   from torch.profiler;
4b. fuzzy main path: the same dictionary with ``edits(1)`` at threshold 0.8
   over the same corpus, timed the same way; the plain versions are locked
   out during the run, the scan's and the pipeline's launch counters must be
   > 0 and the other DP kernels' 0; the match set must equal an independent
   one built by the port's oracle over each distinct word context (no scan,
   no DP, no slicing; the contexts are found once per corpus and searched
   by one pool of worker processes kept for the run, which works through
   the engines' contexts during phases 3 and 5 and is idle before the
   first timed search); launches, copies and
   waits per search, with the wrapper's launch count beside the profiler's
   event count; the stages' host-clock times;
4c, 4c', 4d, 4d', 4e. the forbid lane, the default ``edits(2)``, the typed
   lane twice and the mapped lane at full width
   (``lane_main_path``), each through ``search_raw`` over the 96 MiB corpus
   after a probe on 1 MiB through the same entry point with the oracle
   locked out (the engine's own routing picks the lane), two warm-ups and three timed searches with the
   plain versions and the oracle locked out: 4c the headline dictionary
   with ``edits(2).swaps(0)`` at 0.62; 4c' ``edits(2)`` with swaps at 0.62
   (fuzzy2_default, ``bench.py:347-384``); 4d the same with ``edits(1)``, one
   pattern exact-only and one ``substitutions(1)`` only, at 0.8; 4d' (typed14)
   the headline dictionary with ``edits(2).substitutions(1)`` at 0.62 (5
   bands x 14 type vectors: the typed DP past 32 cells); 4e the
   dictionary + ``modern`` with the mapping rn <-> m and ``edits(1)`` at
   0.8, every 50th ``commodo`` of the corpus a ``modem``. Each must report
   its lane's backend name, launch the scan's kernels and its own step's
   kernels and no other lane's (4c, 4c' and 4e the list step:
   ``typed_expand``, ``count_dp``, ``count_emit``; 4d and 4d' the typed
   step: ``typed_expand``, ``typed_dp``, ``typed_emit``; both with
   ``block_offsets`` only for the scan's counts: the emission places its
   rows from the DP's channel totals;
   never ``dp_pipeline_kernel``), and equal the context oracle's match set; a
   lane that declined at 96 MiB would run at the largest power-of-two
   prefix it serves and say so;
4e''. mapped4: 16 two-word names (``MAPPED4_WORDS``), rn <-> m,
   ``edits(4)`` at 0.8 (a scan budget of 8 rows: the wide kernels' deep
   instances and ``count_dp_rows_kernel`` with mapping arrivals) over the
   corpus with 4,000 copies planted, each with 1-4 edits, every m of every
   second one written rn; timed as 4c-4e; its set equal to the oracle's
   over every merged window around a planted copy or a hit of the plain
   scan, and over the first 32 KiB in whole, as (pattern, start, end,
   similarity bits), the matches whose tied paths carry other edit counts
   counted;
4f. the large-dictionary lane, many1k (``bench.py:187-229``: 1,000 random
   words, ``edits(1)``, 0.82, the first 24 MiB of the corpus with 4,000
   planted typos), through ``search_raw`` with the folded layout and then
   with the plain chunking (the lane's fold switch off), each timed as 4c-4e
   with the plain versions and the oracle locked out, launching the wide
   scan, ``block_offsets``, ``hit_words_wide`` and ``many_step`` and no other
   kernel, and equal to the context oracle (one oracle search per distinct
   word context of the 24 MiB, begun in phase 3); launches, copies and waits
   per search, the stages, and per chunk its hits, pairs, candidates and
   rows;
4g. exact-wide: the first 300 many1k words built exact (case-insensitive,
   threshold 0.5) over the 24 MiB many1k corpus with 4,000 exact copies of
   them planted: the wide packed scan at k = 0 (W between 9 and 64 limbs;
   the JAX package walks such a dictionary), timed as 4c-4e, launching
   ``scan_bits_wide``, ``block_offsets`` and ``hit_words_wide`` and no other
   kernel, equal to an independent overlapping ``str.find`` set and to the
   oracle on 32 KiB with 300 planted words;
4h. exact1k: all 1,000 words, exact, over the same corpus: past 64 limbs,
   so the goto walk serves it, launching ``goto_walk`` (count and emit
   passes) and ``block_offsets`` and no other kernel; checked as 4g; then
   the walk's kernels against their plain version, arrivals and alive
   counts bit for bit, on exact1k's corpus and table (and on all but its
   last 1,000 starts: a persistent block's last tile ends mid-tile), on a
   dictionary past 256 classes (int32 ids: CJK words over 1 Mi characters
   of the cjk1 corpus), on the unmasked table of the seed filter's exact
   pass (``exact_scan_hits``), on tiles of exactly ``exact.WALK_KEEP``
   and ``WALK_KEEP + 1`` arrivals (``exact.keep_edge_text``: the write
   pass copies the first tile's kept rows and walks the second again) and
   on walks of 300 and 1,100 symbols; then a
   70-character pattern (past the packed
   lane's 64) over 1 MiB with 64 planted runs of 70-80 a's against
   ``str.find``;
4i. the entry points above ``search_raw`` (``stream_replace_cell``,
   ``joined_stream_cell``, ``small_entry_points``), each with the plain
   versions and the oracle locked out and the launch counters set to 0 just
   before it and read just after: (a) ``replace_stream_parallel`` with the
   bench's recipe (``bench.py:390-440``: 64 shards, a table of 16
   ``"<x>"``) on the ``edits(1)`` engine at 0.8 over the 96 MiB corpus, two
   warm passes, best of 3 in MB/s, one ``FAC_TIME=1`` pass for the wait /
   post / emit split, its bytes equal to ``FuzzyReplacer.replace`` over the
   whole resident corpus and to ``replace_stream``; (b) the same for the
   exact engine at 0.5; (c) ``search_stream_parallel`` (64 shards) of the
   ``edits(1)`` engine over the corpus, a space and the corpus (past
   ``RESIDENT_MAX``, so no single ``search_raw`` takes it): every match in
   the context oracle's raw set over that text (the 96 MiB corpus's
   per-context results reused, the oracle run here on the contexts around
   the join) and the stream equal to that set resolved window by window,
   in windows cut by the stream rule itself (``window_geometry``, not the
   port's ``WindowReader``), with the device bytes the corpus cache holds
   after it; (d) ``with_prefilter().search`` equal to ``search`` on 1 MiB
   (device lane), ``save`` / ``load(device="cuda")`` of the ``edits(1)``
   and many1k engines, each loaded engine equal on 1 MiB, and
   ``search_basic`` (``bench.py:135-150``: 300 calls on a 39-character
   haystack, microseconds per call) on the native host BFS, equal to the
   oracle; (e) ``stream_kernel_checks``: each kernel of those paths held
   against its plain version on the inputs they hand it, captured from one
   more run of each stream: every DP slice of every superwindow of (a) and
   (c) (the short last slices too), the exact scan of each superwindow of
   (b), and the 1 MiB of (d) (its many1k engine searches the 1 MiB of
   phase 3's many lane checks);
4j. the beam-frontier lanes (``beam_cell``), through ``search_raw``, the
   plain versions locked out (and the oracle, but in (c), whose starts may
   overflow), the launch counters set to 0 just before and read just after,
   each a first search and best of 3, then its stages alone
   (``beam_stage_profile``: the candidate starts, the frontier with the
   kernels' counts of expanded states and rounds, the whole search
   profiled; each search must launch its lane's frontier kernel) with launches,
   copies, host waits and the device's busy share: (a) the ``edits(1)``
   engine over phase 4i (c)'s joined text (past ``RESIDENT_MAX``: the
   packed anchors in ``STREAM_CHUNK`` segments, the E = 1 pool), equal to
   the context oracle's 85,332 raw matches; (b) ``cjk1`` (60 CJK words of
   4 characters, more than 127 prefilter symbols: the seed filter, the pool)
   and (c) ``cjk2`` (40 words of 5-8 characters, ``edits(2)`` at 0.7: the
   sorted beam), each over 24 MiB of CJK filler with planted words
   (``cjk_corpus``), equal to the oracle over each distinct word context
   (``cjk_contexts``, by characters; positions in bytes); (d) ``a`` x 70
   and ``hello`` over the many1k corpus with 64 runs of 69-72 a's, equal to
   the word-context oracle for ``hello`` and to the oracle around each
   a-run for the long pattern (``arun_oracle_set``); (e)
   ``beam_kernel_checks``: ``scan_bits``, ``block_offsets`` and
   ``hit_words`` against their plain versions on (a)'s anchor segments and
   (d)'s seed pass; ``frontier_kernel_check``: the frontier's kernels
   (``beam_pool_kernel`` (a), (b), (d), ``beam_sorted_kernel`` (c), and
   ``beam_order_kernel`` after either, ``csrc/beam.cu``) against their
   plain versions on the card over each cell's first run of chunks, bit for
   bit, timed; and ``frontier_shape_checks``: the kernels on twelve small
   shapes, each required to reach its branch (``FRONTIER_SHAPE_NEEDS``:
   overflowing starts, rounds past the register sort, the tables on chip and
   in global memory for both kernels, each kernel's global scratch, int32
   ids, a run with no emission and so no write launch, a run in which every
   start emits, the order kernel's histograms in global memory), bit for
   bit; ptxas's registers of every frontier kernel, none spilling;
4k. the sharded lanes and the multi-host entry points (``parallel/``),
   the plain versions and the oracle locked out, the launch counters set
   to 0 just before each search and read just after: (a)
   ``sharded_exact_search`` (the goto walk's kernels per shard) and
   ``sharded_fuzzy_search`` of the exact, fuzzy1, forbid, typed, mapped
   and mapped4 engines over their phase 4-4e'' texts (mapped4 launching
   the deep scan instances; the forbid and mapped ones the list step and no
   ``dp_pipeline_kernel``), on 3 logical shards of the card (``[cuda:0] * 3``) and on
   ``default_mesh()`` (every card), a first search and best of 3, each
   equal to the engine's ``search_raw`` tuple for tuple (14,222 / 42,666 /
   116,171 / 23,648 / 62,956 matches), the profiler's launches, copies,
   waits and busy share on the 3 shards, and the host's transcode of the two
   symbol streams alone; (b) ``dryrun_multichip`` over every card and over
   3 logical shards; (c) ``replace_multihost`` to the bench's recipe
   (``bench.py:552-566``: 24 MiB, fuzzy1 at 0.8, the first 8 dictionary
   words upper-cased) with 2 logical hosts in this process, best of 3 in
   MB/s, equal to ``replace_stream``, and once more with each host's slice
   on 3 logical shards; (d) two processes under ``initialize`` (gloo, both
   on ``cuda:0``, the kernels built in phase 2 and loaded from the build
   directory), each running ``search_multihost`` and ``replace_multihost``
   over the same 24 MiB: the two ranks' lists identical and equal to the
   whole-input ``search_raw``, their segments in rank order equal to (c)'s
   bytes; a worker that fails or passes ``WORKER_TIMEOUT_S`` fails the
   phase and the other is killed; (e) ``scan_bits``, ``block_offsets``,
   ``hit_words``, ``dp_pipeline`` and the typed step against their plain
   versions on the extended buffers of the first and the last of (a)'s 3
   shards (zero left halo, zero right margin), captured from one more
   search of fuzzy1 and of the typed engine, and the goto walk's kernels on
   the first and the last shard of one more exact search (shard 0 walks
   fewer starts than it reads);
5. parity (run between phases 3 and 4, while the context oracle's workers
   are busy): device vs the port's oracle on 64 KiB (exact) and 32 KiB with
   planted edits (fuzzy, each of the three lanes, and a typed engine with
   14 channels, ``edits(2).substitutions(1)``); the exact streaming
   branch vs the resident one on 8 MiB; the sliced pipeline (1 MiB slices)
   vs unsliced on 8 MiB for the fuzzy and the forbid lane;
6. times: CUDA-event times of each kernel and of its plain version at the
   main paths' shapes (``block_offsets`` at the scan's and at the
   pipeline's; each lane's pipeline and DP-only kernel on slice 1 of its
   phase's search, where the scan's three kernels on the lane's own tables
   and ``block_offsets`` on every count array the step scans are held
   against their plain versions too; for the typed and typed14 lanes and
   the list step of the forbid, mapped and mapped4 lanes (with the DP
   instance's registers and spill bytes: typed14's
   ``typed_dp_rows_kernel<2, 1, 16>``, mapped4's ``count_dp_rows_kernel``
   with mapping arrivals), each of the step's kernels alone, and for those
   and fuzzy2 the emission (``count_emit_kernel``) at its grid's edges
   (``emit_edge_checks``: 1 candidate, a whole tile of 1,024, 1,025, all,
   and pairs without a row beside pairs with rows); the wide kernels'
   deep instances at mapped4's shape (``deep_times``: three timings,
   registers, spills, SASS); ``block_offsets`` beside ``torch.cumsum(..., dtype=torch.int32)``
   at every shape the searches hand it and at 129,864 and 2^22 + 7 counts),
   the bound worked out from those inputs alone (bytes
   over the card's memory rate against integer or float32 instructions over
   its instruction rate), their agreement there, and the scan at each chunk
   length it takes on streams around the lengths where the wrapper's pick
   switches; the large-dictionary lane's kernels at the folded many1k
   chunk over 24 MiB, every chunk of the folded and the plain layout there
   held against its plain version (the step with the containment test on
   and off, and the folded chunk in hit ranges), and the step's count and
   write passes' device times from the profiler;
   the wide scan's kernels at k = 0 at exact-wide's shape against their
   plain versions; at both wide shapes (``wide_kernel_detail``) each wide
   kernel timed three ways (CUDA events around 10 back-to-back calls,
   around one call after a synchronise, the profiler's device ms per
   launch), its registers, the scan's instance (LPL, G, padded width) and
   the SASS of its main loop per symbol (``cuobjdump -sass``); the goto
   walk at exact1k's shape (``walk_times``: the kernel pair, its plain
   version and ``torch.gather`` of the root row, each kernel's device ms
   and the launches, copies and waits per walk from the profiler, the
   arrivals per tile; ``exact1k_host_split``: the search's wall split into
   the tally read, ``found.cpu()``, ``_emit`` and the rest; the kernels'
   variants are ``tools/walk_variants.py``'s); slice
   1's hit list of the fuzzy and the typed lane run
   by the pipeline kernels in 3 ranges (each handed its preceding hit, the
   rows put back in one range's order by their tags) against one range,
   each range's kernel call against its plain version, rows and tags bit for
   bit, and the decoded matches.

Any failed phase raises, so the script exits non-zero. Before the last line
it prints one JSON line of kernel results (a kernel's device ms per search
is the profile's sum, or, where the profile dropped events of it, the mean
event times the launches counted: ``search_ms``) and the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``. Run from the
repository root:

    python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "fuzzy_aho_corasick_tpu_torch"

HEADLINE = [
    "tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
    "ullamcorper", "pellentesque", "sagittis", "condimentum", "habitasse",
    "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
    "parturient",
]
FILLER = [
    "lorem", "ipsum", "dolor", "sit", "amet", "consectetur", "adipiscing",
    "elit", "vestibulum", "eros", "commodo", "accumsan", "porta", "orci",
]
NEEDLES = ["tincidunt", "phaetra", "sollicitudin"]
CORPUS_BYTES = 96 << 20
SEED = 42
#: A dictionary with multi-byte trie edges (the DP's dead-end filter) and
#: the words of its Unicode corpus.
UNICODE_WORDS = ["привет", "москва", "ирина", "тест", "café", "naïve", "straße"]
UNICODE_FILLER = ["и", "мы", "тесты", "кафе", "она", "дом", "cafe", "weiter", "über"]
#: Characters a word context carries past its word's trailing space: with
#: E = 2 a match spans at most Lmax + E = 14 characters.
CONTEXT_TAIL = 15
#: The engines of phases 4c, 4d, 4e, as ``recipe_engine`` names them.
LANES = ("forbid", "typed", "mapped")
#: The launch counters of the typed step's kernels.
TYPED_KEYS = ("typed_expand", "typed_dp", "typed_emit")
#: The kernel a launch counter counts where its name is not the counter's:
#: the typed step's emission is the list step's kernel.
KERNEL_OF = {"typed_emit": "count_emit_kernel"}
#: The launch counters of the count-channel list step's kernels (E >= 2,
#: forbidden edit types or mappings): the typed step's expansion, then
#: ``count_dp`` and ``count_emit`` (``csrc/dp_list.cu``).
LIST_KEYS = ("typed_expand", "count_dp", "count_emit")
#: The launch counters of the scan past six error rows (the wide kernels'
#: deep instances, at every W).
DEEP_SCAN_KEYS = ("scan_bits_wide", "block_offsets", "hit_words_wide")
#: The many1k configuration (``bench.py:187-229``): 1,000 random lowercase
#: words of 6-11 letters drawn from seed 7, ``edits(1)``, case-insensitive,
#: threshold 0.82, over the first 24 MiB of the corpus with 4,000 planted
#: one-substitution typos of its words of 9 or more letters.
MANY_THRESHOLD = 0.82
MANY_BYTES = 24 << 20
MANY_TYPOS = 4000
#: Phase 4j's beam-lane engines (``recipe_engine`` names) and texts. CJK
#: dictionaries from U+4E00 + 0..299: ``cjk1`` the 60 words of 4 characters
#: drawn from seed 1 (``edits(1)``, 0.8: more than 127 prefilter symbols, so
#: the seed filter and the E = 1 pool); ``cjk2`` 40 words of 5-8 characters
#: from seed 2 whose first characters are 24 (U+4E00 + 300..323), so the
#: root's 24 edges leave the E = 2 beam room at the first round
#: (``edits(2)``, 0.7: the sorted beam); ``long`` a 70-character pattern and
#: ``hello`` (``edits(1)``, 0.8: past the prefilter's 63 graphemes). The
#: CJK corpora are 24 MiB of space-joined filler words of a disjoint range
#: (U+4E00 + 1000..1999, 24 words of ``CJK_FILLER_LEN`` characters) with a
#: dictionary word planted at 1 in ``CJK_PLANT`` words, a third of them with
#: one substitution. A match of cjk1 spans at most 5 characters, of cjk2 10:
#: the tails of their word contexts.
CJK_PLANT = 200
CJK_FILLER_LEN = {"cjk1": (3, 6), "cjk2": (5, 9)}
CJK_TAIL = {"cjk1": 5, "cjk2": 10}
BEAM_THRESHOLD = {"cjk1": 0.8, "cjk2": 0.7, "long": 0.8}
LONG_WORDS = ["a" * 70, "hello"]


def log(msg: str) -> None:
    print(msg, flush=True)


def build_corpus(size: int, seed: int) -> str:
    """The headline corpus recipe: filler words with one of three needles
    at 1 in 997, space-joined, drawn vectorised from a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = FILLER + NEEDLES
    mean = sum(len(w) + 1 for w in FILLER) / len(FILLER)
    count = int(size / mean * 1.02) + 1024
    idx = rng.integers(len(FILLER), size=count)
    needle = rng.integers(997, size=count) == 0
    idx[needle] = len(FILLER) + rng.integers(len(NEEDLES), size=int(needle.sum()))
    lens = np.array([len(w) + 1 for w in vocab])[idx]
    keep = int(np.searchsorted(np.cumsum(lens), size)) + 2
    return " ".join([vocab[i] for i in idx[:keep].tolist()])[:size]


def edit(w: str, rng) -> str:
    """One substitution, deletion, insertion or adjacent swap inside ``w``."""
    i, op = int(rng.integers(1, len(w) - 2)), int(rng.integers(4))
    return [w[:i] + "x" + w[i + 1:], w[:i] + w[i + 1:], w[:i] + "q" + w[i:],
            w[:i] + w[i + 1] + w[i] + w[i + 2:]][op]


def plant(text: str, seed: int, count: int, edits=(1, 2)) -> str:
    """``text`` (ASCII) with ``count`` headline words planted, each with a
    number of edits drawn from ``edits``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    buf = bytearray(text.encode())
    for at in rng.integers(0, len(buf) - 32, size=count).tolist():
        w = HEADLINE[int(rng.integers(len(HEADLINE)))]
        for _ in range(int(rng.integers(edits[0], edits[1] + 1))):
            w = edit(w, rng)
        buf[at:at + len(w)] = w.encode()
    return buf.decode()


def unicode_corpus(words: int, seed: int) -> str:
    """Unicode filler with ``UNICODE_WORDS`` at 1 in 4, half of them with one
    edit; mixed case."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(words):
        if rng.integers(4) == 0:
            w = UNICODE_WORDS[int(rng.integers(len(UNICODE_WORDS)))]
            w = edit(w, rng) if rng.integers(2) else w
        else:
            w = UNICODE_FILLER[int(rng.integers(len(UNICODE_FILLER)))]
        out.append(w.upper() if rng.integers(5) == 0 else w)
    return " ".join(out)


def fuzzy_tables(tpb, words, k, damerau, device):
    """k >= 1 tables for ``words`` from the numpy mask helpers, plus the
    byte -> symbol table (case-folded). Returns (tables, lut, halo)."""
    import numpy as np

    alphabet = sorted(set("".join(words)))
    sym = {c: i + 1 for i, c in enumerate(alphabet)}
    A = len(alphabet) + 1
    ms = [len(w) for w in words]
    offs = tpb._pack_fields(ms)
    W = max(lw for lw, _ in offs) + 1
    limb = np.zeros((A, W), np.uint64)
    for w, (lw, lo) in zip(words, offs):
        for i, c in enumerate(w):
            limb[sym[c], lw] |= np.uint64(1) << np.uint64(lo + i)
    match, init, kk = tpb.fuzzy_masks(offs, ms, W, [k] * len(words))
    notlast = tpb.notlast_mask(offs, ms, W) if damerau else None
    T = tpb.tables_from_numpy(tpb._word_table(limb, A, W), tpb._starts_mask(offs, W),
                              match, init, notlast, device=device)
    lut = np.zeros(256, np.uint8)
    for c, s in sym.items():
        lut[ord(c)] = lut[ord(c.upper())] = s
    return T, lut, max(ms) + kk


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare_scan(tpb, torch, ids, T, halo, what, want_hits=True, chunk=None):
    """The three kernels of the hit-list scan against their plain versions
    on ``ids``, bit for bit, each fed the plain version's inputs; ``chunk``
    as ``scan_bits`` takes it. Returns the hit count and the three
    max_abs_err (0 when equal)."""
    bits_k, counts_k = tpb.scan_bits(ids, T, halo, chunk)
    bits_p, counts_p = tpb.scan_bits_torch(ids, T, halo)
    offs_k = tpb.block_offsets(counts_p)
    offs_p = tpb.block_offsets_torch(counts_p)
    count = int(offs_p[-1])
    pos_k, words_k = tpb.hit_words(ids, bits_p, offs_p, count, T, halo)
    pos_p, words_p = tpb.hit_words_torch(ids, bits_p, offs_p, count, T, halo)
    torch.cuda.synchronize()
    diff = lambda x, y: int((x.long() - y.long()).abs().max()) if x.numel() else 0
    errs = (max(diff(bits_k, bits_p), diff(counts_k, counts_p)), diff(offs_k, offs_p),
            max(diff(pos_k, pos_p), diff(words_k, words_p)))
    log(f"  {what}: n={ids.numel()} hits={count} max_abs_err scan_bits={errs[0]} "
        f"block_offsets={errs[1]} hit_words={errs[2]}")
    require(bits_k.shape == bits_p.shape and pos_k.shape == pos_p.shape
            and words_k.shape == words_p.shape, f"{what}: shapes differ")
    require(errs == (0, 0, 0), f"{what}: a scan kernel disagrees with its plain version")
    require(count > 0 or not want_hits, f"{what}: no hits to compare")
    return count, errs


def offsets_edge_checks(tpb, torch, np, dev) -> int:
    """``block_offsets`` against its plain version at lengths around the
    kernel's warp, block and tile edges, at 129,864 counts and past 2^22,
    on all zeros, on counts whose total is
    just under 2^31 and on a view 4 bytes off alignment. Returns the
    max_abs_err."""
    tile = tpb.OFFSETS_TILE
    rng = np.random.default_rng(SEED + 17)
    cases = [(f"len {n}", torch.from_numpy(rng.integers(0, 100, n).astype(np.int32)).to(dev))
             for n in (1, 2, 31, 1023, 1024, 1025, tile - 1, tile, tile + 1, 129864,
                       (1 << 22) + 7)]
    cases.append(("all zeros, len 100,000", torch.zeros(100000, dtype=torch.int32, device=dev)))
    near = ((1 << 31) - 1) // 300007
    cases.append((f"total {near * 300007} (2^31 - {(1 << 31) - near * 300007})",
                  torch.full((300007,), near, dtype=torch.int32, device=dev)))
    cases.append(("unaligned view, len 50,000", cases[-3][1][1:50001]))
    err = 0
    for what, counts in cases:
        got, want = tpb.block_offsets(counts), tpb.block_offsets_torch(counts)
        e = int_err(got, want)
        log(f"  block_offsets {what}: total {int(want[-1])}, max_abs_err {e}")
        require(e == 0, f"block_offsets disagrees with its plain version at {what}")
        err = max(err, e)
    return err


def offsets_times(tpb, torch, counts, what: str, reps: int = 50) -> dict:
    """CUDA-event ms of ``block_offsets`` on ``counts`` beside its plain
    version and ``torch.cumsum(counts, 0, dtype=torch.int32)``, and the bound:
    each count read once and each offset written once, an add per count."""
    n = counts.numel()
    rec = {"what": what, "len": n,
           "ms": event_ms(torch, lambda: tpb.block_offsets(counts), reps),
           "plain_ms": event_ms(torch, lambda: tpb.block_offsets_torch(counts), reps),
           "library_ms": event_ms(torch, lambda: torch.cumsum(counts, 0, dtype=torch.int32), reps)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(8 * n + 4, n, INT_RATE)
    log(f"  block_offsets {what}, {n} counts: kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, torch.cumsum {rec['library_ms']:.4f} ms "
        f"({rec['library_ms'] / rec['ms']:.3f} x the kernel's time), bound "
        f"{rec['bound_ms']:.3g} ms by {rec['bound_by']}")
    return rec


def lane_inputs(vdp, engine, text: str, thr: float, what: str):
    """(plan, run) of the DP lane for ``text``: tables and slices on the card."""
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    view = view_of(text, engine.case_insensitive)
    specs = vdp.lane_specs_of(engine)
    plan = vdp.dp_plan(engine, thr, len(view), *specs)
    require(plan is not None, f"{what}: the DP lane declined")
    return plan, vdp.dp_inputs(engine, text, plan, view, len(view), *specs)


def variant_name(run) -> str:
    v = run.variant
    if v.typed is not None:
        return f"typed NCH={v.typed.nch} classes={v.typed.adm.shape[0]}"
    if v.maps is not None:
        return f"mapped entries={len(v.maps.entries)} ph={v.maps.ph}"
    if v.forbid is not None:
        return "forbid " + "".join(n for n, f in zip(("ins ", "del ", "sub ", "swap "), v.forbid) if f).strip()
    return "fast"


def pipeline_args(vdp, np, plan, run, part, pos, words, thr, shift=0, wide=False):
    """Arguments of ``dp_pipeline`` / ``dp_pipeline_torch`` for one slice;
    ``shift`` drops that many leading symbols (an unaligned view), ``wide``
    hands the dense ids over as int32 (the form of alphabets past 256 classes)."""
    window = vdp.DpWindow(max(part.lo - shift, 0), part.hi - shift, part.local_n - shift)
    ids = part.ids_de[shift:]
    return (pos, words, window, ids.int() if wide else ids, part.local_n - shift, run.T,
            run.pens, np.float32(thr), plan.E, run.deadend, run.statics, run.variant)


def step_kind(vdp, args) -> str:
    """Which step ``dp_pipeline`` runs for its arguments ``args``: "typed",
    "list" (the count-channel list step) or "pipeline" (``dp_pipeline_kernel``)."""
    E, variant = args[8], args[-1]
    if variant.typed is not None:
        return "typed"
    return "list" if vdp._list_step(E, variant) else "pipeline"


#: The launch counters and the error key of each step kind.
STEP_KEYS = {"typed": TYPED_KEYS, "list": LIST_KEYS, "pipeline": ("dp_pipeline",)}
STEP_ERR = {"typed": "typed_step", "list": "list_step", "pipeline": "dp_pipeline"}


def step_handoff(row_counts):
    """What the typed or the list step hands its emission after the DP's
    ``row_counts``: (the row counts themselves, which end with the rows' and
    the candidates' totals; the rows' total; the candidates' total)."""
    n_rows, M = (int(x) for x in row_counts[-2:].tolist())
    return row_counts, n_rows, M


def step_pieces(vdp, args):
    """The DP and the emission of the typed or the list step for ``args``
    (the arguments of ``dp_pipeline``), each a (wrapper, plain version)
    pair: ``dp(cands)`` -> (dec, row_counts), ``emit(dec, handed, cands,
    n_rows, n_cand)`` -> (rows, tags), ``handed`` what ``step_handoff``
    gives."""
    _pos, _words, _win, ids, limit, T, pens, thr, E, dead, statics, variant = args
    n_combo = vdp._combos(E, *statics).shape[1]
    TT = variant.typed
    if TT is not None:
        d = (ids, limit, T, pens, thr, E, TT)
        return ((lambda c: vdp.typed_dp(c, *d), lambda c: vdp.typed_dp_torch(c, *d)),
                (lambda dec, o, c, n, M: vdp.typed_emit(dec, o, c, T, TT, E, n_combo, n, M, True),
                 lambda dec, o, c, n, M: vdp.typed_emit_torch(dec, o, c, T, TT, E, n_combo, n,
                                                              True)))
    d = (ids, limit, T, pens, thr, E, dead, variant.forbid, variant.maps)
    return ((lambda c: vdp.count_dp(c, *d), lambda c: vdp.count_dp_torch(c, *d)),
            (lambda dec, o, c, n, M: vdp.count_emit(dec, o, c, T, E, n_combo, n, M, True),
             lambda dec, o, c, n, M: vdp.count_emit_torch(dec, o, c, T, E, n_combo, n, True)))


def compare_step_kernels(tpb, vdp, torch, args, what: str, h0: int = 0) -> dict:
    """Each kernel of the typed or the list step against its plain version
    on one slice's hits (``args``, the arguments of ``dp_pipeline``), bit
    for bit, each fed the plain version's inputs: the candidate list
    (``typed_expand``), the decisions and the per-tile row counts
    (``typed_dp`` / ``count_dp``), the rows and tags (``typed_emit`` /
    ``count_emit``). Returns {kernel: max_abs_err}."""
    pos, words, window, E, statics = args[0], args[1], args[2], args[8], args[10]
    kind = step_kind(vdp, args)
    k_expand, k_dp, k_emit = STEP_KEYS[kind]
    (dp, dp_plain), (emit, emit_plain) = step_pieces(vdp, args)
    ck = vdp.typed_expand(pos, words, window, E, statics, h0)
    cp = vdp.typed_expand_torch(pos, words, window, E, statics, h0)
    M = int(cp.total[0])
    errs = {k_expand: max([int_err(int(ck.total[0]), M)]
                          + [int_err(a[:M], b) for a, b in zip(ck[:3], cp[:3])])}
    # The plain list of no candidate is empty tensors, which the kernel
    # refuses as null pointers: it then reads the kernel's list, equal above.
    dec_k, counts_k = dp(cp if M else ck)
    dec_p, counts_p = dp_plain(cp)
    errs[k_dp] = max(int_err(dec_k[:, :M], dec_p[:, :M]), int_err(counts_k, counts_p))
    handed, n_rows, _m = step_handoff(counts_p)
    rows_k, tags_k = emit(dec_p, handed, cp, n_rows, M)
    rows_p, tags_p = emit_plain(dec_p, handed, cp, n_rows, M)
    torch.cuda.synchronize()
    errs[k_emit] = max(int_err(rows_k, rows_p), int_err(tags_k, tags_p))
    log(f"  {what}: {kind} step E={E} h0={h0}, {ck.items} items, {M} candidates, {n_rows} rows, "
        f"{counts_p.numel()} row counts; max_abs_err "
        + ", ".join(f"{k} {v}" for k, v in errs.items()))
    require(all(v == 0 for v in errs.values()), f"{what}: a kernel of the {kind} step disagrees "
            "with its plain version")
    return errs


def emit_edge_checks(ctx, tag: str, args) -> int:
    """The emission of a list-step or a typed-step slice (``args``, the
    arguments of ``dp_pipeline``; ``count_emit`` or ``typed_emit``, one
    kernel, ``count_emit_kernel``) against its plain version at the edges
    of its grid of (channel, tile) pairs: the plain candidate list cut to
    its first 1 candidate, 1,024 (one whole tile), 1,025 and all of them,
    each with its plain decisions and row counts, and the whole list with
    the rows of channel 0 in tile 0 and of the last channel in the last
    tile taken out (pairs without a row beside pairs with rows). Rows and
    tags bit for bit; every launch counted. Returns the max_abs_err."""
    torch, tpb, vdp = ctx.torch, ctx.tpb, ctx.vdp
    pos, words, win, ids, limit, T, pens, thr, E, dead, statics, variant = args
    key = STEP_KEYS[step_kind(vdp, args)][2]
    (_dp, dp_plain), (emit, emit_plain) = step_pieces(vdp, args)
    full = vdp.typed_expand_torch(pos, words, win, E, statics)
    M_all = int(full.total[0])
    require(M_all > vdp.TYPED_TILE + 1, f"{tag}: {M_all} candidates, too few for the edges")
    err, seen = 0, []
    for M in (1, vdp.TYPED_TILE, vdp.TYPED_TILE + 1, M_all, -1):
        cut = full._replace(total=torch.full_like(full.total, abs(M) if M > 0 else M_all))
        dec, counts = dp_plain(cut)
        m = int(cut.total[0])
        if M < 0:  # take out two pairs' rows
            nce, ntile = dec.shape[0], -(-cut.items // vdp.TYPED_TILE)
            last = (m - 1) // vdp.TYPED_TILE
            live = dec[:, :m].clone()
            live[0, :vdp.TYPED_TILE, 1] = -1
            live[nce - 1, last * vdp.TYPED_TILE:, 1] = -1
            live[..., 0] = torch.where(live[..., 1] >= 0, live[..., 0], 0)
            dec, counts = vdp._tiled(live, cut, True)
            pairs = counts[:nce * ntile].reshape(nce, ntile)[:, :last + 1]
            require(int((pairs == 0).sum()) >= 2 and int((pairs > 0).sum()) >= 1,
                    f"{tag}: the cut decisions hold no empty pair beside a full one")
        n_rows = int(counts[-2])
        before = tpb.LAUNCHES[key]
        rows_k, tags_k = emit(dec, counts, cut, n_rows, m)
        rows_p, tags_p = emit_plain(dec, counts, cut, n_rows, m)
        torch.cuda.synchronize()
        e = max(int_err(rows_k, rows_p), int_err(tags_k, tags_p))
        require(tpb.LAUNCHES[key] == before + (n_rows > 0 and dec.is_cuda),
                f"{tag}: {key} launched {tpb.LAUNCHES[key] - before} times")
        seen.append(f"{m} candidates{' (two pairs emptied)' if M < 0 else ''}: {n_rows} rows, "
                    f"{vdp.emit_pairs(m, E, T.out_list.shape[1])} pairs, err {e}")
        err = max(err, e)
    log(f"  {tag} {key} at its grid's edges: " + "; ".join(seen))
    require(err == 0, f"{tag}: {key} disagrees with its plain version at an edge")
    return err


def compare_pipeline(tpb, vdp, torch, np, engine, text, thr, what, shift=0, want_rows=True,
                     wide=False, errs=None):
    """``dp_pipeline`` (the count-channel kernel, or the typed or the list
    step's kernels) against ``dp_pipeline_torch`` on the first slice of
    ``text``: the same rows in the same order, bit for bit, the same row
    tags and the same candidate count; for the typed and the list step each
    kernel against its plain version (``compare_step_kernels``); and
    ``block_offsets`` against its plain version on every count array the
    step scans. Returns the step's and block_offsets' max_abs_err; with
    ``errs`` (a dict) the step's kernels' errors are folded into it."""
    plan, run = lane_inputs(vdp, engine, text, thr, what)
    return compare_slice_pipeline(tpb, vdp, torch, np, plan, run, run.parts[0], thr, what,
                                  shift, want_rows, wide, errs)


def compare_slice_pipeline(tpb, vdp, torch, np, plan, run, part, thr, what, shift=0,
                           want_rows=True, wide=False, errs=None):
    """``compare_pipeline`` on one slice ``part`` of the lane's inputs
    (``plan``, ``run``)."""
    hits, pos, words = tpb.packed_hits(part.ids_pf[shift:], run.T_scan, run.halo)
    args = pipeline_args(vdp, np, plan, run, part, pos, words, thr, shift, wide)
    return compare_step(
        tpb, vdp, torch, args, hits, what,
        f"{variant_name(run)} E={plan.E} k={plan.k} damerau={plan.dam} dead-end={run.deadend} "
        f"n={part.local_n - shift} ", want_rows, errs)


def dp_only(vdp, run, cf, cs, ids, limit, E):
    """(kernel call, plain call) of the DP-only entry point of ``run``'s
    variant on candidates (cf, cs): each returns (pen, cnt or None)."""
    if run.variant.typed is not None:
        args = (cf, cs, ids, limit, run.T, run.pens, E, run.variant.typed)
        return (lambda: (vdp.banded_dp_typed(*args), None),
                lambda: (vdp.banded_dp_typed_torch(*args), None))
    args = (cf, cs, ids, limit, run.T, run.pens, E, run.deadend, run.variant.forbid,
            run.variant.maps)
    return lambda: vdp.banded_dp(*args), lambda: vdp.banded_dp_torch(*args)


def compare_dp(vdp, torch, engine, text: str, thr: float, what: str, wide=False):
    """The DP-only kernel of the engine's lane (``banded_dp``, or
    ``banded_dp_typed``) vs its plain version on the candidates the lane
    builds for ``text`` (its first slice), channel by channel, bit for bit;
    ``wide`` hands the ids over as int32. Returns the max_abs_err."""
    plan, run = lane_inputs(vdp, engine, text, thr, what)
    part = run.parts[0]
    hits, cf, cs = vdp.dp_candidates(run, part)
    ids = part.ids_de.int() if wide else part.ids_de
    kernel, plain = dp_only(vdp, run, cf, cs, ids, part.local_n, plan.E)
    pen_k, cnt_k = kernel()
    pen_p, cnt_p = plain()
    torch.cuda.synchronize()
    equal = (pen_k.shape == pen_p.shape
             and torch.equal(pen_k.view(torch.int32), pen_p.view(torch.int32))
             and (cnt_k is None or torch.equal(cnt_k, cnt_p)))
    both = torch.isfinite(pen_k) & torch.isfinite(pen_p)
    err = max(float((pen_k - pen_p)[both].abs().max()) if bool(both.any()) else 0.0,
              float((cnt_k - cnt_p).abs().max()) if cnt_k is not None and cnt_k.numel() else 0.0)
    live = int(torch.isfinite(pen_p).sum())
    log(f"  {what}: {variant_name(run)} E={plan.E} k={plan.k} damerau={plan.dam} "
        f"dead-end={run.deadend} C={run.T.C} {'u8' if ids.dtype == torch.uint8 else 'int32'} ids, "
        f"n={part.local_n} hits={hits} candidates={cf.numel()} live channels={live}; "
        f"bit-equal {equal}, max_abs_err {err}")
    require(equal, f"{what}: DP kernel disagrees with its plain version")
    require(cf.numel() > 0 and live > 0, f"{what}: nothing to compare")
    return err


def ptxas_summary(log_text: str):
    """(lines for the main paths' instantiations: the W=3 scan and hit-list
    kernels at k=0 and at k=1 with Damerau rows, the offsets scan, every
    banded DP instantiation, the u8 pipeline ones, the typed kernels, the
    list step's DP (every G and MAPS, the shared-rows form) and emission,
    the wide scan at k=0 (every LPL), k=1 and the deep row templates 12 and
    24 (every instance), the wide hit-list kernel at k=0, 1, 12 and 24, the
    many lane's step at E=1 and E=2;
    number of instantiations, number of them with spills, max registers)."""
    import re

    entries, cur = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            cur = {"name": line.split("'")[1]}
            entries.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["regs"] = int(line.split("Used")[1].split("registers")[0])
    main = []
    for e in entries:
        name = e["name"]
        dp = re.search(r"(banded_dp|dp_pipeline)_kernelILi(\d)ELb([01])ELb([01])E([hi])", name)
        scan = re.search(r"(scan_bits|hit_words)_kernelILi3ELi([01])ELb([01])E(?:Li(\d+)E)?", name)
        wide = re.search(r"scan_bits_wide_kernelILi(\d)ELi(\d+)ELi(\d+)ELb([01])E", name)
        wide_hits = re.search(r"hit_words_wide_kernelILi(\d+)ELb([01])E", name)
        step = re.search(r"many_step_kernelILi(\d)ELb([01])E", name)
        cdp = re.search(r"count_dp_kernelILi(\d+)ELb([01])E", name)
        if cdp:
            label = f"count_dp<G={cdp.group(1)},MAPS={cdp.group(2)}>"
        elif "count_dp_rows_kernel" in name or "count_emit_kernel" in name:
            label = "count_dp_rows" if "count_dp_rows_kernel" in name else "count_emit"
        elif wide:
            if wide.group(3) not in ("0", "1", "12", "24"):
                continue
            label = (f"scan_bits_wide<LPL={wide.group(1)},G={wide.group(2)},"
                     f"K={wide.group(3)},Damerau={wide.group(4)}>")
        elif wide_hits:
            if wide_hits.group(1) not in ("0", "1", "12", "24"):
                continue
            label = f"hit_words_wide<K={wide_hits.group(1)},Damerau={wide_hits.group(2)}>"
        elif step:
            if step.group(1) not in ("1", "2"):
                continue
            label = f"many_step<E={step.group(1)},deadend={step.group(2)}>"
        elif dp and (dp.group(1) == "banded_dp" or dp.group(5) == "h"):
            label = (f"{dp.group(1)}<E={dp.group(2)},deadend={dp.group(3)},maps={dp.group(4)},"
                     f"{'u8' if dp.group(5) == 'h' else 'int32'}>")
        elif "typed" in name:
            g = re.search(r"typed_dp_kernelILi(\d+)E", name)
            label = (f"typed_dp<G={g.group(1)}>" if g else
                     next(k for k in ("typed_dp_rows", "typed_expand", "typed_emit",
                                      "banded_dp_typed") if k + "_kernel" in name))
        elif scan and scan.group(2) == scan.group(3):
            label = f"{scan.group(1)}<W=3,K={scan.group(2)},Damerau={scan.group(3)}" + (
                f",chunk={scan.group(4)}>" if scan.group(4) else ">")
        elif "block_offsets_kernel" in name:
            label = "block_offsets"
        else:
            continue
        main.append(f"{label}: {e.get('regs')} registers, {e.get('spill')} bytes spill stores")
    spills = sum(1 for e in entries if e.get("spill", 0) > 0)
    regs = max((e.get("regs", 0) for e in entries), default=0)
    return main, len(entries), spills, regs


class LockedOut(AssertionError):
    """A function that ``plain_locked`` locked out was called."""


class plain_locked:
    """Within the block, the plain versions of the kernels raise: a main
    path that reached one would fail instead of running on it."""

    def __init__(self, *modules_and_names):
        self.targets = modules_and_names

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]

        def refuse(*_a, **_k):
            raise LockedOut("a plain version ran on the main path")

        for m, n, _f in self.saved:
            setattr(m, n, refuse)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)
        return False


def profile_search(torch, fn, reps: int, counters=None):
    """torch.profiler over ``reps`` calls of ``fn``: a dict with the wall ms
    per call, the device ms per call summed over the device's own events
    (kernels and copies), the lines of the top device events, {event name:
    device ms per call}, and per call the kernels launched, the copies
    made, and the host's waits on the device (``cuda*Synchronize`` calls,
    which a copy to the host or ``.item()`` makes). With ``counters`` (the
    wrappers' launch counts) also ``counted``, what each grew by over the
    profiled calls, to hold beside ``events``, the profiler's event counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = dict(counters or {})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()  # the last launches end inside the profile
        wall = (time.perf_counter() - t0) * 1e3 / reps
    counted = {k: v - before[k] for k, v in (counters or {}).items()}
    rows, waits, events = [], 0, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            # host ops also carry the time of the kernels they launched
            if "Synchronize" in ev.key:
                waits += ev.count
            continue
        rows.append((ev.self_device_time_total / reps / 1e3, ev.count / reps, ev.key))
        events[ev.key] = ev.count
    rows.sort(reverse=True)
    copies = sum(cnt for _ms, cnt, key in rows if key.startswith(("Memcpy", "Memset")))
    return {
        "wall": wall, "busy": sum(r[0] for r in rows),
        "lines": [f"{ms:9.4f} ms x{cnt:<6.1f} {key[:90]}" for ms, cnt, key in rows[:12]],
        "by_event": {key: ms for ms, _cnt, key in rows},
        "kernels": sum(cnt for _ms, cnt, _key in rows) - copies, "copies": copies,
        "waits": waits / reps, "counted": counted, "events": events, "reps": reps,
    }


def device_ms(prof: dict, name: str) -> float:
    return sum(v for k, v in prof["by_event"].items() if name in k)


def pipeline_device_time(prof: dict, key: str) -> str:
    """The pipeline kernel's device time per call of its wrapper (a count
    and a write pass), both as the profile's sum and as twice the mean per
    event, with the launches the wrapper counted beside the profile's events:
    the two times differ where the profile holds fewer events than launches."""
    name = key + "_kernel"
    return (f"device time {device_ms(prof, name):.4f} ms per call summed over the profile, "
            f"{2 * launch_ms(prof, name):.4f} ms as 2 x the mean event ({prof['counted'][key]} "
            f"launches counted, {event_count(prof, name)} events profiled)")


def event_count(prof: dict, name: str) -> int:
    """Events of the kernel ``name`` in the whole profile."""
    return sum(v for k, v in prof["events"].items() if name in k)


def launch_ms(prof: dict, name: str) -> float:
    """Mean device ms of one launch of the kernel ``name``: the profile's
    sum over its event count. It stays right where the profile holds fewer
    events than the wrapper counted launches."""
    return device_ms(prof, name) * prof["reps"] / max(event_count(prof, name), 1)


def search_ms(prof: dict, key: str, name: str = None) -> float:
    """Device ms per profiled call of the kernel the wrapper ``key`` launches
    (events named ``name``, default ``key + "_kernel"``): the profile's sum
    over its calls, or, where the profile holds fewer of its events than the
    wrapper counted launches (the profiler drops an event now and then), the
    mean event (``launch_ms``) times the launches per call, with a log line
    saying so."""
    name = name or key + "_kernel"
    events, counted = event_count(prof, name), prof["counted"].get(key, 0)
    if events >= counted:
        return device_ms(prof, name)
    log(f"  the profile holds {events} {name} events of {counted} launches counted: its "
        f"device ms per call is the mean event x {counted / prof['reps']:.2f} launches")
    return launch_ms(prof, name) * counted / prof["reps"]


def wide_fields(detail: dict, name: str) -> dict:
    """The ``kernels`` line's extra fields for a wide kernel from
    ``wide_kernel_detail``: its three times, registers, the instance and, for
    the scan, its SASS per symbol."""
    x = detail[name]
    out = {key: x.get(key) for key in ("events_ms", "single_ms", "single_min_ms",
                                        "profiler_launch_ms", "profiler_call_ms",
                                        "profiler_events", "registers", "spill")}
    out["instance"] = detail["instance"] if name == "scan_bits_wide" else None
    loop = x.get("sass_loop")
    if loop:
        out["sass_per_symbol_per_lane"] = loop["per_symbol_per_lane"]
        out["sass_per_symbol_per_chain"] = loop["per_symbol_per_chain"]
        out["sass_alu_per_symbol_per_chain"] = loop["alu_per_symbol_per_chain"]
    return out


def stage_breakdown(torch, tpb, vdp, engine, corpus: str, thr: float):
    """Host-clock ms of each stage of one fuzzy search, each stage ended by a
    synchronise: plan and device inputs (cache lookups), then per slice the
    hit-list scan, the expansion + DP + emission step, the rows' copy to the
    host, and the host decode."""
    import numpy as np

    from fuzzy_aho_corasick_tpu_torch.ops.emit import decode_matches
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    ms = dict.fromkeys(("view, plan, inputs", "packed_hits", "dp_pipeline",
                        "rows to host", "decode"), 0.0)

    def lap(name, t0):
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    torch.cuda.synchronize()
    t = time.perf_counter()
    view = view_of(corpus, engine.case_insensitive)
    plan, run = lane_inputs(vdp, engine, corpus, thr, "stage breakdown")
    t = lap("view, plan, inputs", t)
    rows = []
    for part in run.parts:
        _h, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
        t = lap("packed_hits", t)
        r, _c = vdp.dp_pipeline(*pipeline_args(vdp, np, plan, run, part, pos, words, thr))
        t = lap("dp_pipeline", t)
        r = r.cpu().numpy()
        r[:, 0] += part.base
        rows.append(r)
        t = lap("rows to host", t)
    r = np.concatenate(rows)
    out = decode_matches(engine, view, corpus, len(view), r[:, 0], r[:, 2], r[:, 3],
                         np.ascontiguousarray(r[:, 1]).view(np.float32), r[:, 4],
                         np.float32(thr))
    lap("decode", t)
    return ms, len(out)


def spans_of(keys):
    """The (pattern, start, end, similarity bits) of match keys, as a sorted
    list: where paths of one penalty tie, the mapped lane at E >= 4 (the
    JAX package's and the port's alike) may report another path's edit
    counts than the oracle."""
    return sorted(k[:4] for k in keys)


def match_key(m):
    """(pattern, start, end, f32 similarity bits, the four edit counts)."""
    import numpy as np

    return (m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
            m.insertions, m.deletions, m.substitutions, m.swaps)


def recipe_engine(ctx, name: str):
    """The engines of the full-size phases by name, so that a worker process
    can build its own: ``fuzzy1`` (4b), ``forbid`` (4c), ``fuzzy2`` (4c'),
    ``typed`` (4d), ``typed14`` (4d'), ``mapped`` (4e), ``mapped4`` (4e'')."""
    L, P = ctx.Limits, ctx.Pattern
    if name == "fuzzy1":
        return make_engine(ctx, HEADLINE, L.new().edits(1))
    if name == "forbid":
        return make_engine(ctx, HEADLINE, L.new().edits(2).swaps(0))
    if name == "fuzzy2":
        return make_engine(ctx, HEADLINE, L.new().edits(2))
    if name == "typed":
        words = [P.of(("phaetra", 1.0, 0)) if w == "phaetra"
                 else P.of("sollicitudin").fuzzy(L.new().substitutions(1)) if w == "sollicitudin"
                 else w for w in HEADLINE]
        return make_engine(ctx, words, L.new().edits(1))
    if name == "typed14":
        return make_engine(ctx, HEADLINE, L.new().edits(2).substitutions(1))
    if name == "mapped":
        return make_engine(ctx, HEADLINE + ["modern"], L.new().edits(1), mappings=[("rn", "m")])
    if name == "mapped4":
        return make_engine(ctx, MAPPED4_WORDS, L.new().edits(4), mappings=[("rn", "m")])
    if name == "many1k":
        return make_engine(ctx, many_words(1000, 7), L.new().edits(1))
    if name in ("cjk1", "long"):
        return make_engine(ctx, beam_words(name), L.new().edits(1))
    if name == "cjk2":
        return make_engine(ctx, beam_words(name), L.new().edits(2))
    raise ValueError(name)


def beam_words(name: str):
    """The dictionaries of phase 4j's engines (see ``CJK_PLANT``)."""
    if name == "cjk1":
        return cjk_words(60, 1, (4, 5))
    if name == "cjk2":
        return cjk_words(40, 2, (5, 9), first=24)
    return LONG_WORDS


def many_words(count: int, seed: int, length=(6, 12), letters="abcdefghijklmnopqrstuvwxyz"):
    """``bench.py``'s many1k dictionary recipe: ``count`` random words with
    lengths in ``length`` (a half-open range), sorted, duplicates dropped."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return sorted({
        "".join(letters[i] for i in rng.integers(0, len(letters), size=int(m)))
        for m in rng.integers(*length, size=count)
    })


def many_corpus(corpus: str, words, typos: int = MANY_TYPOS) -> str:
    """``bench.py``'s many1k corpus: ``corpus`` with ``typos`` one-substitution
    typos (third letter) of the words of 9 or more letters, each between
    spaces, at a fixed step."""
    long_pats = [p for p in words if len(p) >= 9]
    buf = bytearray(corpus.encode())
    step = max(1, len(buf) // typos)
    for j in range(typos):
        p = long_pats[j % len(long_pats)]
        w = (" " + p[:2] + ("x" if p[2] != "x" else "y") + p[3:] + " ").encode()
        at = 100 + j * step
        if at + len(w) >= len(buf):
            break
        buf[at:at + len(w)] = w
    return buf.decode()


def _oracle_worker_init():
    """Worker start-up: import the port once, so that the jobs find it loaded."""
    sys.path.insert(0, HERE)
    import fuzzy_aho_corasick_tpu_torch  # noqa: F401


def _oracle_contexts(job):
    """Worker: the oracle's matches that start inside the first word (or its
    space) of each context, positions relative to the context."""
    name, thr, contexts = job
    import torch

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern, oracle

    ctx = SimpleNamespace(dev=torch.device("cpu"), Builder=FuzzyAhoCorasickBuilder,
                          Limits=FuzzyLimits, Pattern=Pattern)
    engine = recipe_engine(ctx, name)
    out = []
    for text in contexts:
        own = len(text[: text.find(" ") + 1 or len(text)].encode())  # match starts are bytes
        out.append([match_key(m) for m in oracle.search_raw(engine, text, thr) if m.start < own])
    return out


def cjk_words(count: int, seed: int, length, first=None):
    """``count`` distinct words of CJK characters from U+4E00 + 0..299 with
    lengths in ``length`` (a half-open range), drawn from ``seed``; with
    ``first``, each word's first character from U+4E00 + 300 .. 300 + first."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = set()
    while len(words) < count:
        m = int(rng.integers(*length))
        cps = rng.integers(0, 300, m)
        if first:
            cps[0] = 300 + int(rng.integers(first))
        words.add("".join(chr(0x4E00 + int(c)) for c in cps))
    return sorted(words)


def cjk_corpus(size: int, seed: int, words, filler_len) -> str:
    """About ``size`` bytes of space-joined CJK filler words (24 words of
    ``filler_len`` characters from U+4E00 + 1000..1999) with a word of
    ``words`` at 1 in ``CJK_PLANT``, a third of those with one character
    substituted by a filler character; whole words only."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fill = lambda m: "".join(chr(0x4E00 + 1000 + int(c)) for c in rng.integers(0, 1000, m))
    vocab = [fill(int(m)) for m in rng.integers(*filler_len, 24)]
    count = size // (3 * sum(filler_len) // 2 + 1) + 1024
    out = [vocab[i] for i in rng.integers(0, 24, count).tolist()]
    for at in np.flatnonzero(rng.integers(0, CJK_PLANT, count) == 0).tolist():
        w = words[int(rng.integers(len(words)))]
        if rng.integers(3) == 0:
            i = int(rng.integers(len(w)))
            w = w[:i] + fill(1) + w[i + 1:]
        out[at] = w
    nbytes = np.cumsum([len(w.encode()) + 1 for w in out])
    return " ".join(out[: int(np.searchsorted(nbytes, size))])


def cjk_contexts(corpus: str, tail: int):
    """:func:`word_contexts` for a text of space-separated words of any
    script: the distinct "word, its space, and the next ``tail``
    characters", with the byte offsets where each begins (match positions
    are bytes)."""
    import numpy as np

    words = corpus.split(" ")
    clen = np.fromiter(map(len, words), np.int64, len(words))
    blen = np.fromiter((len(w.encode()) for w in words), np.int64, len(words))
    cstart = np.concatenate([[0], np.cumsum(clen + 1)[:-1]]).tolist()
    bstart = np.concatenate([[0], np.cumsum(blen + 1)[:-1]]).tolist()
    groups = {}
    for cs, ln, bs in zip(cstart, clen.tolist(), bstart):
        groups.setdefault(corpus[cs: cs + ln + 1 + tail], []).append(bs)
    return list(groups), [np.asarray(v, dtype=np.int64) for v in groups.values()]


def arun_text(many_text: str) -> str:
    """Phase 4j (d)'s text: the many1k corpus with 64 runs of 69-72 a's
    planted between spaces."""
    import numpy as np

    rng = np.random.default_rng(SEED + 23)
    buf = bytearray(many_text.encode())
    for at in rng.integers(0, len(buf) - 100, size=64).tolist():
        r = int(rng.integers(69, 73))
        buf[at:at + r + 2] = (" " + "a" * r + " ").encode()
    return buf.decode()


def arun_oracle_set(ctx, text: str, thr: float):
    """Phase 4j (d)'s matches of the 70-character pattern (index 0 of
    ``LONG_WORDS``), which a word context's tail is too short to hold: the
    port's oracle over each run of 35 or more a's with 80 characters on
    either side, keeping the pattern's matches that start at most 37 before
    the run (a match of 70 a's with one edit holds 69 of them, cut by at
    most one other character: a run of 35 or more, and at most 34 a's and
    the edit before it). The texts are ASCII."""
    import re

    engine = recipe_engine(SimpleNamespace(**{**vars(ctx), "dev": ctx.torch.device("cpu")}),
                           "long")
    want = set()
    for mo in re.finditer(r"a{35,}", text):
        lo = max(0, mo.start() - 80)
        for m in ctx.oracle.search_raw(engine, text[lo: mo.end() + 80], thr):
            if m.pattern_index == 0 and mo.start() - 37 <= lo + m.start <= mo.end():
                want.add((0, lo + m.start, lo + m.end, *match_key(m)[3:]))
    return want


def word_contexts(corpus: str, tail: int = CONTEXT_TAIL):
    """The distinct word contexts of ``corpus`` (ASCII, single-space separated
    words): "word, its trailing space, and the next ``tail`` characters" (at
    least the longest span a match can have). Returns (contexts, starts):
    ``starts[g]`` is the array of the positions where context ``g`` begins.
    Engines that share a corpus share its contexts."""
    import numpy as np

    raw = np.frombuffer(corpus.encode(), np.uint8)
    n = raw.size
    spaces = np.flatnonzero(raw == 32)
    begin = np.concatenate([[0], spaces + 1])
    end = np.minimum(np.concatenate([spaces + 1 + tail, [n]]), n)
    begin, lens = begin[begin < end], (end - begin)[begin < end]
    width = int(lens.max())
    # One fixed-width row per word, zero past the context's end (the corpus
    # holds no NUL), grouped by a 64-bit multiply-add hash of the row; equal
    # hashes are then held to be equal rows.
    width = -(-width // 8) * 8
    padded = np.concatenate([raw, np.zeros(width, np.uint8)])
    rows = np.lib.stride_tricks.sliding_window_view(padded, width)[begin]
    rows[np.arange(width) >= lens[:, None]] = 0
    odd = np.random.default_rng(SEED).integers(1 << 62, size=width // 8, dtype=np.uint64) * 2 + 1
    hashed = (rows.view(np.uint64) * odd).sum(axis=1, dtype=np.uint64)
    _keys, first, inverse = np.unique(hashed, return_index=True, return_inverse=True)
    inverse = inverse.ravel()
    require(bool((rows == rows[first[inverse]]).all()), "two word contexts share a hash")
    order = np.argsort(inverse, kind="stable")
    cuts = np.searchsorted(inverse[order], np.arange(1, first.size))
    contexts = [corpus[b: b + w] for b, w in zip(begin[first].tolist(), lens[first].tolist())]
    return contexts, np.split(begin[order], cuts)


def context_oracle_start(pool, workers: int, name: str, thr: float, contexts):
    """Deals the oracle searches of ``recipe_engine(name)`` over ``contexts``
    out to the ``workers`` processes of ``pool``; returns the pending result
    that :func:`context_oracle_set` waits for."""
    jobs = [(name, thr, contexts[w::workers]) for w in range(workers)]
    return pool.map_async(_oracle_contexts, jobs, chunksize=1)


def context_oracle_set(pending, workers: int, starts):
    """The match set of an engine over the corpus whose :func:`word_contexts`
    are (contexts, ``starts``), built by the port's oracle without the scan,
    the DP or the slicing: one oracle search per distinct context
    (``pending``, from :func:`context_oracle_start`), keeping the matches
    that start inside the word or its space, shifted to every occurrence of
    that context."""
    found = pending.get()
    want = set()
    for w, matches in enumerate(found):
        for at, ms in zip(starts[w::workers], matches):
            if ms:
                at = at.tolist()
                for p, st, en, *rest in ms:
                    want.update((p, s + st, s + en, *rest) for s in at)
    return want


def reused_oracle_set(name: str, thr: float, base_contexts, found, workers: int, contexts,
                      starts):
    """:func:`context_oracle_set` for a text whose distinct word contexts are
    mostly ``base_contexts``, whose per-context oracle results ``found``
    (from :func:`context_oracle_start`) are reused; the port's oracle runs
    here on the contexts that are new. Returns (set, new contexts)."""
    by_ctx = {}
    for w, matches in enumerate(found):
        by_ctx.update(zip(base_contexts[w::workers], matches))
    missing = [c for c in contexts if c not in by_ctx]
    by_ctx.update(zip(missing, _oracle_contexts((name, thr, missing))))
    want = set()
    for c, at in zip(contexts, starts):
        if by_ctx[c]:
            at = at.tolist()
            for p, st, en, *rest in by_ctx[c]:
                want.update((p, s + st, s + en, *rest) for s in at)
    return want, len(missing)


def event_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def single_launch_ms(torch, fn, reps: int = 20):
    """CUDA-event ms around one call of ``fn`` after a synchronise, ``reps``
    times: (median, min). No call queues behind another, so the host's time
    to issue the launch shows in full beside the kernel's."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    out.sort()
    return out[len(out) // 2], out[0]


def three_way_ms(torch, fn, kernel: str, counters, reps: int = 10) -> dict:
    """A wrapper's kernel timed three ways: CUDA events around ``reps``
    back-to-back calls (ms per call), events around one call after a
    synchronise (median and min of 20), and the profiler's device ms per
    launch of the kernel named ``kernel`` (``launch_ms``) over ``reps`` calls,
    and per call (the mean event of every kernel whose name holds it, summed:
    a wrapper may launch two), with the profile's event count beside the
    launches the wrapper counted (``counters[kernel]``)."""
    prof = profile_search(torch, fn, reps, counters)
    single, single_min = single_launch_ms(torch, fn)
    name = kernel + "_kernel"
    return {"events_ms": event_ms(torch, fn, reps), "single_ms": single,
            "single_min_ms": single_min, "profiler_launch_ms": launch_ms(prof, name),
            # each kernel's mean event, summed: the profiler drops events
            "profiler_call_ms": sum(ms * prof["reps"] / prof["events"][k]
                                    for k, ms in prof["by_event"].items() if name in k),
            "profiler_events": event_count(prof, name),
            "launches_counted": prof["counted"].get(kernel, 0),
            "instances": sorted(k[:80] for k in prof["events"] if name in k)}


#: Opcodes the integer and logic pipe (64 lanes an SM) issues.
ALU_OPS = ("LOP3", "SHF", "IADD3", "ISETP", "SEL", "PRMT", "LEA", "IMNMX", "VIMNMX", "POPC",
           "FLO", "SGXT", "BMSK", "PLOP3", "IABS", "LOP")


def sass_loop(so_path: str, mangled: str, lane_bytes: int):
    """The main loop of the scan kernel ``mangled`` in the library at
    ``so_path``, read with ``cuobjdump -sass``: of the innermost loops that
    load from shared memory, the one with the most loads, and its symbols
    per iteration (the bytes its shared loads read over ``lane_bytes``, what
    a lane reads per symbol): {"instructions", "lds", "symbols", "alu", "ops":
    {opcode: count}}, or None where cuobjdump or the loop is missing. The
    body holds every path of the loop, the ones not taken too (the 16-byte
    stream load's fallback for a stream's edges)."""
    import re
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", "-fun", mangled, so_path], capture_output=True,
                         text=True, timeout=300).stdout
    ins = []
    for mo in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                          out):
        ins.append((int(mo.group(1), 16), mo.group(2), mo.group(3)))
    spans = []
    for addr, op, args in ins:
        tgt = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and tgt and int(tgt.group(1), 16) <= addr:
            spans.append((int(tgt.group(1), 16), addr))

    def lds(span):
        return sum(o.startswith("LDS") for a, o, _ in ins if span[0] <= a <= span[1])

    inner = [sp for sp in spans if lds(sp) and not any(
        o != sp and sp[0] <= o[0] and o[1] <= sp[1] and lds(o) for o in spans)]
    if not inner:
        return None
    main = max(inner, key=lds)
    body = [o for a, o, _ in ins if main[0] <= a <= main[1]]
    width = {"LDS.128": 16, "LDS.64": 8}
    ops = {}
    for o in body:
        ops[o.split(".")[0]] = ops.get(o.split(".")[0], 0) + 1
    read = sum(width.get(o, 4) for o in body if o.startswith("LDS"))
    return {"instructions": len(body), "lds": lds(main), "symbols": max(read // lane_bytes, 1),
            "alu": sum(ops.get(o, 0) for o in ALU_OPS), "ops": ops}


def ptxas_entry(log_text: str, pattern: str):
    """(mangled name, registers, spill-store bytes) of the first kernel in
    the ``ptxas -v`` report whose mangled name matches ``pattern``, or None."""
    import re

    name = spill = None
    for line in log_text.splitlines():
        if name is None:
            if "Compiling entry function" in line and re.search(pattern, line.split("'")[1]):
                name = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line:
            return name, int(line.split("Used")[1].split("registers")[0]), spill
    return None


#: Peak rates of one H100 SXM (NVIDIA's data sheet): device memory bytes/s;
#: float32 lane-instructions/s outside the tensor cores (67 TFLOP/s at two
#: flops per FMA); integer and logic lane-instructions/s (64 INT32 lanes per
#: SM against 128 float32 lanes: half the float32 rate).
MEM_RATE, F32_RATE, INT_RATE = 3.35e12, 33.5e12, 16.75e12
#: Instructions one DP cell (row, band, edit channel) costs: the compares,
#: adds and selects of its five arrivals, the ceiling and the emission channel.
DP_CELL_INSTR = 40


def scan_instr(W: int, k: int, damerau: bool) -> int:
    """Integer instructions the recurrence needs per symbol with 3-input
    logic ops: per 32-bit half of a limb 3 for row 0 (the last of them also
    folds the row's match bits into the hit test), 6 per error row, with
    Damerau rows 3 more per row and 2 for the shifted class mask. The bound
    counts every stream symbol once: the warm-up a chunked scan repeats is
    the kernel's cost, not the function's."""
    return 2 * W * (3 + 6 * k + (3 * k + 2 if damerau else 0))


def bound_ms(nbytes: float, ops: float, rate: float):
    """(least ms the card could take, which of the two binds)."""
    t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_template(tpb, k: int) -> int:
    """The row count K of the scan instance that serves ``k`` error rows: k
    itself up to 2, then the masked 6, 12 and 24."""
    return k if k <= 2 else tpb.MAX_K if k <= tpb.MAX_K else 12 if k <= 12 else tpb.MAX_SCAN_K


def replay_template(tpb, k: int) -> int:
    """The row count K of the hit-word instance that replays ``k`` error
    rows: the scan's up to ``MAX_K``, past it the multiple of 4 >= k (8 ..
    24; ``replay_rows`` in ``csrc/scan_wide.cu``)."""
    return row_template(tpb, k) if k <= tpb.MAX_K else max(8, -(-k // 4) * 4)


def wide_kernel_detail(ctx, kern, ids, T, halo, instance) -> dict:
    """The wide kernels at one main-path shape (``ids``, tables ``T``): for
    ``scan_bits_wide`` and ``hit_words_wide`` the three times of
    ``three_way_ms``, the bound from these inputs, the registers and spill
    stores (``ptxas -v``); for the scan also the SASS of its main loop
    (``sass_loop``) per symbol per lane and per chain. ``instance(W, k)`` is
    the (LPL, G) the library runs at this shape. Returns {"n", "W", "k",
    "damerau", "A", "halo", "hits", "instance": {"LPL", "G", "padded_W"},
    "scan_bits_wide": {...}, "hit_words_wide": {...}}."""
    import re

    torch, tpb = ctx.torch, ctx.tpb
    bits, counts = tpb.scan_bits(ids, T, halo)
    offs = tpb.block_offsets(counts)
    hits = int(offs[-1])
    N, instr = ids.numel(), scan_instr(T.W, T.k, T.damerau)
    lpl, g = instance(T.W, T.k)
    K, dam = row_template(tpb, T.k), int(T.damerau)
    rec = {"n": N, "W": T.W, "k": T.k, "damerau": T.damerau, "A": T.A, "halo": halo,
           "hits": hits, "instance": {"LPL": lpl, "G": g, "padded_W": lpl * g}}
    scan = three_way_ms(torch, lambda: tpb.scan_bits(ids, T, halo), "scan_bits_wide",
                        tpb.LAUNCHES)
    scan["bound"] = bound_ms(N + N / 8 + 4 * counts.numel(), instr * N, INT_RATE)
    entry = ptxas_entry(kern.log, f"scan_bits_wide_kernelILi{lpl}ELi{g}ELi{K}ELb{dam}E")
    if entry is not None:
        scan["registers"], scan["spill"] = entry[1], entry[2]
        # a lane reads its limbs in 16-byte pairs (an odd count's last half
        # empty) per symbol at k = 0, a u64 a limb past it
        loop = sass_loop(str(kern.path), entry[0], 16 * -(-lpl // 2) if T.k == 0 else 8 * lpl)
        if loop is not None:
            loop["per_symbol_per_lane"] = loop["instructions"] / loop["symbols"]
            loop["per_symbol_per_chain"] = loop["instructions"] * g / loop["symbols"]
            loop["alu_per_symbol_per_chain"] = loop["alu"] * g / loop["symbols"]
        scan["sass_loop"] = loop
    hw = three_way_ms(torch, lambda: tpb.hit_words(ids, bits, offs, hits, T, halo),
                      "hit_words_wide", tpb.LAUNCHES)
    hw["bound"] = bound_ms(N / 8 + 4 * offs.numel() + hits * (halo + 8 + 16 * T.W),
                           instr * hits * halo, INT_RATE)
    # One instance per k (and Damerau), or, in a library that predates
    # that, one per (LPL, G) too.
    entry = (ptxas_entry(kern.log, f"hit_words_wide_kernelILi{replay_template(tpb, T.k)}ELb{dam}E")
             or ptxas_entry(kern.log, f"hit_words_wide_kernelILi{lpl}ELi{g}ELi{K}ELb{dam}E"))
    if entry is not None:
        hw["registers"], hw["spill"] = entry[1], entry[2]
    rec["scan_bits_wide"], rec["hit_words_wide"] = scan, hw
    for name in ("scan_bits_wide", "hit_words_wide"):
        x = rec[name]
        log(f"  {name} W={T.W} k={T.k}{' Damerau' if T.damerau else ''}, {N} symbols, {hits} "
            f"hits, instance {re.sub(r'[^<]*<', '<', x['instances'][0]) if x['instances'] else '?'}: "
            f"events {x['events_ms']:.4f} ms per call over 10, one call after a synchronise "
            f"{x['single_ms']:.4f} (min {x['single_min_ms']:.4f}), profiler "
            f"{x['profiler_launch_ms']:.4f} ms per launch, {x['profiler_call_ms']:.4f} per call "
            f"({x['profiler_events']} events, {x['launches_counted']} calls); bound "
            f"{x['bound'][0]:.4g} ms by {x['bound'][1]} "
            f"({x['bound'][0] / max(x['profiler_call_ms'], 1e-9):.3f} of the profiler's time); "
            f"{x.get('registers')} registers, {x.get('spill')} bytes spilled"
            + (f"; SASS main loop {x['sass_loop']['instructions']} instructions for "
               f"{x['sass_loop']['symbols']} symbols = {x['sass_loop']['per_symbol_per_lane']:.1f} "
               f"per symbol per lane, {x['sass_loop']['per_symbol_per_chain']:.0f} per chain "
               f"({x['sass_loop']['alu_per_symbol_per_chain']:.0f} integer-pipe), "
               f"{x['sass_loop']['lds'] / x['sass_loop']['symbols']:.1f} shared loads per "
               f"symbol per lane; opcodes {x['sass_loop']['ops']}"
               if x.get("sass_loop") else ""))
    return rec


#: The mapped lane's Unicode dictionary (ß <-> ss, æ <-> ae: drift +1 and -1
#: in both directions) and the words of its corpus.
GERMAN = ["strasse", "weiss", "fussball", "aether", "grosse"]
GERMAN_TEXT = ["der", "die", "und", "mit", "straße", "strasse", "weiß", "wiess", "fußball",
               "æther", "aether", "wei", "ss", "ß", "strase", "fusball", "große", "grosze"]
#: Longer words for the mapped DP at E = 4..6 (scan budgets 8-12 rows, below
#: their lengths, so that a hit is not every position), and their corpus.
GERMAN_LONG = ["strassenbahnhof", "fussballspieler", "grossmutterhaus", "weissbierglas"]
GERMAN_LONG_TEXT = ["der", "die", "und", "mit", "straßenbahnhof", "strassenbahnhof",
                    "fußballspieler", "fussbalspieler", "großmutterhaus", "grosmutterhaus",
                    "weißbierglas", "weisbierglas", "strassenbanhof", "großmuterhaus"]
#: Words with ``sch`` (and none with ``tsch``, a pattern side past the mapped
#: DP's three symbols) for sch <-> tsch (a 4-symbol side: k = 4E) and
#: sch <-> sh (k = 3E), and their corpus.
SCH_WORDS = ["schiffsschraube", "fischmarkt", "schulbuecher", "tischlerei"]
SCH_TEXT = ["der", "und", "ein", "schiffsschraube", "shiffsshraube", "tschiffsschraube",
            "fischmarkt", "fishmarkt", "fitschmarkt", "schulbuecher", "shulbuecher",
            "tschulbuecher", "tischlerei", "tishlerei", "titschlerei", "fischmrkt", "schulbucher"]


def plant_words(text: str, seed: int, count: int, words) -> str:
    """``text`` (ASCII) with ``count`` of ``words`` written over it at seeded
    positions, each followed by a space."""
    import numpy as np

    rng = np.random.default_rng(seed)
    buf = bytearray(text.encode())
    for at in rng.integers(0, len(buf) - 32, size=count).tolist():
        w = words[int(rng.integers(len(words)))] + " "
        buf[at:at + len(w)] = w.encode()
    return buf.decode()


def word_corpus(words, count: int, seed: int) -> str:
    import numpy as np

    rng = np.random.default_rng(seed)
    return " ".join(words[i] for i in rng.integers(len(words), size=count).tolist())


def sparse_modem(text: str) -> str:
    """Every 50th ``commodo`` of ``text`` replaced by ``modem``, which the
    pattern ``modern`` matches at similarity 1.0 through the mapping rn <-> m."""
    import re

    seen = [0]

    def swap(mo):
        seen[0] += 1
        return "modem" if seen[0] % 50 == 0 else mo.group(0)

    return re.sub(r"\bcommodo\b", swap, text)


def make_engine(ctx, words, limits, mappings=(), scored=()):
    b = ctx.Builder.new().fuzzy(limits).case_insensitive(True).device(ctx.dev)
    for a, c in mappings:
        b = b.mapping(a, c)
    for a, c, score in scored:
        b = b.mapping_scored(a, c, score)
    eng = b.build(words)
    eng.backend = "device"
    return eng


def lane_kernel_checks(ctx, edited: str, keyf, lanes):
    """Phase 3 for the forbid, mapped and typed lanes: the DP-only kernels
    (``banded_dp`` with the forbid mask and with mapping arrivals,
    ``banded_dp_typed``) channel by channel and the steps (``dp_pipeline``,
    and the typed step with each of its kernels alone) row by row against
    their plain versions, bit for bit. ``lanes`` are the main-path engines (forbid,
    typed, mapped). Returns {kernel: max_abs_err}."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    L, P = ctx.Limits, ctx.Pattern
    forbid2, typed2, mapped_rn = lanes
    mib, quarter = edited[: 1 << 20], edited[: 256 << 10]
    rn_text = sparse_modem(plant_words(mib, SEED + 6, 1500,
                                       ["modem", "modern", "moderm", "modrn", "rnodern"]))
    de_text = word_corpus(GERMAN_TEXT, 60000, SEED + 7)
    ou_text = word_corpus(["colour", "color", "honour", "honor", "colr", "the", "and", "coulor",
                           "hounor", "of"], 60000, SEED + 8)
    long_text = word_corpus(GERMAN_LONG_TEXT, 12000, SEED + 24)
    sch_text = word_corpus(SCH_TEXT, 12000, SEED + 25)
    head = lambda lim: make_engine(ctx, HEADLINE, lim)
    # (what, engine, text, threshold, also on int32 ids)
    cases = [
        ("forbid edits(1).swaps(0), G = 8", head(L.new().edits(1).swaps(0)), quarter, 0.8, False),
        ("forbid edits(2).swaps(0)", forbid2, edited, 0.62, True),
        ("forbid edits(3).swaps(0)", head(L.new().edits(3).swaps(0)), quarter, 0.5, False),
        ("forbid edits(4).swaps(0), rows in shared memory", make_engine(
            ctx, HEADLINE[:4], L.new().edits(4).swaps(0)), edited[: 64 << 10], 0.5, False),
        ("forbid edits(2).insertions(0)", head(L.new().edits(2).insertions(0)), quarter, 0.62, False),
        ("forbid edits(2).deletions(0)", head(L.new().edits(2).deletions(0)), quarter, 0.62, False),
        ("forbid edits(2).substitutions(0)", head(L.new().edits(2).substitutions(0)), quarter,
         0.62, False),
        ("mapped edits(1) rn<->m, headline + modern", mapped_rn, rn_text, 0.8, True),
        ("mapped edits(1) ß<->ss æ<->ae, Unicode", make_engine(
            ctx, GERMAN, L.new().edits(1), mappings=[("ß", "ss"), ("æ", "ae")]), de_text, 0.6,
         False),
        ("mapped edits(1) scored ou<->o 0.6", make_engine(
            ctx, ["color", "honor"], L.new().edits(1), scored=[("ou", "o", 0.6)]), ou_text, 0.5,
         False),
        ("mapped edits(2) ß<->ss, Unicode", make_engine(
            ctx, GERMAN, L.new().edits(2), mappings=[("ß", "ss")]), de_text, 0.5, False),
        ("mapped edits(3) ß<->ss, Unicode, G = 32", make_engine(
            ctx, GERMAN, L.new().edits(3), mappings=[("ß", "ss")]), de_text[: 256 << 10], 0.5,
         False),
        ("mapped edits(4) ß<->ss, Unicode, k = 8, rows in shared memory", make_engine(
            ctx, GERMAN_LONG, L.new().edits(4), mappings=[("ß", "ss")]), long_text, 0.5, False),
        ("mapped edits(5) ß<->ss, Unicode, k = 10, rows in shared memory", make_engine(
            ctx, GERMAN_LONG, L.new().edits(5), mappings=[("ß", "ss")]), long_text, 0.5, False),
        ("mapped edits(6) ß<->ss, Unicode, k = 12, rows in shared memory", make_engine(
            ctx, GERMAN_LONG, L.new().edits(6), mappings=[("ß", "ss")]), long_text, 0.5, False),
        ("mapped edits(2) sch<->tsch, a 4-symbol side, k = 8", make_engine(
            ctx, SCH_WORDS, L.new().edits(2), mappings=[("sch", "tsch")]), sch_text, 0.6, False),
        ("mapped edits(3) sch<->sh, k = 9", make_engine(
            ctx, SCH_WORDS, L.new().edits(3), mappings=[("sch", "sh")]), sch_text, 0.5, False),
        ("typed substitutions(1)", head(L.new().substitutions(1)), edited, 0.8, True),
        ("typed insertions(1).deletions(1)", head(L.new().insertions(1).deletions(1)), mib, 0.7,
         False),
        ("typed edits(2).substitutions(1)", head(L.new().edits(2).substitutions(1)), mib, 0.62,
         False),
        ("typed edits(4).substitutions(1)", make_engine(
            ctx, HEADLINE[:4], L.new().edits(4).substitutions(1)), edited[: 64 << 10], 0.6, False),
        ("typed edits(1), one pattern exact-only, one substitutions(1)", typed2, edited, 0.8,
         False),
    ]
    errs = dict.fromkeys(("banded_dp", "dp_pipeline", "banded_dp_typed", "typed_step",
                          "typed_expand", "typed_dp", "typed_emit", "list_step", "count_dp",
                          "count_emit", "block_offsets"), 0.0)

    def pipe_case(eng, text, thr, what, want_rows=True, wide=False):
        _err, err_offs = compare_pipeline(tpb, vdp, torch, np, eng, text, thr,
                                          "pipeline " + what, want_rows=want_rows, wide=wide,
                                          errs=errs)
        errs["block_offsets"] = max(errs["block_offsets"], err_offs)

    for what, eng, text, thr, wide in cases:
        key = "banded_dp_typed" if vdp.lane_specs_of(eng)[0] is not None else "banded_dp"
        errs[key] = max(errs[key], compare_dp(vdp, torch, eng, text, thr, "DP " + what))
        pipe_case(eng, text, thr, what)
        if wide:
            errs[key] = max(errs[key], compare_dp(vdp, torch, eng, text, thr,
                                                  "DP " + what + ", int32 ids", wide=True))
            pipe_case(eng, text, thr, what + ", int32 ids", wide=True)
    # A threshold that a forbid2 match's similarity ties: the first from the
    # top that the lane keeps at itself.
    tie_text = edited[: 64 << 10]
    sims = sorted({np.float32(m.similarity) for m in forbid2.search_raw(tie_text, 0.62)
                   if m.similarity < 1.0}, reverse=True)
    f_tie = next(t for t in sims if any(np.float32(m.similarity) == t
                                        for m in forbid2.search_raw(tie_text, float(t))))
    tie_dev = sorted(map(keyf, forbid2.search_raw(tie_text, float(f_tie))))
    forbid2.backend = "oracle"
    tie_ora = sorted(map(keyf, forbid2.search_raw(tie_text, float(f_tie))))
    forbid2.backend = "device"
    log(f"  forbid lane, threshold {float(f_tie)!r}, tied: device {len(tie_dev)} vs oracle "
        f"{len(tie_ora)} matches, equal {tie_dev == tie_ora}")
    require(tie_dev == tie_ora, "forbid lane disagrees with the oracle at a tied threshold")
    pipe_case(forbid2, tie_text, float(f_tie), "forbid at the tied threshold")
    # The list step on a range of slice 1's hits: a first hit h0 = 1 and
    # the rows' tags, each kernel against its plain version.
    for eng, thr, what in ((forbid2, 0.62, "forbid"), (mapped_rn, 0.8, "mapped")):
        plan, run = lane_inputs(vdp, eng, rn_text if eng is mapped_rn else tie_text, thr,
                                what + " range")
        part = run.parts[0]
        _h, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
        half = pos.numel() // 2
        args = pipeline_args(vdp, np, plan, run, part, pos[half - 1:], words[half - 1:], thr)
        for key, e in compare_step_kernels(tpb, vdp, torch, args,
                                           f"{what}, the second half of the hits", h0=1).items():
            errs[key] = max(errs[key], e)
        got = vdp.dp_pipeline(*args, h0=1, tags=True)
        want = vdp.dp_pipeline_torch(*args, h0=1, tags=True)
        require(torch.equal(got[0], want[0]) and got[1] == want[1]
                and torch.equal(got[2], want[2]) and got[0].shape[0] > 0,
                f"the list step disagrees with its plain version on a {what} range")
    # A threshold that a typed match's similarity ties; texts without hits.
    tie_text = edited[: 256 << 10]
    tie = max(np.float32(m.similarity) for m in typed2.search_raw(tie_text, 0.8)
              if m.similarity < 1.0)
    tie_dev = sorted(map(keyf, typed2.search_raw(tie_text, float(tie))))
    typed2.backend = "oracle"
    tie_ora = sorted(map(keyf, typed2.search_raw(tie_text, float(tie))))
    typed2.backend = "device"
    n_tied = sum(1 for t in tie_dev if t[3] == tie.view(np.uint32).item())
    log(f"  typed lane, threshold {float(tie)!r} tied by {n_tied} matches: device {len(tie_dev)} "
        f"vs oracle {len(tie_ora)} matches, equal {tie_dev == tie_ora}")
    require(tie_dev == tie_ora and n_tied > 0, "typed lane disagrees with the oracle at a tied threshold")
    pipe_case(typed2, tie_text, float(tie), "typed at the tied threshold")
    # The typed step on a range of slice 1's hits: a first hit h0 = 1 and
    # the rows' tags, each kernel against its plain version.
    plan, run = lane_inputs(vdp, typed2, tie_text, 0.8, "typed range")
    part = run.parts[0]
    _h, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    half = pos.numel() // 2
    args = pipeline_args(vdp, np, plan, run, part, pos[half - 1:], words[half - 1:], 0.8)
    for key, e in compare_step_kernels(tpb, vdp, torch, args,
                                       "typed, the second half of the hits", h0=1).items():
        errs[key] = max(errs[key], e)
    got = vdp.dp_pipeline(*args, h0=1, tags=True)
    want = vdp.dp_pipeline_torch(*args, h0=1, tags=True)
    require(torch.equal(got[0], want[0]) and got[1] == want[1] and torch.equal(got[2], want[2]),
            "the typed step disagrees with its plain version on a range")
    # Mappings at edits(4): the lane scans with 2E = 8 error rows, past the
    # one-thread scan's six, on the wide kernels' deep instances, and its DP
    # is count_dp_rows_kernel with mapping arrivals; the search equals the
    # oracle's as (pattern, start, end, similarity bits). Where two paths
    # tie, the lane's edit counts may be another path's than the oracle's
    # (the JAX device lane's are the port's: tests/test_torch_dp_list.py).
    mapped4 = make_engine(ctx, GERMAN, L.new().edits(4), mappings=[("ß", "ss")])
    de_small = de_text[: 16 << 10]
    specs = vdp.lane_specs_of(mapped4)
    require(specs[1] is not None and specs[1].k == 8
            and vdp.dp_plan(mapped4, 0.5, len(de_small), *specs) is not None,
            "the mapped lane declines edits(4)")
    reset_launches(tpb)
    with plain_locked((ctx.oracle, "search_raw")):
        got4 = sorted(map(keyf, mapped4.search_raw(de_small, 0.5)))
    backend4, launches4 = mapped4.last_stats["backend"], dict(tpb.LAUNCHES)
    mapped4.backend = "oracle"
    want4 = sorted(map(keyf, mapped4.search_raw(de_small, 0.5)))
    log(f"  mapped edits(4) (scan budget {specs[1].k} rows): backend {backend4}, {len(got4)} "
        f"matches, equal to the oracle as (pattern, start, end, similarity) "
        f"{spans_of(got4) == spans_of(want4)}, with the edit counts {got4 == want4} "
        f"({len(set(got4) - set(want4))} tied matches with other counts); launches {launches4}")
    require(backend4 == "device-fuzzy-dp-mapped" and spans_of(got4) == spans_of(want4)
            and len(got4) > 0, "mapped edits(4) differs from the oracle's search")
    require(all(launches4[k] > 0 for k in DEEP_SCAN_KEYS + LIST_KEYS)
            and launches4["scan_bits"] == launches4["hit_words"] == 0,
            "mapped edits(4) did not run the deep scan instances and the list step")
    nothing = "lorem ipsum dolor sit amet " * 20000
    for eng, thr, what in ((forbid2, 0.9, "forbid"), (mapped_rn, 0.95, "mapped"),
                           (typed2, 0.8, "typed")):
        pipe_case(eng, nothing, thr, what + ", filler only", want_rows=False)
    return errs


#: The six instances of the list step's DP past 32 cells, (E, mappings).
ROWS_INSTANCES = tuple((E, maps) for E in (4, 5, 6) for maps in (False, True))


def rows_instances(log_text: str) -> dict:
    """{"E=4", "E=4 maps", ...: (mangled name, registers, spill bytes)} of
    ``count_dp_rows_kernel<E, MAPS>`` from the ``ptxas -v`` report."""
    return {f"E={E}" + (" maps" if maps else ""):
            ptxas_entry(log_text, rf"count_dp_rows_kernelILi{E}ELb{int(maps)}E")
            for E, maps in ROWS_INSTANCES}


def rows_kernel_checks(ctx, edited: str, uni_text: str) -> dict:
    """Phase 3 for ``count_dp_rows_kernel<E, MAPS>``, the list step's DP past
    32 cells (a band per lane, early stop): the step (``compare_pipeline``,
    each kernel alone too) bit for bit against its plain version at E = 4, 5
    and 6 without mappings (the instances with mappings are
    ``lane_kernel_checks``' mapped edits(4)-(6) cases); at E = 4 each forbid
    flag, the dead-end filter (the Cyrillic dictionary), a threshold that a
    similarity ties exactly, a range with h0 = 1 and tags, a hit list with
    no candidate, candidates that all die at row 1 (every arrival but the
    exact one over the budget, over a text with no dictionary symbol) and
    candidates at the depth Lmax. Returns {kernel: max_abs_err} and the
    registers and spill bytes of the six instances."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    L = ctx.Limits
    small = edited[: 64 << 10]
    long_text = word_corpus(GERMAN_LONG_TEXT, 6000, SEED + 27)
    errs = dict.fromkeys(("list_step", "typed_expand", "count_dp", "count_emit",
                          "block_offsets"), 0.0)

    def step_case(eng, text, thr, what, E, want_rows=True, deadend=False):
        plan, run = lane_inputs(vdp, eng, text, thr, what)
        require(plan.E == E and run.variant.typed is None and run.deadend == deadend,
                f"{what}: E = {plan.E}, dead-end {run.deadend}")
        _e, err_offs = compare_slice_pipeline(tpb, vdp, torch, np, plan, run, run.parts[0], thr,
                                              "rows DP " + what, want_rows=want_rows, errs=errs)
        errs["block_offsets"] = max(errs["block_offsets"], err_offs)
        return plan, run

    head4 = HEADLINE[:4]
    forbid4 = make_engine(ctx, head4, L.new().edits(4).swaps(0))
    for eng, text, thr, what, E in (
        (make_engine(ctx, head4, L.new().edits(4)), small, 0.5, "edits(4)", 4),
        (make_engine(ctx, GERMAN_LONG, L.new().edits(5)), long_text, 0.5, "edits(5)", 5),
        (make_engine(ctx, GERMAN_LONG, L.new().edits(6)), long_text, 0.45, "edits(6)", 6),
        (make_engine(ctx, head4, L.new().edits(4).insertions(0)), small, 0.5,
         "edits(4).insertions(0)", 4),
        (make_engine(ctx, head4, L.new().edits(4).deletions(0)), small, 0.5,
         "edits(4).deletions(0)", 4),
        (make_engine(ctx, head4, L.new().edits(4).substitutions(0)), small, 0.5,
         "edits(4).substitutions(0)", 4),
        (forbid4, small, 0.5, "edits(4).swaps(0)", 4),
    ):
        step_case(eng, text, thr, what, E)
    step_case(make_engine(ctx, UNICODE_WORDS[:4], L.new().edits(4)), uni_text, 0.3,
              "edits(4), Cyrillic dictionary (dead-end filter)", 4, deadend=True)
    # A threshold that a similarity of the lane ties exactly: the first from
    # the top that the lane keeps at itself.
    sims = sorted({np.float32(m.similarity) for m in forbid4.search_raw(small, 0.5)
                   if m.similarity < 1.0}, reverse=True)
    tie = next(t for t in sims if any(np.float32(m.similarity) == t
                                      for m in forbid4.search_raw(small, float(t))))
    step_case(forbid4, small, float(tie), f"edits(4).swaps(0) at the tied threshold {tie!r}", 4)
    # A range of the hits (h0 = 1, tags), a hit list with no candidate, the
    # early stop at row 1, and candidates at the depth Lmax.
    plan, run = lane_inputs(vdp, forbid4, small, 0.5, "rows DP range")
    part = run.parts[0]
    _h, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    half = pos.numel() // 2
    args = pipeline_args(vdp, np, plan, run, part, pos[half - 1:], words[half - 1:], 0.5)
    for key, e in compare_step_kernels(tpb, vdp, torch, args, "rows DP edits(4).swaps(0), the "
                                       "second half of the hits", h0=1).items():
        errs[key] = max(errs[key], e)
    got = vdp.dp_pipeline(*args, h0=1, tags=True)
    want = vdp.dp_pipeline_torch(*args, h0=1, tags=True)
    require(torch.equal(got[0], want[0]) and got[1] == want[1] and torch.equal(got[2], want[2])
            and got[0].shape[0] > 0, "the rows DP disagrees with its plain version on a range")
    none = pipeline_args(vdp, np, plan, run, part, pos, torch.zeros_like(words), 0.5)
    compare_step(tpb, vdp, torch, none, pos.numel(), "rows DP, no candidate", want_rows=False,
                 errs=errs)
    require(int(vdp.typed_expand(*none[:3], plan.E, run.statics).total[0]) == 0,
            "the hit list with no fired bit has candidates")
    digits = "0123456789 " * 6000
    plan_d, run_d = lane_inputs(vdp, forbid4, digits, 0.5, "rows DP early stop")
    part_d = run_d.parts[0]
    pos_d = torch.arange(part_d.lo + 16, part_d.hi - 16, 11, dtype=torch.int64, device=ctx.dev)
    words_d = torch.full((pos_d.numel(), words.shape[1]), 0xFFFFFFFF, dtype=torch.int64,
                         device=ctx.dev)
    d_args = list(pipeline_args(vdp, np, plan_d, run_d, part_d, pos_d, words_d, 0.5))
    pens = d_args[6]
    d_args[6] = pens._replace(max_pen=np.float32(min(pens.p_sub, pens.p_ins, pens.p_del,
                                                     pens.p_swap) / 2))
    _e, _o = compare_step(tpb, vdp, torch, tuple(d_args), pos_d.numel(),
                          "rows DP, every candidate dead at row 1", want_rows=False, errs=errs)
    n_dead = int(vdp.typed_expand(*d_args[:3], plan_d.E, run_d.statics).total[0])
    log(f"  rows DP early stop: {n_dead} candidates over a text without a dictionary symbol, "
        f"max_pen {float(d_args[6].max_pen)}")
    require(n_dead > 1000, "the early-stop case has too few candidates")
    longest = max(head4, key=len)
    deep_text = (" lorem " + longest) * 4000
    plan_l, run_l = step_case(forbid4, deep_text, 0.5, f"candidates at the depth Lmax "
                              f"({longest!r})", 4)
    depth = int(run_l.T.depth.max())
    rows_l = vdp.dp_pipeline(*pipeline_args(vdp, np, plan_l, run_l, run_l.parts[0],
                                            *tpb.packed_hits(run_l.parts[0].ids_pf,
                                                             run_l.T_scan, run_l.halo)[1:],
                                            0.5))[0]
    n_deep = int((rows_l[:, 3] == head4.index(longest)).sum())
    log(f"  rows DP depth: Lmax {run_l.T.Lmax}, deepest field {depth}, {n_deep} rows of "
        f"{longest!r}")
    require(depth == run_l.T.Lmax == len(longest) and n_deep >= 4000,
            "the depth case did not reach Lmax")
    regs = rows_instances(ctx.kern.log)
    for inst, entry in regs.items():
        log(f"  count_dp_rows_kernel {inst}: "
            + (f"{entry[1]} registers, {entry[2]} bytes spill stores" if entry else "not found"))
    require(all(regs.values()), "an instance of count_dp_rows_kernel is missing from ptxas")
    require(regs["E=4 maps"][2] == 0, "count_dp_rows_kernel<4, true> spills")
    log(f"  rows DP checks: max_abs_err {errs}")
    require(all(v == 0 for v in errs.values()), "the rows DP disagrees with its plain version")
    return errs, regs


#: The instances of the typed DP past 32 cells, typed_dp_rows_kernel<E, S,
#: G> (G lanes a candidate, S channel slots a lane), each with a typed limit
#: that routes to it: (E, S, G, channels, limits).
TYPED_ROWS = (
    (2, 1, 16, 14, lambda L: L.new().edits(2).substitutions(1)),
    (3, 1, 16, 15, lambda L: L.new().edits(3).insertions(1).deletions(1).substitutions(1)
     .swaps(1)),
    (3, 1, 32, 20, lambda L: L.new().edits(3).insertions(1).deletions(1).substitutions(1)),
    (3, 2, 32, 33, lambda L: L.new().edits(3).insertions(2).deletions(2)),
    (4, 1, 16, 16, lambda L: L.new().edits(4).insertions(1).deletions(1).substitutions(1)
     .swaps(1)),
    (4, 1, 32, 28, lambda L: L.new().edits(4).insertions(1).deletions(1).substitutions(1)),
    (4, 2, 32, 55, lambda L: L.new().edits(4).substitutions(1)),
    (4, 3, 32, 65, lambda L: L.new().edits(4).insertions(2)),
    (5, 1, 16, 16, lambda L: L.new().edits(5).insertions(1).deletions(1).substitutions(1)
     .swaps(1)),
    (5, 1, 32, 24, lambda L: L.new().edits(5).insertions(1).deletions(1).substitutions(1)
     .swaps(2)),
    (5, 2, 32, 48, lambda L: L.new().edits(5).insertions(1).deletions(1).substitutions(2)),
    (5, 3, 32, 96, lambda L: L.new().edits(5).insertions(2).deletions(2)),
    (6, 1, 16, 16, lambda L: L.new().edits(6).insertions(1).deletions(1).substitutions(1)
     .swaps(1)),
    (6, 1, 32, 24, lambda L: L.new().edits(6).insertions(1).deletions(1).substitutions(1)
     .swaps(2)),
    (6, 2, 32, 44, lambda L: L.new().edits(6).insertions(1).deletions(1).substitutions(1)),
    (6, 3, 32, 96, lambda L: L.new().edits(6).insertions(1).deletions(2).substitutions(3)),
)


def typed_rows_instances(log_text: str) -> dict:
    """{"E=2 S=1 G=16", ...: (mangled name, registers, spill bytes)} of
    ``typed_dp_rows_kernel<E, S, G>`` from the ``ptxas -v`` report."""
    return {f"E={E} S={S} G={G}": ptxas_entry(log_text, rf"typed_dp_rows_kernelILi{E}ELi{S}ELi{G}E")
            for E, S, G, _n, _l in TYPED_ROWS}


def typed_rows_checks(ctx, edited: str, corpus: str) -> tuple:
    """Phase 3 for ``typed_dp_rows_kernel<E, S, G>``, the typed DP past 32
    cells (a channel per lane and slot, the bands in registers, early stop,
    a grid of resident blocks): the typed step (``compare_pipeline``, each
    kernel alone too: the decisions and the row counts of ``typed_dp``
    against ``typed_dp_torch``, the rows of ``typed_emit``) bit for bit at
    every instance, E = 2..6 and 14 to 96 channels; at 14, 55 and 96
    channels also on int32 ids; the 14-channel engine at a threshold that a
    similarity ties exactly, over filler only, and over the first 16 MiB
    of ``corpus`` (slice 1 of phase 4d'); the 96-channel E = 6 engine over
    filler only; the 16-channel E = 4 engine over a text whose candidate
    list is longer than any grid the kernel launches, so that its groups
    take several candidates in turn. Returns ({kernel: max_abs_err}, the
    instances' registers and spill bytes)."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    L = ctx.Limits
    t0 = time.perf_counter()
    mib = edited[: 1 << 20]
    long_text = word_corpus(GERMAN_LONG_TEXT, 3000, SEED + 27)
    errs = dict.fromkeys(("typed_step", "typed_expand", "typed_dp", "typed_emit"), 0.0)

    def case(eng, text, thr, what, E, nch, G=None, want_rows=True, wide=False):
        plan, run = lane_inputs(vdp, eng, text, thr, what)
        TT = run.variant.typed
        require(TT is not None and plan.E == E and TT.nch == nch,
                f"{what}: E = {plan.E}, {TT.nch if TT is not None else 'no'} typed channels")
        require(G is None or (2 * E + 1) * nch > 32,
                f"{what}: {(2 * E + 1) * nch} cells, not the rows kernel")
        compare_slice_pipeline(tpb, vdp, torch, np, plan, run, run.parts[0], thr,
                               "typed rows DP " + what, want_rows=want_rows, wide=wide,
                               errs=errs)
        return plan, run

    engines = {}
    for E, S, G, nch, limits in TYPED_ROWS:
        words, text, thr = (HEADLINE, mib, 0.62) if E == 2 else (
            HEADLINE[:4], edited[: 256 << 10], 0.5) if E == 3 else (GERMAN_LONG, long_text, 0.5)
        eng = engines[E, nch] = make_engine(ctx, words, limits(L))
        what = f"E={E} {nch} channels (S={S}, G={G})"
        case(eng, text, thr, what, E, nch, G)
        if nch in (14, 55, 96):
            case(eng, text, thr, what + ", int32 ids", E, nch, G, wide=True)
    typed14, typed96 = engines[2, 14], engines[6, 96]
    # A threshold that a typed14 match's similarity ties exactly: the first
    # from the top that the lane keeps at itself.
    tie_text = mib[: 256 << 10]
    sims = sorted({np.float32(m.similarity) for m in typed14.search_raw(tie_text, 0.62)
                   if m.similarity < 1.0}, reverse=True)
    tie = next(t for t in sims if any(np.float32(m.similarity) == t
                                      for m in typed14.search_raw(tie_text, float(t))))
    case(typed14, tie_text, float(tie), f"E=2 14 channels at the tied threshold {tie!r}", 2, 14)
    nothing = "lorem ipsum dolor sit amet " * 20000
    case(typed14, nothing, 0.9, "E=2 14 channels, filler only", 2, 14, want_rows=False)
    case(typed96, nothing, 0.9, "E=6 96 channels, filler only", 6, 96, want_rows=False)
    case(typed14, corpus[: 16 << 20], 0.62, "E=2 14 channels, a 16 MiB slice", 2, 14)
    # A list longer than any grid the kernel launches: at most 2,048
    # threads an SM, so SMs x 2048 / 16 groups of 16 lanes a wave.
    plan, run = case(engines[4, 16], word_corpus(GERMAN_LONG_TEXT, 12000, SEED + 28), 0.5,
                     "E=4 16 channels (S=1, G=16), a list past the grid", 4, 16)
    part = run.parts[0]
    _h, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    n_cand = int(vdp.typed_expand(pos, words, vdp.DpWindow(part.lo, part.hi, part.local_n),
                                  plan.E, run.statics).total[0])
    groups = (ctx.kern.lib.fac_typed_rows_waves()
              * torch.cuda.get_device_properties(0).multi_processor_count * 2048 // 16)
    log(f"  typed rows DP: {n_cand} candidates, at most {groups} groups of 16 lanes in the grid")
    require(n_cand > groups, "the typed rows DP's list is not longer than its grid")
    regs = typed_rows_instances(ctx.kern.log)
    for inst, entry in regs.items():
        log(f"  typed_dp_rows_kernel {inst}: "
            + (f"{entry[1]} registers, {entry[2]} bytes spill stores" if entry else "not found"))
    require(all(regs.values()), "an instance of typed_dp_rows_kernel is missing from ptxas")
    log(f"  typed rows DP checks: max_abs_err {errs}, {time.perf_counter() - t0:.1f} s")
    require(all(v == 0 for v in errs.values()), "the typed rows DP disagrees with its plain version")
    return errs, regs


def expand_inputs(torch, np, dev, K: int, n_pat: int, density: float, seed: int):
    """A synthetic hit list for the expansion: ``K`` ascending positions from
    100 on (gaps of 1-3, so runs of consecutive ends), match words of two
    u32 halves with each bit set at ``density``, and statics (BITS, P2F,
    DEPTHS) of ``n_pat`` patterns, one field each."""
    rng = np.random.default_rng(seed)
    pos = 100 + np.cumsum(rng.integers(1, 4, K))
    words = (rng.random((K, 2, 32)) < density).astype(np.int64)
    words = (words << np.arange(32, dtype=np.int64)).sum(axis=2)
    statics = (tuple((p % 2, (7 * p) % 32) for p in range(n_pat)),
               tuple((p,) for p in range(n_pat)), tuple(5 + p % 9 for p in range(n_pat)))
    return (torch.from_numpy(pos.astype(np.int64)).to(dev), torch.from_numpy(words).to(dev),
            statics)


def expand_kernel_checks(ctx) -> float:
    """Phase 3 for the one-pass ``typed_expand_kernel``: the list (field,
    start, combo and the total on the card) against ``typed_expand_torch``,
    bit for bit, at 1, 255, 256, 257 and 4096 items (and 2047-2049 around a
    block's tile, ``verify_dp.TYPED_EXPAND_ITEMS``), at 2^22 + 3 items (past
    the blocks the card holds at once, so the look-back crosses waves), with
    no candidate and with every item a candidate, at h0 = 0 and 1; one
    launch per call and no ``block_offsets``; 50 calls on one input give
    the same list every time, with a chained ``block_offsets`` (past one
    tile) between every fifth call and the next, so the two kernels take
    turns on the stream's one look-back status array
    (``packed_bitap.lookback_launch``). Returns the max_abs_err."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    err = 0.0
    big = None
    # (what, E, items wanted, patterns, bit density, h0)
    for what, E, items, n_pat, dens, h0 in (
        ("1 item", 0, 1, 1, 1.0, 0), ("1 item, h0 = 1", 0, 1, 1, 1.0, 1),
        ("255 items", 0, 255, 1, 0.5, 0), ("256 items", 0, 256, 1, 0.5, 0),
        ("257 items", 0, 257, 1, 0.5, 1), ("2047 items", 0, 2047, 1, 0.5, 0),
        ("2048 items", 0, 2048, 1, 0.5, 0), ("2049 items", 0, 2049, 1, 0.5, 1),
        ("4096 items", 0, 4096, 4, 0.5, 0),
        ("4096 items, h0 = 1", 1, 4095, 5, 0.3, 1),
        ("2^22 + 3 items", 0, (1 << 22) + 3, 1, 0.5, 0),
        ("2^22 + 3 items, 3 combos, h0 = 1", 1, 3 * ((1 << 22) // 3 + 1), 1, 0.4, 1),
        ("no candidate", 1, 30000, 2, 0.0, 0), ("every item a candidate", 0, 30000, 3, 1.0, 1),
    ):
        n_combo = n_pat * (2 * E + 1)
        require(items % n_combo == 0, f"{what}: {items} items over {n_combo} combos")
        K = items // n_combo + h0
        pos, words, statics = expand_inputs(torch, np, ctx.dev, K, n_pat, dens, SEED + items)
        window = vdp.DpWindow(0, 1 << 30, 1 << 30)
        before = dict(tpb.LAUNCHES)
        ck = vdp.typed_expand(pos, words, window, E, statics, h0)
        launched = {k: tpb.LAUNCHES[k] - before[k] for k in tpb.LAUNCHES
                    if tpb.LAUNCHES[k] != before[k]}
        cp = vdp.typed_expand_torch(pos, words, window, E, statics, h0)
        M = int(cp.total[0])
        e = max([int_err(int(ck.total[0]), M)] + [int_err(a[:M], b)
                                                  for a, b in zip(ck[:3], cp[:3])])
        log(f"  typed_expand {what}: {ck.items} items, {M} candidates, launches {launched}, "
            f"max_abs_err {e}")
        require(ck.items == cp.items == items and launched == {"typed_expand": 1},
                f"typed_expand {what}: {ck.items} items, launches {launched}")
        if dens == 0.0:
            require(M == 0, "typed_expand: candidates without a fired bit")
        if what == "every item a candidate":
            require(M == items, "typed_expand: not every item a candidate")
        err = max(err, e)
        if items > 1 << 22 and big is None:
            big = (pos, words, window, E, statics, h0, ck, M)
    pos, words, window, E, statics, h0, first, M = big
    same, between = 0, []
    rng = np.random.default_rng(SEED + 29)
    for i in range(50):
        again = vdp.typed_expand(pos, words, window, E, statics, h0)
        same += int(int(again.total[0]) == M
                    and all(torch.equal(a[:M], b[:M]) for a, b in zip(again[:3], first[:3])))
        if i % 5 == 4:
            n = tpb.OFFSETS_TILE * (1 + i // 5) + 3 * i
            counts = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32)).to(ctx.dev)
            between.append(int_err(tpb.block_offsets(counts), tpb.block_offsets_torch(counts)))
    log(f"  typed_expand 50 calls on the 2^22 + 3 items: {same} of 50 equal to the first; "
        f"chained block_offsets between them: max_abs_err {max(between)} over {len(between)}")
    require(same == 50, "typed_expand gives another list on the same input")
    require(max(between) == 0, "block_offsets disagrees between typed_expand calls")
    require(err == 0, "typed_expand disagrees with its plain version")
    return err


def lane_main_path(ctx, tag: str, name: str, engine, corpus: str, thr: float, backend: str,
                   locked, scan_keys, pipe_keys: tuple, oracle_set, min_matches: int,
                   ties=False):
    """One DP lane (``engine`` is ``recipe_engine(name)``) at full width through
    ``search_raw``: a probe on 1 MiB,
    then over ``corpus`` (or, where the lane declines there, over its largest
    power-of-two prefix the lane serves) one first search, one warm-up and
    three timed ones with the plain versions and the oracle locked out; the
    launch counters; the match set against the context oracle
    (``oracle_set(name, text, thr)``); the profiler's launches, copies and
    waits per search. With ``ties`` the match sets are compared as
    ``spans_of`` them, and the matches whose edit counts differ counted.
    """
    torch, tpb, vdp = ctx.torch, ctx.tpb, ctx.vdp
    t_phase = time.perf_counter()

    def served(text):
        # Through the entry point, so that the engine's own routing picks
        # the lane; a lane that declined would reach the locked-out oracle.
        try:
            with plain_locked((ctx.oracle, "search_raw")):
                engine.search_raw(text, thr)
        except LockedOut:
            return False
        return True

    require(served(corpus[: 1 << 20]), f"{tag}: the lane declines on a 1 MiB probe")
    text, note = corpus, ""
    while not served(text):
        size = 1 << ((len(text) - 1).bit_length() - 1)
        note = f" (the lane declined at {len(text)} bytes: run at {size})"
        text = corpus[:size]
        require(size >= 1 << 20, f"{tag}: the lane declines at every size")
    for k in tpb.LAUNCHES:
        tpb.LAUNCHES[k] = 0
    with plain_locked(*locked):
        engine.search_raw(text, thr)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = engine.search_raw(text, thr)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = dict(tpb.LAUNCHES)
    stats = dict(engine.last_stats)
    best = min(times)
    log(f"  {len(text)} bytes{note}, best of 3 {best * 1e3:.3f} ms (all "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) = {len(text) / best / 1e9:.3f} GB/s, "
        f"{len(got)} matches, launches {launches}")
    log(f"  last_stats {stats}")
    require(stats["backend"] == backend, f"{tag}: backend {stats['backend']}, expected {backend}")
    require(all(launches[k] > 0 for k in scan_keys + pipe_keys),
            f"{tag}: the lane did not launch the scan's kernels and {pipe_keys}")
    require(all(v == 0 for k, v in launches.items() if k not in scan_keys + pipe_keys),
            f"{tag}: the lane launched a kernel of another lane")
    if "typed_expand" in pipe_keys:
        require(launches["typed_expand"] == launches[pipe_keys[1]],
                f"{tag}: {launches['typed_expand']} expansion launches for "
                f"{launches[pipe_keys[1]]} steps, not one each")
    if pipe_keys in (LIST_KEYS, TYPED_KEYS):
        # The list and the typed step scan nothing: their emission places
        # its rows from the DP's channel totals, so block_offsets runs for
        # the scan's counts alone.
        scans = launches.get("scan_bits", 0) + launches.get("scan_bits_wide", 0)
        require(launches[pipe_keys[2]] <= launches[pipe_keys[1]]
                and launches["block_offsets"] == scans,
                f"{tag}: {launches['block_offsets']} block_offsets launches for {scans} scans, "
                f"{launches[pipe_keys[2]]} emissions for {launches[pipe_keys[1]]} steps")
    dev_set = {match_key(m) for m in got}
    require(len(dev_set) == len(got), f"{tag}: the lane repeats a match")
    t0 = time.perf_counter()
    want, n_ctx = oracle_set(name, text, thr)
    if ties:
        equal = spans_of(dev_set) == spans_of(want)
        log(f"  independent oracle: {n_ctx} windows, {len(want)} matches, "
            f"{time.perf_counter() - t0:.1f} s; equal as (pattern, start, end, similarity): "
            f"{equal}; with the edit counts: {dev_set == want} ({len(dev_set - want)} tied "
            "matches with other counts)")
    else:
        equal = dev_set == want
        log(f"  independent context oracle (tail {CONTEXT_TAIL}): {n_ctx} contexts, {len(want)} "
            f"matches, {time.perf_counter() - t0:.1f} s; equal: {equal}")
    require(equal, f"{tag}: the lane disagrees with the oracle")
    require(len(want) > min_matches, f"{tag}: too few matches to be a real check")
    prof = profile_search(torch, lambda: engine.search_raw(text, thr), 3, tpb.LAUNCHES)
    log(f"  torch.profiler over 3 searches: wall {prof['wall']:.3f} ms per search, device busy "
        f"{prof['busy']:.3f} ms ({prof['busy'] / prof['wall']:.3f} of wall); per search "
        f"{prof['kernels']:.1f} kernel launches, {prof['copies']:.1f} copies, "
        f"{prof['waits']:.1f} host waits, over {stats['slices']} slices; "
        + "; ".join(f"{k}: the wrapper counted {prof['counted'][k]} launches, the profiler "
                    f"shows {event_count(prof, KERNEL_OF.get(k, k))} events" for k in pipe_keys))
    step_ms = sum(device_ms(prof, KERNEL_OF.get(k, k)) for k in pipe_keys)
    offs_ms = device_ms(prof, "block_offsets_kernel")
    log(f"  device ms per search: the step's kernels ({', '.join(pipe_keys)}) {step_ms:.4f}, "
        f"block_offsets {offs_ms:.4f}, the scan {device_ms(prof, 'scan_bits'):.4f}")
    for line in prof["lines"][:10]:
        log(f"    {line}")
    stages, n_stage = stage_breakdown(torch, tpb, vdp, engine, text, thr)
    require(n_stage == len(got), f"{tag}: stage breakdown found other matches")
    log("  stages (host clock, synchronised, ms per search): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")
    log(f"  phase {tag} {time.perf_counter() - t_phase:.1f} s")
    return SimpleNamespace(text=text, times=times, launches=launches, stats=stats, prof=prof,
                           matches=len(got), stages=stages, step_ms=step_ms, offsets_ms=offs_ms)


def step_times(ctx, tag: str, args, tables: int, window: int, cells: int):
    """Phase 6 for the typed or the list step's kernels on one slice's hits
    (``args``, the arguments of ``dp_pipeline``): CUDA-event ms of each
    wrapper beside its plain version, and its bound from these inputs
    (``tables`` bytes of the DP's tables, ``window`` bytes of the
    candidates' haystack windows, ``cells`` the DP's cells); the instances'
    registers and spill bytes. Returns ({kernel: (ms, plain ms, bound,
    None)}, {kernel: (instance, registers, spill bytes)})."""
    torch, tpb, vdp = ctx.torch, ctx.tpb, ctx.vdp
    pos, words, win, _ids, _limit, _T, _pens, _thr, E, _dead, statics, variant = args
    kind = step_kind(vdp, args)
    k_expand, k_dp, k_emit = STEP_KEYS[kind]
    (dp, dp_plain), (emit, emit_plain) = step_pieces(vdp, args)
    cands = vdp.typed_expand(pos, words, win, E, statics)
    dec, row_counts = dp(cands)
    handed, n_rows, M = step_handoff(row_counts)
    plain_c = vdp.typed_expand_torch(pos, words, win, E, statics)
    plain_d = dp_plain(plain_c)
    n_combo = vdp._combos(E, *statics).shape[1]
    nce, items = dec.shape[0], cands.items
    recs = {
        # One pass: the hits and combos read once, the list and its total
        # written once (the status words are the kernel's scratch).
        k_expand: (
            event_ms(torch, lambda: vdp.typed_expand(pos, words, win, E, statics), 20),
            event_ms(torch, lambda: vdp.typed_expand_torch(pos, words, win, E, statics), 3),
            bound_ms(pos.numel() * 8 + words.numel() * 8 + 20 * n_combo + 12 * M + 4,
                     12 * items, INT_RATE), None),
        k_dp: (
            event_ms(torch, lambda: dp(cands), 20),
            event_ms(torch, lambda: dp_plain(plain_c), 1),
            bound_ms(8 * M + tables + window + 8 * nce * M + 4 * row_counts.numel(),
                     cells * DP_CELL_INSTR, F32_RATE), None),
        k_emit: (
            event_ms(torch, lambda: emit(dec, handed, cands, n_rows, M), 20),
            event_ms(torch, lambda: emit_plain(plain_d[0], handed, plain_c, n_rows, M), 3),
            bound_ms(8 * nce * M + 12 * M + 4 * handed.numel() + 24 * n_rows, nce * M,
                     INT_RATE), None),
    }
    if kind == "list":
        cells_per = (2 * E + 1) * (E + 1)
        G = 8 if cells_per <= 8 else 16 if cells_per <= 16 else 32 if cells_per <= 32 else 0
        maps = int(variant.maps is not None)
        dp_inst = (rf"count_dp_kernelILi{G}ELb{maps}E" if G
                   else rf"count_dp_rows_kernelILi{E}ELb{maps}E")
    else:
        nch = variant.typed.nch
        cells_per = (2 * E + 1) * nch
        if cells_per <= 32:
            dp_inst = rf"typed_dp_kernelILi{8 if cells_per <= 8 else 16 if cells_per <= 16 else 32}E"
        else:
            S, G = (1, 16) if nch <= 16 else (-(-nch // 32), 32)
            dp_inst = rf"typed_dp_rows_kernelILi{E}ELi{S}ELi{G}E"
    regs = {k_dp: ptxas_entry(ctx.kern.log, dp_inst),
            k_emit: ptxas_entry(ctx.kern.log, r"count_emit_kernel"),
            k_expand: ptxas_entry(ctx.kern.log, r"typed_expand_kernel")}
    for name, (ms, plain, (b_ms, b_by), _lib) in recs.items():
        log(f"  {tag} {name}: {items} items, {M} candidates, {n_rows} rows; wrapper {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {b_ms:.4g} ms by {b_by} ({b_ms / ms:.3g} of the time)"
            + (f"; instance {regs[name]}" if regs else ""))
    return recs, regs


def lane_kernel_times(ctx, tag: str, engine, text: str, thr: float):
    """Phase 6 for one lane at its main-path shape (slice 1 of ``text``): the
    scan's three kernels against their plain versions on the lane's own
    tables and slice, ``block_offsets`` against its plain version on every
    count array the step scans and its times there (beside
    ``torch.cumsum``), CUDA-event ms of the step's wrapper and of the DP-only
    kernel beside their plain versions, for a typed or a list step of each
    of the step's kernels too (``step_times``), the bound from these inputs,
    and their agreement there. Returns a namespace: ``pipe`` and ``dp``
    (ms, plain ms, bound) of the step and of the DP-only kernel, ``scan_errs``
    (max_abs_err of scan_bits, block_offsets, hit_words), ``steps``
    {kernel: (ms, plain ms, bound, None)} and ``regs`` {kernel: (instance,
    registers, spill bytes)} (the typed or the list step's) or None, ``offsets`` the
    ``offsets_times`` records, and ``device_ms`` the step's kernels' device
    ms per call of the wrapper (torch.profiler)."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    plan, run = lane_inputs(vdp, engine, text, thr, tag)
    part = run.parts[0]
    _n, scan_errs = compare_scan(
        tpb, torch, part.ids_pf, run.T_scan, run.halo,
        f"{tag} main-path shape, k={plan.k} damerau={plan.dam} halo={run.halo}")
    hits, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    p_args = pipeline_args(vdp, np, plan, run, part, pos, words, thr)
    kind = step_kind(vdp, p_args)
    typed = kind == "typed"
    err_offs, offs_recs = 0, []
    # The list and the typed step hand block_offsets nothing: their
    # emission places its rows from the DP's channel totals.
    for counts in vdp.dp_pipeline_counts(*p_args) if kind == "pipeline" else ():
        err_offs = max(err_offs, int((tpb.block_offsets(counts).long()
                                      - tpb.block_offsets_torch(counts).long()).abs().max()))
        offs_recs.append(offsets_times(tpb, torch, counts, f"{tag}, the count pass's counts"))
    log(f"  {tag}: block_offsets over the step's counts, max_abs_err {err_offs}")
    require(err_offs == 0, f"{tag}: block_offsets disagrees on the step's counts")
    scan_errs = (scan_errs[0], max(scan_errs[1], err_offs), scan_errs[2])
    rows_k, cand_k = vdp.dp_pipeline(*p_args)
    rows_p, cand_p = vdp.dp_pipeline_torch(*p_args)
    _h, cf, cs = vdp.dp_candidates(run, part)
    kernel, plain = dp_only(vdp, run, cf, cs, part.ids_de, part.local_n, plan.E)
    pen_k, cnt_k = kernel()
    pen_p, cnt_p = plain()
    torch.cuda.synchronize()
    require(torch.equal(rows_k, rows_p) and cand_k == cand_p == cf.numel(),
            f"{tag}: the pipeline's kernels disagree at main-path shapes")
    require(torch.equal(pen_k.view(torch.int32), pen_p.view(torch.int32))
            and (cnt_k is None or torch.equal(cnt_k, cnt_p)),
            f"{tag}: the DP-only kernel disagrees at main-path shapes")
    B = 2 * plan.E + 1
    chans = run.variant.typed.nch if typed else plan.E + 1
    cells = int(run.T.depth[cf.long()].sum()) * B * chans
    tables = sum(t.numel() * t.element_size() for t in (
        run.T.path_cls, run.T.path_node, run.T.depth, run.T.sim, run.T.node_ceil))
    window = cf.numel() * (run.T.Lmax + 2 * plan.E + 2)
    pipe_bound = bound_ms(pos.numel() * 8 + words.numel() * 8 + tables + window
                          + rows_k.numel() * 4, cells * DP_CELL_INSTR, F32_RATE)
    dp_bound = bound_ms(cf.numel() * 8 + tables + window
                        + pen_k.numel() * (4 if cnt_k is None else 8),
                        cells * DP_CELL_INSTR, F32_RATE)
    step_recs = regs = None
    emit_err = emit_edge_checks(ctx, tag, p_args) if kind != "pipeline" else 0
    if kind != "pipeline":
        step_recs, regs = step_times(ctx, tag, p_args, tables, window, cells)
    pipe_ms = event_ms(torch, lambda: vdp.dp_pipeline(*p_args), 10)
    pipe_plain_ms = event_ms(torch, lambda: vdp.dp_pipeline_torch(*p_args), 1)
    dp_ms = event_ms(torch, kernel, 10)
    dp_plain_ms = event_ms(torch, plain, 1)
    prof = profile_search(torch, lambda: vdp.dp_pipeline(*p_args), 20, tpb.LAUNCHES)
    keys = STEP_KEYS[kind]
    dev_ms = {k: device_ms(prof, KERNEL_OF.get(k, k)) for k in keys}
    dev_ms["block_offsets"] = device_ms(prof, "block_offsets_kernel")
    counted = ", ".join(f"{k} {prof['counted'][k]} launches counted, "
                        f"{event_count(prof, KERNEL_OF.get(k, k))} events" for k in keys)
    log(f"  {tag} slice 1 of {len(run.parts)} ({variant_name(run)}, E={plan.E}, k={plan.k}): "
        f"{hits} hits x {plan.n_combo} combos, {cand_k} candidates, {rows_k.shape[0]} rows; "
        f"step wrapper {pipe_ms:.4f} ms, device ms per call "
        + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items())
        + f" ({counted}), plain {pipe_plain_ms:.4f} ms, bound {pipe_bound[0]:.4f} ms by {pipe_bound[1]}; "
        f"DP-only kernel {dp_ms:.4f} ms, plain {dp_plain_ms:.4f} ms, bound {dp_bound[0]:.4f} ms "
        f"by {dp_bound[1]}; max_abs_err 0 both")
    return SimpleNamespace(pipe=(pipe_ms, pipe_plain_ms, pipe_bound),
                           dp=(dp_ms, dp_plain_ms, dp_bound), scan_errs=scan_errs,
                           steps=step_recs, regs=regs, emit_err=emit_err,
                           offsets=offs_recs, device_ms=dev_ms, prof_counted=prof["counted"])


def wide_tables(tpb, W: int, k: int, damerau: bool, A: int, seed: int, device, length=(6, 15)):
    """Scan tables of exactly ``W`` limbs over an alphabet of ``A`` symbols:
    random words (symbol lists of ``length`` symbols, a half-open range)
    packed first-fit until the next one would open limb W. Returns (tables,
    words, halo)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = []
    while True:
        w = rng.integers(1, A, size=int(rng.integers(*length))).tolist()
        offs = tpb._pack_fields([len(x) for x in words + [w]])
        if max(lw for lw, _ in offs) + 1 > W:
            break
        words.append(w)
    ms = [len(w) for w in words]
    offs = tpb._pack_fields(ms)
    require(max(lw for lw, _ in offs) + 1 == W, f"wide tables of {W} limbs")
    limb = np.zeros((A, W), np.uint64)
    for w, (lw, lo) in zip(words, offs):
        for i, c in enumerate(w):
            limb[c, lw] |= np.uint64(1) << np.uint64(lo + i)
    match, init, kk = tpb.fuzzy_masks(offs, ms, W, [k] * len(words))
    notlast = tpb.notlast_mask(offs, ms, W) if damerau else None
    T = tpb.tables_from_numpy(tpb._word_table(limb, A, W), tpb._starts_mask(offs, W), match,
                              init, notlast, device=device)
    return T, words, max(ms) + kk


def wide_stream(words, A: int, n: int, seed: int, k: int):
    """``n`` random symbols of ``A`` (symbol 0, the dead one, included) with
    words of ``words`` written over them at 1 position in 40, each with up to
    ``k`` substitutions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, A, size=n).astype(np.uint8)
    for at in rng.integers(0, n - max(16, max(map(len, words))), size=n // 40).tolist():
        w = list(words[int(rng.integers(len(words)))])
        for _ in range(int(rng.integers(0, k + 1))):
            w[int(rng.integers(len(w)))] = int(rng.integers(1, A))
        ids[at:at + len(w)] = w
    return ids


#: Widths at each edge of the k = 0 instance table (8 lanes of ceil(W / 8)
#: limbs, ``packed_bitap.wide_scan_instance``), the exact-wide dictionary's
#: 43 and the many1k folded chunk's 31.
WIDE_K0_WIDTHS = (9, 16, 17, 24, 25, 31, 32, 33, 40, 41, 43, 48, 49, 56, 57, 64)


def wide_kernel_checks(ctx) -> dict:
    """Phase 3 for the wide scan's kernels: the library's instance table
    (``fac_scan_wide_instance``) against ``wide_scan_instance`` at every W
    and k; then the kernels bit for bit against their plain versions
    (``compare_scan``) on streams of 50,013 symbols: at k = 0 every width of
    ``WIDE_K0_WIDTHS`` at alphabets of 27 and 128 symbols; at k = 1 and 2
    with and without the Damerau rows, k = 4 with them and k = 6 without, at
    W = 9, 31, 32 and 64; a stream whose first tile holds over 300 hits, at
    k = 0 (W = 43) and k = 1 Damerau (W = 31); and a stream without a hit.
    Returns {kernel: max_abs_err}."""
    torch, np, tpb = ctx.torch, ctx.np, ctx.tpb
    errs = dict.fromkeys(("scan_bits_wide", "block_offsets", "hit_words_wide"), 0)
    lib = ctx.kern.lib
    for W in range(tpb.MAX_LIMBS + 1, tpb.MAX_SCAN_LIMBS + 1):
        for k in range(tpb.MAX_K + 1):
            lpl, g = tpb.wide_scan_instance(W, k)
            require(lib.fac_scan_wide_instance(W, k) == lpl * 256 + g,
                    f"W={W} k={k}: the library's instance {lib.fac_scan_wide_instance(W, k)} "
                    f"is not wide_scan_instance's ({lpl}, {g})")
    log(f"  the wide scan's instance at W = {tpb.MAX_LIMBS + 1}..{tpb.MAX_SCAN_LIMBS}, k = "
        f"0..{tpb.MAX_K}: the library's equals wide_scan_instance's")

    def case(W, A, k, dam, n=50013, dense=0, want_hits=True, ids=None):
        T, words, halo = wide_tables(tpb, W, k, dam, A, SEED + W + k, ctx.dev)
        if ids is None:
            ids = wide_stream(words, A, n, SEED + W * (k + 1), k)
            rng = np.random.default_rng(SEED + W)
            for at in range(0, dense, 40):  # a word every 40 symbols of the first tile
                w = words[int(rng.integers(len(words)))]
                ids[at:at + len(w)] = w
        what = f"wide W={W} A={A} k={k} {'Damerau' if dam else 'plain'}" + (
            f", {dense} symbols dense" if dense else "") + ("" if want_hits else ", no hit")
        ids = torch.from_numpy(ids).to(ctx.dev)
        count, e = compare_scan(tpb, torch, ids, T, halo, what, want_hits=want_hits)
        if dense:
            bits, _c = tpb.scan_bits_torch(ids, T, halo)
            first = int(sum(bin(int(x) & 0xFFFFFFFF).count("1")
                            for x in bits[: tpb.SCAN_BLOCK_SYMS // 32].tolist()))
            require(first > 300, f"{what}: {first} hits in the first tile")
        require(count == 0 or want_hits, f"{what}: {count} hits")
        for key, err in zip(("scan_bits_wide", "block_offsets", "hit_words_wide"), e):
            errs[key] = max(errs[key], err)

    for W in WIDE_K0_WIDTHS:
        for A in (27, 128):
            case(W, A, 0, False)
    for W, A in ((9, 128), (31, 27), (32, 27), (64, 128)):
        for k, dam in ((1, True), (1, False), (2, False), (2, True), (4, True), (6, False)):
            case(W, A, k, dam)
    case(43, 27, 0, False, dense=tpb.SCAN_BLOCK_SYMS)
    case(31, 27, 1, True, dense=tpb.SCAN_BLOCK_SYMS)
    case(43, 27, 0, False, want_hits=False, ids=np.zeros(50013, np.uint8))
    return errs


#: Phase 3's grid of the wide kernels past the one-thread chains' six rows:
#: k on both sides of the K = 12 / 24 row templates, W at each lane count
#: (1, 8, 16 and 32 lanes of one limb, 32 lanes of two).
DEEP_KS = (7, 8, 12, 13, 24)
DEEP_WIDTHS = (1, 8, 9, 31, 64)


def deep_kernel_checks(ctx) -> dict:
    """Phase 3 for the wide kernels at k = 7..24 (the deep instances): the
    library's instance table against ``wide_scan_instance`` at W = 1..64, k =
    7..24; then ``compare_scan`` (the scan, the offsets and the replay bit
    for bit against their plain versions) on streams of 20,013 symbols of an
    alphabet of 128 with the dictionary's words planted, each with up to k
    substitutions: every k of ``DEEP_KS`` at every W of ``DEEP_WIDTHS``,
    with the Damerau rows where the two indices' sum is odd (so that each
    row template runs both ways at every lane count: the K = 12 template
    takes three k, the K = 24 one two); W = 2 and 4 (the other lane counts)
    at k = 8; W = 33 (two limbs a lane) at k = 13 and 24, both ways; a
    stream without a hit at W = 64, k = 24 with the Damerau rows; streams
    of 2^18 symbols at W = 33, k = 24 with the Damerau rows and at W = 64,
    k = 17 without (the K = 24 and two-limb instances at a size a search
    hands them); and a segment of a stream with halos on both sides, its
    view unaligned, at k = 8 and 13 (the streamed anchors' form). Words are
    k + 8 to k + 24 symbols long, so that a hit is not every position.
    Returns {kernel: max_abs_err} under the deep instances' names."""
    torch, np, tpb = ctx.torch, ctx.np, ctx.tpb
    names = ("scan_bits_wide[k=7..24]", "block_offsets", "hit_words_wide[k=7..24]")
    errs = dict.fromkeys(names, 0)
    lib = ctx.kern.lib
    for W in range(1, tpb.MAX_SCAN_LIMBS + 1):
        for k in range(tpb.MAX_K + 1, tpb.MAX_SCAN_K + 1):
            lpl, g = tpb.wide_scan_instance(W, k)
            require(lib.fac_scan_wide_instance(W, k) == lpl * 256 + g,
                    f"W={W} k={k}: the library's instance {lib.fac_scan_wide_instance(W, k)} "
                    f"is not wide_scan_instance's ({lpl}, {g})")
        for k in range(tpb.MAX_K + 1):
            require((lib.fac_scan_wide_instance(W, k) < 0) == (W <= tpb.MAX_LIMBS),
                    f"W={W} k={k}: the library's instance table has the wrong edge")
    log(f"  the wide scan's instance at W = 1..{tpb.MAX_SCAN_LIMBS}, k = {tpb.MAX_K + 1}.."
        f"{tpb.MAX_SCAN_K}: the library's equals wide_scan_instance's")

    def case(W, k, dam, A=128, n=20013, want_hits=True, zeros=False, segment=False):
        t0 = time.perf_counter()
        T, words, halo = wide_tables(tpb, W, k, dam, A, SEED + 3 * W + k, ctx.dev,
                                     length=(k + 8, min(k + 25, 65)))
        ids = (np.zeros(n, np.uint8) if zeros
               else wide_stream(words, A, n, SEED + W * (k + 1) + dam, k))
        ids = torch.from_numpy(ids).to(ctx.dev)
        what = f"deep W={W} k={k} {'Damerau' if dam else 'plain'}"
        if segment:  # 15,001 symbols with halos on both sides, from an odd offset
            ids = ids[1001 - halo: 16002 + halo]
            what += f", a segment with {halo}-symbol halos, unaligned"
        count, e = compare_scan(tpb, torch, ids, T, halo, what + ("" if want_hits else ", no hit"),
                                want_hits=want_hits)
        require(count == 0 or want_hits, f"{what}: {count} hits")
        require(count < ids.numel(), f"{what}: every position hits")
        for key, err in zip(names, e):
            errs[key] = max(errs[key], err)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    for i, k in enumerate(DEEP_KS):
        for j, W in enumerate(DEEP_WIDTHS):
            case(W, k, (i + j) % 2 == 1)
    for W in (2, 4):
        case(W, 8, False)
    for k in (13, 24):
        for dam in (False, True):
            case(33, k, dam)
    case(64, 24, True, want_hits=False, zeros=True)
    case(33, 24, True, n=1 << 18)
    case(64, 17, False, n=1 << 18)
    case(1, 8, False, segment=True)
    case(9, 13, True, segment=True)
    log(f"  the deep instances' checks {time.perf_counter() - t0:.1f} s")
    return errs


def many_kernel_checks(ctx, many_text: str):
    """Phase 3 for the large-dictionary lane, bit for bit against the plain
    versions: the wide scan's kernels (``wide_kernel_checks``); and per chunk of
    the folded and the plain layout, over 1 MiB of the many1k corpus, over a
    text of 3-letter words (rows shallower than the containment test's 4
    classes), over filler only (hits, no candidate) and, with the first 300
    many1k words at ``edits(2)``, over the same 1 MiB, ``many_step`` with and
    without the containment test and the whole chunk (``many_pipeline``),
    and on the first chunk the step over hit ranges
    (``compare_many_ranges``). Returns {kernel: max_abs_err}, as measured."""
    np, many = ctx.np, ctx.many
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    errs = dict.fromkeys(("scan_bits_wide", "block_offsets", "hit_words_wide", "many_step"), 0)
    errs.update(wide_kernel_checks(ctx))

    short = many_words(600, SEED + 11, length=(3, 4))
    short_text = " ".join(w if i % 3 else w[:1] + "q" + w[2:]
                          for i, w in enumerate(short[int(j)] for j in
                                                np.random.default_rng(SEED).integers(
                                                    len(short), size=8000)))
    many_e = recipe_engine(ctx, "many1k")
    e2 = make_engine(ctx, many_words(1000, 7)[:300], ctx.Limits.new().edits(2))
    cases = (("many1k, 1 MiB", many_e, many_text[: 1 << 20], MANY_THRESHOLD),
             ("3-letter words", make_engine(ctx, short, ctx.Limits.new().edits(1)), short_text,
              0.6),
             ("many1k, filler only", many_e, "lorem ipsum dolor " * 20000, MANY_THRESHOLD),
             ("300 many1k words, edits(2), 1 MiB", e2, many_text[: 1 << 20], 0.75))
    ranges_done = False
    for what, eng, text, thr in cases:
        for fold in (True, False):
            spec = many.many_spec_of(eng, fold=fold)
            if spec is None:
                log(f"  {what}: no {'folded' if fold else 'plain'} layout")
                continue
            view = view_of(text, True)
            n = len(view)
            run = many.many_inputs(eng, spec, text, thr, view, n)
            if what.startswith("300"):
                require(run.E == 2, f"{what}: E = {run.E}")
            for ci, chunk in enumerate(run.chunks):
                e = compare_many_chunk(ctx, run, chunk, n, thr,
                                       f"{what}, {'folded' if fold else 'plain'} chunk {ci + 1} of "
                                       f"{len(run.chunks)}", no_containment=True)
                errs["many_step"] = max(errs["many_step"], e)
                if not ranges_done:
                    errs["many_step"] = max(errs["many_step"], compare_many_ranges(
                        ctx, run, chunk, n, thr, f"{what}, {'folded' if fold else 'plain'}"))
                    ranges_done = True
    return errs


def int_err(a, b) -> float:
    """max_abs_err of two integer tensors (or ints); inf where the shapes
    differ."""
    if isinstance(a, int):
        return float(abs(a - b))
    if a.shape != b.shape:
        return float("inf")
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def compare_many_chunk(ctx, run, chunk, n: int, thr: float, what: str,
                       no_containment=False) -> float:
    """``many_step`` and the whole chunk (``many_pipeline``) against their
    plain versions on one chunk of the many lane's ``run``, bit for bit
    (rows, pairs, candidates); ``no_containment`` also runs the step without
    the containment test. Returns the max_abs_err."""
    torch, np, tpb, vdp, many = ctx.torch, ctx.np, ctx.tpb, ctx.vdp, ctx.many
    hits, pos, words = tpb.packed_hits(run.ids_pf, chunk.T_scan, run.halo)
    args = (vdp.DpWindow(0, n, n), run.ids_de, n, run.T, run.pens, np.float32(thr), run.E,
            run.deadend, chunk.X, run.k)
    err, counts = 0.0, []
    for contain in ((True, False) if no_containment else (True,)):
        got = many.many_step(pos, words, *args, contain=contain)
        want = many.many_step_torch(pos, words, *args, contain=contain)
        torch.cuda.synchronize()
        err = max([err] + [int_err(g, w) for g, w in zip(got, want)])
        counts.append((want[1], want[2], want[0].shape[0]))
    # The whole chunk, past the folded layout's hit ceiling too.
    step_args = (run.ids_pf, run.ids_de, n, chunk, run.halo, run.T, run.pens, np.float32(thr),
                 run.E, run.deadend, None)
    step_k, step_p = many.many_pipeline(*step_args), many.many_pipeline_torch(*step_args)
    torch.cuda.synchronize()
    err_step = max(int_err(g, w) for g, w in zip(step_k, step_p))
    log(f"  {what}: W={chunk.T_scan.W} R={chunk.X.R} rd={chunk.X.rd_min}..{chunk.X.rd_max} "
        f"E={run.E} k={run.k} damerau={run.dam} deadend={run.deadend} hits={hits}; many_step "
        f"(pairs, candidates, rows) with the containment test {counts[0]}"
        + (f", without {counts[1]}" if no_containment else "")
        + f", max_abs_err {err}; many_pipeline {tuple(step_p[1:])} with "
        f"{step_p.rows.shape[0]} rows, max_abs_err {err_step}")
    require(err == 0.0, f"{what}: many_step disagrees with many_step_torch")
    require(err_step == 0.0, f"{what}: many_pipeline disagrees with many_pipeline_torch")
    return max(err, err_step)


def compare_many_ranges(ctx, run, chunk, n: int, thr: float, what: str) -> float:
    """The chunk step over ranges of its hit list (the form it takes past
    ``many_max_hits``): ``many_step`` over the second half of the hits,
    handed its preceding hit (h0 = 1), against its plain version bit for bit;
    both halves' rows together against one call's, as multisets, and their
    pairs and candidates summed; and ``many_pipeline`` in ranges of a third
    of the hits against its plain version in the same ranges (bit for bit)
    and against itself in one range (counts equal, rows as multisets).
    Returns the max_abs_err."""
    torch, np, tpb, vdp, many = ctx.torch, ctx.np, ctx.tpb, ctx.vdp, ctx.many
    hits, pos, words = tpb.packed_hits(run.ids_pf, chunk.T_scan, run.halo)
    require(hits >= 6, f"{what}: too few hits to cut into ranges")
    a = hits // 2
    args = (vdp.DpWindow(0, n, n), run.ids_de, n, run.T, run.pens, np.float32(thr), run.E,
            run.deadend, chunk.X, run.k)
    got = many.many_step(pos[a - 1:], words[a - 1:], *args, 1)
    want = many.many_step_torch(pos[a - 1:], words[a - 1:], *args, 1)
    first = many.many_step(pos[:a], words[:a], *args)
    whole = many.many_step(pos, words, *args)
    torch.cuda.synchronize()
    err = max(int_err(g, w) for g, w in zip(got, want))
    rows_of = lambda r: sorted(map(tuple, r.tolist()))
    halves_equal = (rows_of(torch.cat((first[0], got[0]))) == rows_of(whole[0])
                    and (first[1] + got[1], first[2] + got[2]) == whole[1:])
    step_args = (run.ids_pf, run.ids_de, n, chunk, run.halo, run.T, run.pens, np.float32(thr),
                 run.E, run.deadend, run.hit_ceil)
    one = many.many_pipeline(*step_args)
    saved = many.many_max_hits
    many.many_max_hits = lambda X, E, nch: -(-hits // 3)
    try:
        step_k, step_p = many.many_pipeline(*step_args), many.many_pipeline_torch(*step_args)
    finally:
        many.many_max_hits = saved
    torch.cuda.synchronize()
    err_step = max(int_err(g, w) for g, w in zip(step_k, step_p))
    log(f"  {what}, hit ranges: many_step over hits {a}..{hits - 1} with hit {a - 1} before "
        f"them (h0 = 1): {tuple(want[1:])} (pairs, candidates), {want[0].shape[0]} rows, "
        f"max_abs_err {err}; the halves' rows and counts {'equal' if halves_equal else 'unequal'} "
        f"to one call's; many_pipeline in 3 ranges {tuple(step_k[1:])}, max_abs_err {err_step} "
        f"against its plain version, in one range {tuple(one[1:])}")
    require(err == 0.0, f"{what}: many_step over a hit range disagrees with its plain version")
    require(halves_equal, f"{what}: the hit ranges' rows differ from one call's")
    require(err_step == 0.0, f"{what}: many_pipeline in ranges disagrees with its plain version")
    require(tuple(step_k[1:]) == tuple(one[1:]) and rows_of(step_k.rows) == rows_of(one.rows),
            f"{what}: many_pipeline in ranges differs from one range")
    return max(err, err_step)


def many_stage_breakdown(ctx, engine, text: str, thr: float, fold: bool):
    """Host-clock ms of each stage of one many1k search, each ended by a
    synchronise, and per chunk its (hits, pairs, candidates, rows)."""
    torch, np, tpb, many = ctx.torch, ctx.np, ctx.tpb, ctx.many
    from fuzzy_aho_corasick_tpu_torch.ops.emit import decode_matches
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    ms = dict.fromkeys(("view, spec, inputs", "packed_hits", "many_step", "rows to host",
                        "decode"), 0.0)

    def lap(name, t0):
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    torch.cuda.synchronize()
    t = time.perf_counter()
    view = view_of(text, engine.case_insensitive)
    n = len(view)
    run = many.many_inputs(engine, many.many_spec_of(engine, fold=fold), text, thr, view, n)
    t = lap("view, spec, inputs", t)
    rows, per_chunk = [], []
    from fuzzy_aho_corasick_tpu_torch.ops.verify_dp import DpWindow

    for chunk in run.chunks:
        hits, pos, words = tpb.packed_hits(run.ids_pf, chunk.T_scan, run.halo, run.hit_ceil)
        t = lap("packed_hits", t)
        r, pairs, cands = many.many_step(pos, words, DpWindow(0, n, n), run.ids_de, n, run.T,
                                         run.pens, np.float32(thr), run.E, run.deadend, chunk.X,
                                         run.k)
        t = lap("many_step", t)
        rows.append(r.cpu().numpy())
        t = lap("rows to host", t)
        per_chunk.append((hits, pairs, cands, len(rows[-1])))
    r = np.concatenate(rows)
    out = decode_matches(engine, view, text, n, r[:, 0], r[:, 2], r[:, 3],
                         np.ascontiguousarray(r[:, 1]).view(np.float32), r[:, 4], np.float32(thr))
    lap("decode", t)
    return ms, len(out), per_chunk


def many_main_path(ctx, tag: str, engine, text: str, thr: float, fold: bool, locked, want):
    """Phase 4f: the many1k search through ``search_raw`` over ``text``, with
    the folded layout (``fold``) or the plain chunking (the lane's fold
    switch off): a probe on 1 MiB, one first search, one warm-up and three
    timed ones with the plain versions and the oracle locked out; the launch
    counters; the match set against the context oracle's ``want``; the
    profiler's launches, copies and waits per search; the stages."""
    torch, tpb, many = ctx.torch, ctx.tpb, ctx.many
    t_phase = time.perf_counter()
    saved = many.FOLD
    many.FOLD = fold
    keys = ("scan_bits_wide", "block_offsets", "hit_words_wide", "many_step")
    try:
        with plain_locked((ctx.oracle, "search_raw")):
            engine.search_raw(text[: 1 << 20], thr)
        for key in tpb.LAUNCHES:
            tpb.LAUNCHES[key] = 0
        with plain_locked(*locked):
            t0 = time.perf_counter()
            engine.search_raw(text, thr)
            first = time.perf_counter() - t0
            engine.search_raw(text, thr)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = engine.search_raw(text, thr)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        launches = dict(tpb.LAUNCHES)
        stats = dict(engine.last_stats)
        best = min(times)
        log(f"  {len(text)} bytes, first search {first:.3f} s, best of 3 {best * 1e3:.3f} ms "
            f"(all {', '.join(f'{t * 1e3:.3f}' for t in times)}) = "
            f"{len(text) / best / 1e9:.3f} GB/s, {len(got)} matches, launches {launches}")
        log(f"  last_stats {stats}")
        require(stats["backend"] == "device-fuzzy-many" and stats["folded"] == fold,
                f"{tag}: backend {stats['backend']} folded {stats['folded']}")
        require(all(launches[k] > 0 for k in keys), f"{tag}: the lane did not launch its kernels")
        require(all(v == 0 for k, v in launches.items() if k not in keys),
                f"{tag}: the lane launched a kernel of another lane")
        dev_set = {match_key(m) for m in got}
        require(len(dev_set) == len(got), f"{tag}: the lane repeats a match")
        log(f"  equal to the context oracle's {len(want)} matches: {dev_set == want}")
        require(dev_set == want, f"{tag}: the lane disagrees with the context oracle")
        prof = profile_search(torch, lambda: engine.search_raw(text, thr), 3, tpb.LAUNCHES)
        log(f"  torch.profiler over 3 searches: wall {prof['wall']:.3f} ms per search, device "
            f"busy {prof['busy']:.3f} ms ({prof['busy'] / prof['wall']:.3f} of wall); per search "
            f"{prof['kernels']:.1f} kernel launches, {prof['copies']:.1f} copies, "
            f"{prof['waits']:.1f} host waits over {stats['chunks']} chunks")
        for line in prof["lines"][:8]:
            log(f"    {line}")
        stages, n_stage, per_chunk = many_stage_breakdown(ctx, engine, text, thr, fold)
        require(n_stage == len(got), f"{tag}: stage breakdown found other matches")
        log("  stages (host clock, synchronised, ms per search): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f"; sum {sum(stages.values()):.3f}")
        log("  per chunk (hits, pairs, candidates, rows): "
            + ", ".join(str(c) for c in per_chunk))
    finally:
        many.FOLD = saved
    log(f"  phase {tag} {time.perf_counter() - t_phase:.1f} s")
    return SimpleNamespace(times=times, launches=launches, stats=stats, prof=prof,
                           matches=len(got), stages=stages, per_chunk=per_chunk)


def make_exact(ctx, words):
    """An exact (edits = 0), case-insensitive engine on the card."""
    eng = ctx.Builder.new().case_insensitive(True).device(ctx.dev).build(words)
    eng.backend = "device"
    return eng


def find_pairs(low: str, pairs):
    """Every (pattern, start, end) of the (pattern, word) ``pairs`` in
    ``low``, overlapping, by ``str.find``."""
    want = set()
    for pi, w in pairs:
        at = low.find(w)
        while at >= 0:
            want.add((pi, at, at + len(w)))
            at = low.find(w, at + 1)
    return want


def find_set(text: str, words, pool=None, workers: int = 1):
    """Every (pattern, start, end) of ``words`` in the lowercased ASCII
    ``text``, overlapping, by ``str.find``; with a ``pool``, the words
    dealt out to its ``workers`` processes."""
    low, pairs = text.lower(), list(enumerate(words))
    if pool is None:
        return find_pairs(low, pairs)
    return set().union(*pool.starmap(find_pairs, [(low, pairs[i::workers])
                                                  for i in range(workers)]))


def exact_main_path(ctx, tag: str, engine, words, text: str, backend: str, locked, keys):
    """Phases exact-wide and exact1k: the exact engine over ``text`` through
    ``search_raw`` at threshold 0.5, one first search, one warm-up and three
    timed ones with the plain versions and the oracle locked out; the launch
    counters (``keys`` must run, no other kernel); the match set against the
    independent ``str.find`` set, and against the oracle on 32 KiB with
    planted words; the profiler's launches, copies and waits per search."""
    torch, tpb = ctx.torch, ctx.tpb
    t_phase = time.perf_counter()
    for key in tpb.LAUNCHES:
        tpb.LAUNCHES[key] = 0
    with plain_locked(*locked):
        t0 = time.perf_counter()
        engine.search_raw(text, 0.5)
        first = time.perf_counter() - t0
        engine.search_raw(text, 0.5)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = engine.search_raw(text, 0.5)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = dict(tpb.LAUNCHES)
    stats = dict(engine.last_stats)
    best = min(times)
    log(f"  {len(text)} bytes, first search {first:.3f} s (transcode + upload), best of 3 "
        f"{best * 1e3:.3f} ms (all {', '.join(f'{t * 1e3:.3f}' for t in times)}) = "
        f"{len(text) / best / 1e9:.3f} GB/s, {len(got)} matches, launches {launches}")
    log(f"  last_stats {stats}")
    require(stats["backend"] == backend, f"{tag}: backend {stats['backend']}, expected {backend}")
    require(all(launches[k] > 0 for k in keys), f"{tag}: the search did not launch {keys}")
    require(all(v == 0 for k, v in launches.items() if k not in keys),
            f"{tag}: the search launched a kernel of another lane")
    dev_set = {(m.pattern_index, m.start, m.end) for m in got}
    require(all(m.similarity == 1.0 and m.edits == 0 for m in got),
            f"{tag}: exact matches carry weight 1.0")
    t0 = time.perf_counter()
    want = find_set(text, words, ctx.pool, ctx.workers)
    log(f"  independent str.find count {len(want)} ({time.perf_counter() - t0:.1f} s); equal: "
        f"{dev_set == want}")
    require(len(got) == len(dev_set) and dev_set == want, f"{tag}: disagrees with str.find")
    require(len(want) > 1000, f"{tag}: too few matches to be a real check")
    small = plant_words(text[: 32 << 10], SEED + 12, 300, words)
    dev_r = sorted(map(match_key, engine.search_raw(small, 0.5)))
    require(engine.last_stats["backend"] == backend, f"{tag}: 32 KiB backend")
    engine.backend = "oracle"
    ora_r = sorted(map(match_key, engine.search_raw(small, 0.5)))
    engine.backend = "device"
    log(f"  32 KiB with 300 planted words, device vs oracle: {len(dev_r)} vs {len(ora_r)} "
        f"matches, equal {dev_r == ora_r}")
    require(dev_r == ora_r and len(dev_r) > 100, f"{tag}: disagrees with the oracle")
    prof = profile_search(torch, lambda: engine.search_raw(text, 0.5), 3, tpb.LAUNCHES)
    log(f"  torch.profiler over 3 searches: wall {prof['wall']:.3f} ms per search, device busy "
        f"{prof['busy']:.3f} ms ({prof['busy'] / prof['wall']:.3f} of wall); per search "
        f"{prof['kernels']:.1f} kernel launches, {prof['copies']:.1f} copies, "
        f"{prof['waits']:.1f} host waits")
    for line in prof["lines"][:8]:
        log(f"    {line}")
    log(f"  phase {tag} {time.perf_counter() - t_phase:.1f} s")
    return SimpleNamespace(times=times, launches=launches, stats=stats, prof=prof,
                           matches=len(got))


def walk_inputs(ctx, engine, text: str):
    """The goto walk's call ``(args, kw)`` for the exact search of ``text``
    by ``engine``, as ``exact_search_walk`` makes it: ``args = (ids, n, n,
    goto, emits, L)`` with the resident class stream (u8, or int32 past 256
    classes) and the threshold 0.5's tables, ``kw`` the folded table."""
    np, tpb = ctx.np, ctx.tpb
    from fuzzy_aho_corasick_tpu_torch.ops import exact
    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    dense = engine.dense
    dtype = np.uint8 if dense.num_classes <= 256 else np.int32
    ids, n = device_corpus.resident(
        text, ("dense", tpb._space_token(engine)),
        lambda h: np.ascontiguousarray(dense.transcode(h, view_of(h, engine.case_insensitive)),
                                       dtype=dtype),
        ctx.dev)
    goto, emits, folded = exact.walk_tables(engine, 0.5, ctx.dev)
    return (ids, n, n, goto, emits, max(dense.max_depth, 1)), {"folded": folded}


def compare_walk(ctx, call, what: str) -> float:
    """The goto walk's kernel pair (``exact.goto_walk`` on the card) against
    its plain version on the same call ``(args, kw)``: the arrivals and the
    alive counts bit for bit. Returns the max_abs_err of the arrivals."""
    from fuzzy_aho_corasick_tpu_torch.ops import exact

    torch = ctx.torch
    args, kw = call
    ids, n_starts, n_read, goto, emits, L = args
    found, alive = exact.goto_walk(*args, **kw)
    torch.cuda.synchronize()
    p_found, p_alive = exact.goto_walk_torch(*args)
    err = int_err(found, p_found)
    per_tile = (torch.bincount(found[0] // exact.WALK_TILE).max().item() if found.shape[1]
                else 0)
    log(f"  goto_walk vs plain, {what}: {n_starts} starts, {n_read} symbols read "
        f"({str(ids.dtype).replace('torch.', '')}), {goto.shape[0]} nodes x {goto.shape[1]} "
        f"classes, L {L}: {found.shape[1]} arrivals (at most {per_tile} a tile), alive per "
        f"span {alive[:12]}{f' .. ({len(alive)} spans)' if len(alive) > 12 else ''}; "
        f"max_abs_err {err}, alive equal {alive == p_alive}")
    require(err == 0 and alive == p_alive, f"goto_walk differs from its plain version: {what}")
    require(found.shape[1] > 0, f"goto_walk, {what}: no arrival, not a real check")
    return err


def captured_walks(exact, run) -> list:
    """The calls ``(args, kw)`` of every ``exact.goto_walk`` that ``run()``
    makes."""
    calls, walk = [], exact.goto_walk

    def spy(*args, **kw):
        calls.append((args, kw))
        return walk(*args, **kw)

    exact.goto_walk = spy
    try:
        run()
    finally:
        exact.goto_walk = walk
    return calls


def walk_kernel_checks(ctx, engine, text: str, cjk_text: str) -> float:
    """Phase 4h: the goto walk's kernels against their plain version on
    exact1k's corpus and table (and on all but its last 1,000 starts, so
    that a persistent block's last tile ends mid-tile), on a dictionary
    past 256 classes (int32 ids: the distinct words of the first 64 Ki
    characters of ``cjk_text`` and 300 CJK words, over its first 1 Mi
    characters), on the unmasked table of the seed filter's exact pass
    (``exact_scan_hits`` of ``engine``), on the kept rows' edge (a tile
    with exactly ``WALK_KEEP`` arrivals and one with one more:
    ``exact.keep_edge_text``), and on walks past 256 spans and past the
    symbols a block stages. The Python mirrors of the kernels' tile, kept
    rows and pair-table classes equal the library's."""
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build, exact

    lib = _cuda_build.load().lib
    mirrors = ((exact.WALK_TILE, lib.fac_goto_walk_tile()),
               (exact.WALK_KEEP, lib.fac_goto_walk_keep()),
               (exact.WALK_PAIR_MAX, lib.fac_goto_walk_pair_max()))
    require(all(a == b for a, b in mirrors), f"goto walk constants: mirrors {mirrors}")
    call = walk_inputs(ctx, engine, text)
    err = compare_walk(ctx, call, "exact1k's corpus and table")
    args, kw = call
    short = (args[0], args[1] - 1000) + args[2:]
    require(short[1] % exact.WALK_TILE != 0, "exact1k's short walk ends on a tile's edge")
    err = max(err, compare_walk(ctx, (short, kw), "exact1k, all but the last 1,000 starts"))
    words = sorted(set(cjk_text[: 1 << 16].split(" ")) - {""}) + cjk_words(300, SEED + 23, (2, 5))
    wide = make_exact(ctx, words)
    require(wide.dense.num_classes > 256, f"{wide.dense.num_classes} classes, not past 256")
    call = walk_inputs(ctx, wide, cjk_text[: 1 << 20])
    require(call[0][0].dtype == ctx.torch.int32, "the dictionary past 256 classes: not int32 ids")
    err = max(err, compare_walk(ctx, call, f"{len(words)} CJK words, {wide.dense.num_classes} "
                                           "classes"))
    calls = captured_walks(exact, lambda: exact.exact_scan_hits(engine, text))
    require(len(calls) == 1, f"exact_scan_hits walked {len(calls)} times")
    err = max(err, compare_walk(ctx, calls[0], "exact_scan_hits' unmasked goto-all table"))
    patterns, edge_text = exact.keep_edge_text()
    call = walk_inputs(ctx, make_exact(ctx, patterns), edge_text)
    found, _alive = exact.goto_walk(*call[0], **call[1])
    per_tile = ctx.torch.bincount(found[0] // exact.WALK_TILE, minlength=3).tolist()
    require(per_tile == [exact.WALK_KEEP, exact.WALK_KEEP + 1, 0],
            f"the kept rows' edge input: arrivals per tile {per_tile}")
    err = max(err, compare_walk(ctx, call, f"tiles of {exact.WALK_KEEP} and "
                                           f"{exact.WALK_KEEP + 1} arrivals"))
    # Walks deeper than the spans the kernel counts in shared memory and
    # than the symbols it stages past its tile; every tile walks again.
    deep = make_exact(ctx, ["a" * 1100, "a" * 300])
    return max(err, compare_walk(ctx, walk_inputs(ctx, deep, "x" + "a" * 5000 + " aa"),
                                 "patterns of 1,100 and 300 a's over a run of 5,000"))


def shard_walk_checks(ctx, engine, text: str, mesh) -> float:
    """Phase 4k (e): the goto walk's kernels against their plain version on
    the first and the last shard of one ``sharded_exact_search`` (their
    inputs captured): the first walks fewer starts than it reads."""
    from fuzzy_aho_corasick_tpu_torch.ops import exact
    from fuzzy_aho_corasick_tpu_torch.parallel.shard_search import sharded_exact_search

    calls = captured_walks(exact, lambda: sharded_exact_search(engine, text, 0.5, mesh))
    require(len(calls) == len(mesh), f"{len(calls)} shard walks captured")
    require(calls[0][0][1] < calls[0][0][2], "shard 0 reads no halo past its starts")
    return max(compare_walk(ctx, calls[d], f"sharded exact, shard {d} of {len(mesh)}")
               for d in (0, len(mesh) - 1))


def seed_walk_checks(ctx, beam_engines, tags) -> float:
    """Phase 4j (e): the goto walk's kernels against their plain version on
    every walk that the seed filter's exact pass makes in one search of each
    cell in ``tags`` (their inputs captured)."""
    from fuzzy_aho_corasick_tpu_torch.ops import exact

    err = 0
    for tag in tags:
        eng, text, thr = beam_engines[tag]
        calls = captured_walks(exact, lambda: eng.search_raw(text, thr))
        require(calls, f"{tag}: the seed filter's exact pass did not walk")
        for i, call in enumerate(calls):
            err = max(err, compare_walk(ctx, call, f"{tag}'s seed filter, walk {i + 1} of "
                                                   f"{len(calls)}"))
    return err


def walk_times(ctx, call) -> dict:
    """The goto walk at exact1k's shape: the kernel pair through its wrapper
    (CUDA events around 10 calls; each call's host read of the tally is
    inside), the plain version (3 calls), ``torch.gather`` of the goto
    table's root row (the one PyTorch call that computes a part of it, the
    root step), the profiler's device ms per call of each kernel with the
    launches, copies and host waits per call (the device ms per launch:
    the profiler drops events now and then); the tiles' arrivals (the most
    in one tile, the tiles past ``WALK_KEEP`` that walk again); the bound
    (the symbols read, the folded table the kernels read and the arrivals
    written, each once, over the memory rate, against an integer
    instruction per root step and per later step of a walk)."""
    from fuzzy_aho_corasick_tpu_torch.ops import exact

    torch, tpb = ctx.torch, ctx.tpb
    args, kw = call
    ids, n, n_read, goto, emits, L = args
    found, alive = exact.goto_walk(*args, **kw)
    ms = event_ms(torch, lambda: exact.goto_walk(*args, **kw), 10)
    plain = event_ms(torch, lambda: exact.goto_walk_torch(*args), 3)
    idsl = ids[:n].long()
    gather = event_ms(torch, lambda: torch.gather(goto[0], 0, idsl), 20)
    prof = profile_search(torch, lambda: exact.goto_walk(*args, **kw), 10, tpb.LAUNCHES)
    # One launch of each per walk: the mean event, right where the profile
    # drops events.
    passes = {name: launch_ms(prof, f"{name}_kernel")
              for name in ("goto_walk_count", "block_offsets", "goto_walk_emit")}
    per_tile = torch.bincount(found[0] // exact.WALK_TILE)
    tiles = {"most": int(per_tile.max()), "with_arrivals": int((per_tile > 0).sum()),
             "past_keep": int((per_tile > exact.WALK_KEEP).sum()),
             "tiles": -(-n // exact.WALK_TILE)}
    nbytes = n_read * ids.element_size() + kw["folded"].nbytes + found.nbytes
    bound = bound_ms(nbytes, n + sum(alive[:L - 1]), INT_RATE)
    log(f"  goto walk: {n} symbols, {goto.shape[0]} nodes x {goto.shape[1]} classes (folded "
        f"table {kw['folded'].nbytes} bytes), depth {L}; alive per span {alive}; "
        f"{found.shape[1]} arrivals, tiles {tiles}; the kernel pair {ms:.4f} ms per walk (CUDA "
        f"events), device ms per walk " + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
        + f"; {prof['kernels']:.1f} launches, {prof['copies']:.1f} copies, {prof['waits']:.1f} "
        f"host waits per walk; bound {bound[0]:.4f} ms by {bound[1]} ({bound[0] / ms:.3g} of it); "
        f"plain version {plain:.4f} ms; torch.gather of the root row {gather:.4f} ms")
    return {"ms": ms, "plain_ms": plain, "bound": bound, "library_ms": gather,
            "pass_device_ms": passes, "alive_per_span": alive, "arrivals": int(found.shape[1]),
            "tiles": tiles,
            "launches_copies_waits_per_walk": [prof["kernels"], prof["copies"], prof["waits"]]}


def exact1k_host_split(ctx, engine, text: str) -> dict:
    """Where exact1k's search spends its wall, on the host clock with a
    synchronise around each step (best of 5): the steps of
    ``exact_search_walk`` one by one (the view, tables and resident stream;
    the walk, and inside it the host read of the tally, timed by wrapping
    ``torch.Tensor.tolist`` for the call; ``found.cpu()``; ``_emit``), and
    ``search_raw`` whole; the rest is the search less the steps."""
    import numpy as np

    from fuzzy_aho_corasick_tpu_torch.ops import exact
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    torch = ctx.torch
    tolist = torch.Tensor.tolist
    reads = []

    def timed_tolist(t):
        t0 = time.perf_counter()
        out = tolist(t)
        reads.append(time.perf_counter() - t0)
        return out

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    best = {}
    for _ in range(5):
        _got, search = clock(lambda: engine.search_raw(text, 0.5))
        call, prep = clock(lambda: (view_of(text, engine.case_insensitive),
                                    walk_inputs(ctx, engine, text)))
        view, (args, kw) = call
        reads.clear()
        torch.Tensor.tolist = timed_tolist
        try:
            (found, _alive), walk = clock(lambda: exact.goto_walk(*args, **kw))
        finally:
            torch.Tensor.tolist = tolist
        tally_read = sum(reads) * 1e3
        (start, span, node), copy = clock(lambda: found.cpu().numpy())
        _m, emit = clock(lambda: exact._emit(engine, view, start, start + span, node,
                                             np.float32(0.5)))
        steps = {"search_raw": search, "view, tables, resident stream": prep, "walk": walk,
                 "of which the tally read": tally_read, "found.cpu()": copy, "_emit": emit}
        for k, v in steps.items():
            best[k] = min(best.get(k, v), v)
    best["rest"] = best["search_raw"] - best["view, tables, resident stream"] - best["walk"] \
        - best["found.cpu()"] - best["_emit"]
    log("  exact1k host split, ms (best of 5, host clock, synchronised): "
        + ", ".join(f"{k} {v:.4f}" for k, v in best.items()))
    return best


def exact_wide_inputs(ctx, engine, text: str):
    """(ids, tables, halo) of the exact engine's packed scan over ``text``,
    as its search hands them to the scan: the resident transcoded corpus."""
    tpb = ctx.tpb
    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    pk = tpb.packed_exact_of(engine)
    T, _cols, _shs = tpb._exact_consts(engine, pk, ctx.dev)
    ids, _n = device_corpus.resident(
        text, ("pk-exact", tpb._space_token(engine)),
        lambda h: pk.transcode(h, view_of(h, True), engine.dense), ctx.dev)
    return ids, T, pk.m_max


def wide_exact_times(ctx, engine, text: str, errs_in):
    """Phase 6 for the wide scan at k = 0 at exact-wide's main-path shape:
    the two wide kernels and ``block_offsets`` against their plain versions
    (``compare_scan``), then the wide kernels' times, registers and SASS
    (``wide_kernel_detail``) beside their plain versions' CUDA-event ms.
    Returns ({kernel: (ms, plain ms, (bound ms, by), library ms)}, {kernel:
    max_abs_err}, the detail)."""
    torch, tpb = ctx.torch, ctx.tpb
    ids, T, halo = exact_wide_inputs(ctx, engine, text)
    hits, errs = compare_scan(tpb, torch, ids, T, halo,
                              f"exact-wide main-path shape, W={T.W} k=0")
    bits, _counts = tpb.scan_bits(ids, T, halo)
    offs = tpb.block_offsets(_counts)
    detail = wide_kernel_detail(ctx, ctx.kern, ids, T, halo, tpb.wide_scan_instance)
    rec = {
        "scan_bits_wide[k=0]": (
            detail["scan_bits_wide"]["events_ms"],
            event_ms(torch, lambda: tpb.scan_bits_torch(ids, T, halo), 1),
            detail["scan_bits_wide"]["bound"], None),
        "hit_words_wide[k=0]": (
            detail["hit_words_wide"]["events_ms"],
            event_ms(torch, lambda: tpb.hit_words_torch(ids, bits, offs, hits, T, halo), 3),
            detail["hit_words_wide"]["bound"], None),
    }
    for name, (ms, plain, (b_ms, b_by), _lib) in rec.items():
        log(f"  {name} exact-wide: {ids.numel()} symbols, W={T.W}, {hits} hits, kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.3g} ms by {b_by} "
            f"({b_ms / ms:.3g} of the kernel's event time)")
    return rec, {"scan_bits_wide[k=0]": errs[0], "hit_words_wide[k=0]": errs[2],
                 "block_offsets": max(errs_in, errs[1])}, detail


def deep_times(ctx, engine, text: str, thr: float):
    """Phase 6 for the wide kernels' deep instances at mapped4's main-path
    shape (slice 1 of its text, the lane's own tables): both against their
    plain versions (``compare_scan``), their times, bound, registers and
    SASS (``wide_kernel_detail``) beside their plain versions' CUDA-event
    ms. Returns ({kernel: (ms, plain ms, (bound ms, by), library ms)},
    {kernel: max_abs_err}, the detail)."""
    torch, tpb = ctx.torch, ctx.tpb
    plan, run = lane_inputs(ctx.vdp, engine, text, thr, "mapped4 main-path shape")
    ids, T, halo = run.parts[0].ids_pf, run.T_scan, run.halo
    hits, errs = compare_scan(tpb, torch, ids, T, halo,
                              f"mapped4 main-path shape, W={T.W} k={T.k}")
    bits, counts = tpb.scan_bits(ids, T, halo)
    offs = tpb.block_offsets(counts)
    detail = wide_kernel_detail(ctx, ctx.kern, ids, T, halo, tpb.wide_scan_instance)
    rec = {
        "scan_bits_wide[k=7..24]": (
            detail["scan_bits_wide"]["events_ms"],
            event_ms(torch, lambda: tpb.scan_bits_torch(ids, T, halo), 1),
            detail["scan_bits_wide"]["bound"], None),
        "hit_words_wide[k=7..24]": (
            detail["hit_words_wide"]["events_ms"],
            event_ms(torch, lambda: tpb.hit_words_torch(ids, bits, offs, hits, T, halo), 3),
            detail["hit_words_wide"]["bound"], None),
    }
    for name, (ms, plain, (b_ms, b_by), _lib) in rec.items():
        log(f"  {name} mapped4: {ids.numel()} symbols, W={T.W}, k={T.k}, {hits} hits, kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.3g} ms by {b_by} "
            f"({b_ms / ms:.3g} of the kernel's event time)")
    return rec, {"scan_bits_wide[k=7..24]": errs[0], "hit_words_wide[k=7..24]": errs[2],
                 "block_offsets": errs[1]}, detail


def compare_ranges(ctx, engine, text: str, thr: float, what: str):
    """Phase 6 for the ranged pipeline: slice 1's hit list of ``engine``'s
    DP lane run as one range and as 3 ranges (``dp_pipeline_ranges``, each
    range handed its preceding hit, the rows put back in one range's order
    by their tags). Each range's kernel call against its plain version (rows,
    candidates and tags, bit for bit); the 3 ranges' rows equal to one
    range's, and their decoded matches too. Returns (kernel key, one-range
    ms, 3-range ms, plain 3-range ms)."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    from fuzzy_aho_corasick_tpu_torch.ops.emit import decode_matches
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    plan, run = lane_inputs(vdp, engine, text, thr, what)
    part = run.parts[0]
    hits, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    args = pipeline_args(vdp, np, plan, run, part, pos, words, thr)[2:]
    per = -(-hits // 3)
    one, n_one = vdp.dp_pipeline(pos, words, *args)
    three, n_three = vdp.dp_pipeline_ranges(pos, words, per, *args)
    # The ranges as dp_pipeline_ranges cuts them: (hits, words, h0).
    ranges = [(pos[a - min(a, 1):a + per], words[a - min(a, 1):a + per], min(a, 1))
              for a in range(0, hits, per)]
    for r_pos, r_words, h0 in ranges:
        rows_k, cand_k, tags_k = vdp.dp_pipeline(r_pos, r_words, *args, h0=h0, tags=True)
        rows_p, cand_p, tags_p = vdp.dp_pipeline_torch(r_pos, r_words, *args, h0=h0, tags=True)
        torch.cuda.synchronize()
        require(torch.equal(rows_k, rows_p) and cand_k == cand_p and torch.equal(tags_k, tags_p),
                f"{what}: the pipeline kernel disagrees with its plain version on a range")
    view = view_of(text, True)

    def decoded(r):
        r = r.cpu().numpy()
        out = decode_matches(engine, view, text, len(view), r[:, 0], r[:, 2], r[:, 3],
                             np.ascontiguousarray(r[:, 1]).view(np.float32), r[:, 4],
                             np.float32(thr))
        return sorted(map(match_key, out))

    same = torch.equal(one, three) and n_one == n_three
    log(f"  {what}: slice 1 of {len(run.parts)}, {hits} hits in 3 ranges of {per}: {n_three} "
        f"candidates, {three.shape[0]} rows, equal to one range's {n_one} / {one.shape[0]}: "
        f"{same}; each range's kernel call bit-equal to its plain version (rows, tags)")
    require(same and decoded(one) == decoded(three), f"{what}: 3 ranges differ from one")
    key = "typed_step" if run.variant.typed is not None else "dp_pipeline"
    t_one = event_ms(torch, lambda: vdp.dp_pipeline(pos, words, *args), 10)
    t_three = event_ms(torch, lambda: vdp.dp_pipeline_ranges(pos, words, per, *args), 10)
    t_plain = event_ms(torch, lambda: [vdp.dp_pipeline_torch(r_pos, r_words, *args, h0=h0,
                                                             tags=True)
                                       for r_pos, r_words, h0 in ranges], 1)
    log(f"  {what}: one range {t_one:.4f} ms, 3 ranges {t_three:.4f} ms, plain 3 ranges "
        f"(without the sort) {t_plain:.4f} ms")
    return key, t_one, t_three, t_plain


def many_kernel_times(ctx, engine, text: str, thr: float):
    """Phase 6 for the large-dictionary lane at its main-path shapes (the
    folded layout's one chunk and the plain layout's five over the 24 MiB
    corpus): every kernel of each chunk against its plain version there
    (``compare_scan``, ``compare_many_chunk`` with the containment test on
    and off), and the folded chunk's step over hit ranges
    (``compare_many_ranges``); then, on the folded chunk, CUDA-event ms of
    each kernel beside its plain version and the bound from these inputs,
    and the step's passes' device ms from the profiler; the wide kernels'
    times, registers and SASS (``wide_kernel_detail``). Returns ({kernel:
    (ms, plain ms, (bound ms, by), library ms)}, {kernel: max_abs_err},
    {the step's pass times}, the wide kernels' detail)."""
    torch, np, tpb, vdp, many = ctx.torch, ctx.np, ctx.tpb, ctx.vdp, ctx.many
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    view = view_of(text, True)
    n = len(view)
    errs = dict.fromkeys(("scan_bits_wide", "block_offsets", "hit_words_wide", "many_step"), 0.0)
    runs = {fold: many.many_inputs(engine, many.many_spec_of(engine, fold=fold), text, thr, view,
                                   n) for fold in (True, False)}
    for fold, run_f in runs.items():
        for ci, chunk in enumerate(run_f.chunks):
            what = (f"many1k main-path shape, {'folded' if fold else 'plain'} chunk {ci + 1} of "
                    f"{len(run_f.chunks)}")
            T = chunk.T_scan
            _h, e = compare_scan(tpb, torch, run_f.ids_pf, T, run_f.halo,
                                 f"{what}, W={T.W} k={T.k} damerau={T.damerau}")
            e = dict(zip(("scan_bits_wide", "block_offsets", "hit_words_wide"), e),
                     many_step=compare_many_chunk(ctx, run_f, chunk, n, thr, what,
                                                  no_containment=True))
            for key in errs:
                errs[key] = max(errs[key], e[key])
    run = runs[True]
    chunk = run.chunks[0]
    errs["many_step"] = max(errs["many_step"], compare_many_ranges(
        ctx, run, chunk, n, thr, "many1k main-path shape, folded chunk"))
    T, halo, ids = chunk.T_scan, run.halo, run.ids_pf
    bits, counts = tpb.scan_bits(ids, T, halo)
    offs = tpb.block_offsets(counts)
    hits, pos, words = tpb.packed_hits(ids, T, halo)
    window = vdp.DpWindow(0, n, n)
    N, X = ids.numel(), chunk.X
    step_args = (pos, words, window, run.ids_de, n, run.T, run.pens, np.float32(thr), run.E,
                 run.deadend, X, run.k)
    rows, pairs, n_cand = many.many_step(*step_args)
    _p, cf, _cs = many.expand_candidates_sparse(pos, words, window, run.E, X, run.ids_de, run.k)
    B = 2 * run.E + 1
    wj = 4 + 4 * run.k
    wp = wj + X.rd_max - X.rd_min
    cells = int(run.T.depth[cf.long()].sum()) * B * (run.E + 1)
    tables = sum(t.numel() * t.element_size() for t in (
        run.T.path_cls, run.T.path_node, run.T.depth, run.T.sim, run.T.node_ceil))
    x_tables = sum(t.numel() * t.element_size() for t in (X.field, X.shift, X.depth, X.pc))
    # Reads: the hits' positions and words, the rows of their nonzero
    # columns, a window per pair, the DP's tables and per candidate its
    # path and window; writes the rows. Operations: per (pair, row) the bit,
    # dedup and window tests of each band and the containment compares
    # (integer), and the DP's cells (float32); the larger of the two binds.
    step_bytes = (8 * pos.numel() + 8 * words.numel() + x_tables + pairs * wp + tables
                  + n_cand * (run.T.Lmax + 2 * run.E + 2) + rows.numel() * 4)
    step_bound = max(bound_ms(step_bytes, pairs * X.R * (8 * B + 4 * wj), INT_RATE),
                     bound_ms(step_bytes, cells * DP_CELL_INSTR, F32_RATE))
    detail = wide_kernel_detail(ctx, ctx.kern, ids, T, halo, tpb.wide_scan_instance)
    rec = {
        "scan_bits_wide": (
            detail["scan_bits_wide"]["events_ms"],
            event_ms(torch, lambda: tpb.scan_bits_torch(ids, T, halo), 1),
            detail["scan_bits_wide"]["bound"], None),
        "block_offsets": (
            event_ms(torch, lambda: tpb.block_offsets(counts), 20),
            event_ms(torch, lambda: tpb.block_offsets_torch(counts), 20),
            bound_ms(8 * counts.numel() + 4, counts.numel(), INT_RATE),
            event_ms(torch, lambda: torch.cumsum(counts, 0, dtype=torch.int32), 20)),
        "hit_words_wide": (
            detail["hit_words_wide"]["events_ms"],
            event_ms(torch, lambda: tpb.hit_words_torch(ids, bits, offs, hits, T, halo), 3),
            detail["hit_words_wide"]["bound"], None),
        "many_step": (
            event_ms(torch, lambda: many.many_step(*step_args), 20),
            event_ms(torch, lambda: many.many_step_torch(*step_args), 3),
            step_bound, None),
    }
    for name, (ms, plain, (b_ms, b_by), lib) in rec.items():
        log(f"  {name} many1k: {N} symbols, {hits} hits, {pairs} pairs, {n_cand} candidates, "
            f"{rows.shape[0]} rows, {cells} DP cells; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b_ms:.3g} ms by {b_by} ({b_ms / ms:.3g} of the kernel's time)"
            + (f", torch.cumsum {lib:.4f} ms" if lib is not None else ""))
    # The step's passes on the card: a call (count pass, block_offsets, one
    # read, write pass); the count pass alone (a bound past 1 emits no row,
    # so no write pass); and the count pass without a candidate (a window no
    # start lies in: no containment test, no DP, no emission).
    no_rows = step_args[:7] + (np.float32(2.0),) + step_args[8:]
    no_cands = step_args[:2] + (vdp.DpWindow(0, 0, n),) + step_args[3:]
    require(many.many_step(*no_rows)[0].shape[0] == 0 and many.many_step(*no_cands)[2] == 0,
            "many_step: the pass-time variants emit")
    profs = {key: profile_search(torch, lambda a=a: many.many_step(*a), 10, tpb.LAUNCHES)
             for key, a in (("call", step_args), ("count", no_rows), ("count_no_cands", no_cands))}
    passes = {key: device_ms(prof, "many_step_kernel") for key, prof in profs.items()}
    passes["write"] = passes["call"] - passes["count"]
    passes["candidates_share_of_count"] = 1.0 - passes["count_no_cands"] / passes["count"]
    log(f"  many_step device ms (profiler, 10 calls): a call {passes['call']:.4f} = count pass "
        f"{passes['count']:.4f} + write pass {passes['write']:.4f}; the count pass without a "
        f"candidate {passes['count_no_cands']:.4f}, so the candidates' containment test, DP and "
        f"emission take {passes['candidates_share_of_count']:.3f} of the count pass; launches "
        f"counted {profs['call']['counted']['many_step']} / "
        f"{profs['count']['counted']['many_step']} / "
        f"{profs['count_no_cands']['counted']['many_step']}, waits per call "
        f"{profs['call']['waits']:.1f}")
    pipe_args = (run.ids_pf, run.ids_de, n, chunk, halo, run.T, run.pens, np.float32(thr), run.E,
                 run.deadend, run.hit_ceil)
    whole = event_ms(torch, lambda: many.many_pipeline(*pipe_args), 10)
    whole_plain = event_ms(torch, lambda: many.many_pipeline_torch(*pipe_args), 1)
    log(f"  many_pipeline (the chunk's scan and step with their readbacks): "
        f"{whole:.4f} ms, plain {whole_plain:.4f} ms")
    return rec, errs, passes, detail


#: Phase 4i's stream settings, the bench's (``bench.py:390-440``): 64
#: shards and a 16-entry replacement table; the stream rule's window bytes
#: and smallest read.
STREAM_SHARDS = 64
STREAM_WINDOW = 4 << 20
STREAM_READ_MIN = 64 << 10
STREAM_TABLE = ["<x>"] * 16
#: The bench's search_basic haystack and its engine's words
#: (``bench.py:135-150``).
BASIC_HAY = "why hello there, wrold of helpful words"
BASIC_WORDS = ["hello", "world", "help"]


def reset_launches(tpb) -> None:
    for key in tpb.LAUNCHES:
        tpb.LAUNCHES[key] = 0


def stream_replace_cell(ctx, tag: str, engine, text: str, thr: float, locked, want_keys):
    """Phase 4i (a) / (b): ``replace_stream_parallel`` with the bench's recipe
    over ``text`` (two warm passes, best of 3, one ``FAC_TIME=1`` pass for
    the stage split), the plain versions and the oracle locked out, the
    launch counters set to 0 just before and read just after. Its bytes must
    equal ``FuzzyReplacer.replace`` over the whole resident text (one
    ``search_raw``) and ``replace_stream`` over the same bytes."""
    import gc
    import io

    from fuzzy_aho_corasick_tpu_torch import FuzzyReplacer, SearchOptions

    torch, tpb = ctx.torch, ctx.tpb
    t_phase = time.perf_counter()
    src = text.encode()
    reset_launches(tpb)
    with plain_locked(*locked):
        for _ in range(2):
            engine.replace_stream_parallel(io.BytesIO(src), io.BytesIO(), STREAM_SHARDS, thr,
                                           STREAM_TABLE)
        times = []
        for _ in range(3):
            out = io.BytesIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = engine.replace_stream_parallel(io.BytesIO(src), out, STREAM_SHARDS, thr,
                                                     STREAM_TABLE)
            times.append(time.perf_counter() - t0)
        got = out.getvalue()
        del out
        gc.collect()
        os.environ["FAC_TIME"] = "1"
        try:
            t0 = time.perf_counter()
            engine.replace_stream_parallel(io.BytesIO(src), io.BytesIO(), STREAM_SHARDS, thr,
                                           STREAM_TABLE)
            timed_ms = (time.perf_counter() - t0) * 1e3
            stages = dict(engine.last_stats)
        finally:
            os.environ.pop("FAC_TIME", None)
    launches = dict(tpb.LAUNCHES)
    best = min(times)
    log(f"  replace_stream_parallel, {STREAM_SHARDS} shards, table {STREAM_TABLE[0]!r} x "
        f"{len(STREAM_TABLE)}: {len(src)} bytes, best of 3 {best * 1e3:.3f} ms (all "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) = {len(src) / best / 1e6:.1f} MB/s, "
        f"{written} bytes written, {got.count(b'<x>')} replacements; launches {launches}")
    log(f"  FAC_TIME stages: {stages}")
    require(written == len(got), f"{tag}: replace_stream_parallel's count")
    require(stages.get("backend") == "replace-stream-parallel"
            and all(k in stages for k in ("wait_ms", "post_ms", "emit_ms")),
            f"{tag}: FAC_TIME stages")
    require(all(launches[k] > 0 for k in want_keys),
            f"{tag}: the stream did not launch {', '.join(want_keys)}")
    prep_ms = min(producer_alone_ms(engine, src) for _ in range(2))
    other = timed_ms - stages["wait_ms"] - stages["post_ms"] - stages["emit_ms"]
    log(f"  the FAC_TIME pass {timed_ms:.3f} ms, of it outside wait, post and emit (the calling "
        f"thread blocked on the producer's queue): {other:.3f} ms; the producer alone (window "
        f"cuts, superwindow joins and decodes, no search): {prep_ms:.3f} ms per pass")
    replacer = FuzzyReplacer(engine, STREAM_TABLE)
    with plain_locked(*locked):
        t0 = time.perf_counter()
        whole = replacer.replace(text, SearchOptions.new().with_threshold(thr)).encode()
        whole_s = time.perf_counter() - t0
        seq = io.BytesIO()
        t0 = time.perf_counter()
        replacer.replace_stream(io.BytesIO(src), seq, thr)
        seq_s = time.perf_counter() - t0
    seq = seq.getvalue()
    log(f"  whole-input FuzzyReplacer.replace {whole_s:.3f} s, replace_stream {seq_s:.3f} s "
        f"({len(src) / seq_s / 1e6:.1f} MB/s); equal to the whole-input replace "
        f"{got == whole}, to replace_stream {got == seq}")
    require(got == whole, f"{tag}: replace_stream_parallel differs from the whole-input replace")
    require(got == seq, f"{tag}: replace_stream_parallel differs from replace_stream")
    require(got.count(b"<x>") > 1000, f"{tag}: too few replacements to be a real check")
    log(f"  phase {tag} {time.perf_counter() - t_phase:.1f} s")
    stages["pass_ms"], stages["outside_ms"] = timed_ms, other
    return SimpleNamespace(times=times, launches=launches, stages=stages, prep_ms=prep_ms,
                           replacements=got.count(b"<x>"), seq_s=seq_s, nbytes=len(src))


def producer_alone_ms(engine, src: bytes) -> float:
    """Milliseconds for ``replace_stream_parallel``'s producer thread alone
    (``stream._replace_producer``, the pipeline's own) to cut ``src`` into
    windows and assemble its superwindow batches."""
    import io

    from fuzzy_aho_corasick_tpu_torch import stream
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import clear_registered_views

    wr = stream.WindowReader(io.BytesIO(src), stream.DEFAULT_WINDOW, engine.stream_overlap())
    t0 = time.perf_counter()
    prod = stream._replace_producer(engine, wr, STREAM_SHARDS)
    while prod.next() is not None:
        pass
    ms = (time.perf_counter() - t0) * 1e3
    clear_registered_views()
    return ms


def window_geometry(n: int, overlap: int):
    """(base, bytes, commit) of each window that the stream rule cuts a
    reader of ``n`` bytes into, where a byte is a grapheme (ASCII without
    CR LF): a window holds the last ``overlap`` graphemes of the one before
    it and reads on until it holds ``STREAM_WINDOW`` bytes, at least
    ``STREAM_READ_MIN`` in one read; it owns the match starts before its
    last ``overlap`` graphemes, where the next one begins. The first window
    shorter than ``STREAM_WINDOW`` is the last and owns all of itself.
    Written from the rule, not from the port's ``WindowReader``."""
    out, base, carried = [], 0, 0
    while True:
        nbytes = min(n - base, max(STREAM_WINDOW, carried + STREAM_READ_MIN))
        if nbytes < STREAM_WINDOW:
            out.append((base, nbytes, nbytes))
            return out
        out.append((base, nbytes, nbytes - overlap))
        base, carried = base + nbytes - overlap, overlap


def windowed_reference(n: int, raw, words, overlap: int):
    """The stream's expected output from an independent raw match set: the
    windows of ``window_geometry(n, overlap)``, each window's raw matches
    (those inside it) ranked in the Default order (similarity, pattern
    length, span length descending; start, end, pattern), kept greedily
    where they overlap no kept match, then those starting before the
    window's commit, in start order. ``raw`` holds (pattern, start, end, f32
    similarity bits, insertions, deletions, substitutions, swaps) over the
    patterns ``words``."""
    import bisect

    import numpy as np

    rows = np.array(sorted(raw, key=lambda r: (r[1], r[2], r[0])), dtype=np.int64)
    plen = np.array([len(w) for w in words], dtype=np.int64)
    sim = rows[:, 3].astype(np.uint32).view(np.float32)
    out = []
    for base, nbytes, commit in window_geometry(n, overlap):
        lo, hi = np.searchsorted(rows[:, 1], [base, base + nbytes])
        idx = np.arange(lo, hi)
        idx = idx[rows[idx, 2] <= base + nbytes]
        s, e, p = rows[idx, 1], rows[idx, 2], rows[idx, 0]
        order = np.lexsort((p, e, s, -(e - s), -plen[p], -sim[idx].astype(np.float64)))
        starts, ends, kept = [], [], []
        for r in idx[order].tolist():
            a, b = int(rows[r, 1]), int(rows[r, 2])
            at = bisect.bisect_left(starts, a)
            if (at == 0 or ends[at - 1] <= a) and (at == len(starts) or starts[at] >= b):
                starts.insert(at, a)
                ends.insert(at, b)
                kept.append(r)
        kept.sort(key=lambda r: rows[r, 1])
        out.extend(tuple(rows[r].tolist()) for r in kept if rows[r, 1] - base < commit)
    return out


def joined_stream_cell(ctx, fuzzy, joined: str, raw, locked, want_keys):
    """Phase 4i (c): ``search_stream_parallel`` over ``joined`` (past
    ``RESIDENT_MAX``, so no single ``search_raw`` takes it), every match in
    the context oracle's raw set ``raw`` over that text, and the stream
    equal to that set resolved window by window (``windowed_reference``, in
    windows cut by the stream rule, ``window_geometry``)."""
    import io

    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus

    torch, tpb = ctx.torch, ctx.tpb
    t_phase = time.perf_counter()
    data = joined.encode()
    require(len(joined) > tpb.RESIDENT_MAX, "the joined text is under RESIDENT_MAX")
    got = []
    held_before = device_corpus.held_bytes()[1]
    reset_launches(tpb)
    with plain_locked(*locked):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fuzzy.search_stream_parallel(io.BytesIO(data), 0.8, STREAM_SHARDS, got.append)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(tpb.LAUNCHES)
    stats = dict(fuzzy.last_stats)
    counted, held = device_corpus.held_bytes()
    keys = [match_key(m) for m in got]
    log(f"  search_stream_parallel, {STREAM_SHARDS} shards: {n} bytes ({len(joined)} graphemes, "
        f"RESIDENT_MAX {tpb.RESIDENT_MAX}) in {dt:.3f} s = {n / dt / 1e6:.1f} MB/s, {len(got)} "
        f"matches; last batch {stats.get('slices')} slices; launches {launches}; the LRU holds "
        f"{held} bytes on the device (count {counted}; {held_before} before the stream), torch "
        f"allocated {torch.cuda.memory_allocated()} bytes")
    require(n == len(data), "the stream's byte count")
    require(all(launches[k] > 0 for k in want_keys),
            f"the stream did not launch {', '.join(want_keys)}")
    require(len(set(keys)) == len(keys), "the stream repeats a match")
    require(all(data[m.start:m.end].decode() == m.text for m in got), "a match's text")
    outside = set(keys) - raw
    t0 = time.perf_counter()
    # fuzzy1's overlap by the stream rule: its longest pattern plus its one
    # edit, plus one grapheme.
    require(joined.isascii() and "\r\n" not in joined, "the joined text is not one byte per "
            "grapheme")
    want = windowed_reference(len(data), raw, HEADLINE, max(map(len, HEADLINE)) + 1 + 1)
    log(f"  context oracle over the joined text: {len(raw)} raw matches (phase 4b's 42,666 per "
        f"copy); stream matches outside it {len(outside)}; resolved window by window "
        f"{len(want)} matches ({time.perf_counter() - t0:.1f} s); equal: {keys == want}")
    require(not outside, "the stream holds a match the oracle does not")
    require(keys == want, "the stream differs from the oracle resolved window by window")
    require(len(want) > 20000, "too few stream matches to be a real check")
    log(f"  phase 4i (c) {time.perf_counter() - t_phase:.1f} s")
    return SimpleNamespace(seconds=dt, launches=launches, matches=len(got), raw=len(raw),
                           held=held, held_before=held_before,
                           allocated=torch.cuda.memory_allocated(), nbytes=n)


def captured_searches(engine, drive):
    """The texts that ``drive()`` hands ``engine.search_raw``, in order: the
    superwindows a stream joins, as its search worker gets them."""
    texts = []
    search_raw = engine.search_raw

    def recording(text, *args, **kw):
        texts.append(text)
        return search_raw(text, *args, **kw)

    engine.search_raw = recording
    try:
        drive()
    finally:
        del engine.search_raw
    return texts


def lane_slice_checks(ctx, engine, text: str, thr: float, what: str):
    """The DP lane's kernels against their plain versions on every slice of
    ``text``, the short last one too: the hit-list scan's three kernels
    (``compare_scan``), then ``dp_pipeline`` and ``block_offsets`` on the
    step's counts (``compare_slice_pipeline``). Returns ([scan_bits,
    block_offsets, hit_words] max_abs_err, dp_pipeline's, the slices'
    lengths, their hits)."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    plan, run = lane_inputs(vdp, engine, text, thr, what)
    scan, pipe, hits = [0, 0, 0], 0.0, 0
    for i, part in enumerate(run.parts):
        tag = f"{what}, slice {i + 1} of {len(run.parts)}"
        count, errs = compare_scan(tpb, torch, part.ids_pf, run.T_scan, run.halo, tag,
                                   want_hits=False)
        err, err_offs = compare_slice_pipeline(tpb, vdp, torch, np, plan, run, part, thr, tag,
                                               want_rows=False)
        scan = [max(a, b) for a, b in zip(scan, errs)]
        scan[1], pipe, hits = max(scan[1], err_offs), max(pipe, err), hits + count
    return scan, pipe, [part.local_n for part in run.parts], hits


def stream_kernel_checks(ctx, fuzzy, exact, corpus: str, joined: str):
    """Phase 4i (e): each kernel of 4i's paths against its plain version on
    the inputs those paths hand it, captured from one more run of each
    stream (``captured_searches``; its launches are not counted): every DP
    slice of each superwindow that (a)'s ``replace_stream_parallel`` and
    (c)'s ``search_stream_parallel`` give the ``edits(1)`` lane
    (``lane_slice_checks``), the exact scan's three kernels on each that
    (b) gives the exact engine, and the DP lane on the 1 MiB that (d)'s
    prefilter and loaded ``edits(1)`` engine search. (d)'s loaded many1k
    engine searches the 1 MiB on which phase 3 holds the many lane's
    kernels. Returns ([scan_bits, block_offsets, hit_words] max_abs_err,
    dp_pipeline's)."""
    import io

    torch, tpb = ctx.torch, ctx.tpb
    t_phase = time.perf_counter()
    src = corpus.encode()
    jobs = [
        ("(a)", fuzzy, 0.8, lambda: fuzzy.replace_stream_parallel(
            io.BytesIO(src), io.BytesIO(), STREAM_SHARDS, 0.8, STREAM_TABLE)),
        ("(b)", exact, 0.5, lambda: exact.replace_stream_parallel(
            io.BytesIO(src), io.BytesIO(), STREAM_SHARDS, 0.5, STREAM_TABLE)),
        ("(c)", fuzzy, 0.8, lambda: fuzzy.search_stream_parallel(
            io.BytesIO(joined.encode()), 0.8, STREAM_SHARDS, lambda m: None)),
    ]
    scan, pipe = [0, 0, 0], 0.0
    for tag, eng, thr, drive in jobs:
        texts = captured_searches(eng, drive)
        require(len(texts) >= 2, f"4i {tag}: the stream made {len(texts)} searches")
        hits = 0
        for i, text in enumerate(texts):
            what = f"4i {tag} superwindow {i + 1} of {len(texts)} ({len(text)} graphemes)"
            if eng is exact:
                ids, T, halo = exact_wide_inputs(ctx, eng, text)
                count, errs = compare_scan(tpb, torch, ids, T, halo, what, want_hits=False)
                scan = [max(a, b) for a, b in zip(scan, errs)]
            else:
                errs, err, lengths, count = lane_slice_checks(ctx, eng, text, thr, what)
                scan, pipe = [max(a, b) for a, b in zip(scan, errs)], max(pipe, err)
                log(f"  {what}: slices of {lengths} symbols, {count} hits, every kernel equal "
                    f"to its plain version")
            hits += count
        require(hits > 1000, f"4i {tag}: too few hits to be a real check")
        del texts
    errs, err, _lengths, hits = lane_slice_checks(ctx, fuzzy, corpus[: 1 << 20], 0.8,
                                                  "4i (d) 1 MiB, edits(1)")
    require(hits > 0, "4i (d): no hits to compare")
    scan, pipe = [max(a, b) for a, b in zip(scan, errs)], max(pipe, err)
    torch.cuda.synchronize()
    log(f"  max_abs_err scan_bits {scan[0]}, block_offsets {scan[1]}, hit_words {scan[2]}, "
        f"dp_pipeline {pipe}; phase 4i (e) {time.perf_counter() - t_phase:.1f} s")
    return scan, pipe


def beam_stage_profile(ctx, engine, text: str, thr: float):
    """Phase 4j's stages of one beam-lane search, each synchronised and
    profiled alone (one call): the candidate starts (``_candidate_starts``:
    the packed anchors or the seed filter's exact pass), the frontier
    (``beam_emissions``), and the rest (the emissions' copy, the host's
    best-per-span reduction and any oracle rescue) as the search's wall less
    those two. The frontier kernels count its expanded states and rounds
    (their stats, one entry a run) for its byte bound."""
    import numpy as np

    from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as tfz
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    torch = ctx.torch
    thr32 = np.float32(thr)
    view = view_of(text, engine.case_insensitive)
    n = len(view)
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr32)
    found = {}

    def anchors():
        found["cand"] = tfz._candidate_starts(engine, text, view, n, thr32)

    prof_a = profile_search(torch, anchors, 1, ctx.tpb.LAUNCHES)
    runs = []

    def frontier():
        runs.clear()
        found["em"] = tfz.beam_emissions(engine, text, view, n, found["cand"], thr32, ceil,
                                         stats=runs)

    prof_f = profile_search(torch, frontier, 1, ctx.tpb.LAUNCHES)
    # Each run's stats: (emissions, states expanded, rounds, overflowed).
    counted = {"states": sum(r[1] for r in runs), "rounds": sum(r[2] for r in runs)}
    em, overflow = found["em"]
    tabs = tfz.beam_tables(engine, ctx.dev)
    E = engine.max_edits_fast
    T = engine.dense.max_depth + E
    nchunk = tfz._chunk_len(E, T, tabs.et_deep.shape[1])
    anchors = int(found["cand"].numel())
    require(len(runs) == -(-anchors // tfz.run_len(E, tabs, nchunk, T, True)),
            "the frontier's runs are not the kernels' run sizing")
    return SimpleNamespace(anchors=anchors, n=n, prof_a=prof_a, prof_f=prof_f, counted=counted,
                           emissions=int(em[0].numel()), overflow=len(overflow),
                           cand=found["cand"], view=view, ceil=ceil, nchunk=nchunk,
                           chunks=-(-anchors // nchunk), runs=len(runs))


def anchors_bound(ctx, engine, thr: float, stages):
    """(least ms, which binds) for the candidate starts of a beam search:
    the text's symbols read once and the anchors (int64) written once, and
    the integer instructions of the scan that finds them (``scan_instr``
    per symbol): the packed anchors' scan, or the seed engine's exact scan;
    the seed engine's goto walk is counted by its bytes alone."""
    import numpy as np

    tpb = ctx.tpb
    n, out = stages.n, 8 * stages.anchors
    pk = tpb.packed_fuzzy_of(engine)
    if pk is not None:
        ks = [pk.filt.k_for(bp, np.float32(thr)) for bp in pk.filt.patterns]
        dam = max(ks) > tpb.MAX_K
        if dam:
            ks = [pk.filt.k_for(bp, np.float32(thr), damerau=True) for bp in pk.filt.patterns]
        return bound_ms(n + out, scan_instr(pk.W, max(ks), dam) * n, INT_RATE)
    spk = tpb.packed_exact_of(engine._seed_filter_cache.seed_engine)
    if spk is not None:
        return bound_ms(n + out, scan_instr(spk.W, 0, False) * n, INT_RATE)
    return bound_ms(n + out, 0, INT_RATE)


#: The frontier kernels by lane: (launch counter, kernel name) of each, and
#: the JAX function they replace. E = 1 runs two: the thread path, and the
#: warp path for the starts whose pool outgrows a thread's walks.
FRONTIER_KERNELS = {
    1: ((("beam_pool", "beam_pool_thread_kernel"), ("beam_pool_warp", "beam_pool_kernel")),
        "fuzzy_aho_corasick_tpu/ops/fuzzy.py:342"),
    2: ((("beam_sorted", "beam_sorted_kernel"),), "fuzzy_aho_corasick_tpu/ops/fuzzy.py:237"),
}


def frontier_inputs(ctx, engine, text: str, thr: float):
    """(tables, params, symbol ids, nchunk) of a frontier call over ``text`` on
    the card, as ``beam_emissions`` builds them."""
    import numpy as np

    from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as tfz
    from fuzzy_aho_corasick_tpu_torch.ops.packed_bitap import _space_token
    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    thr32 = np.float32(thr)
    dense = engine.dense
    view = view_of(text, engine.case_insensitive)
    n = len(view)
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr32)
    ids, _n = device_corpus.resident(
        text, ("dense", _space_token(engine)),
        lambda h: np.ascontiguousarray(dense.transcode(h, view),
                                       dtype=np.uint8 if dense.num_classes <= 256 else np.int32),
        ctx.dev)
    tabs = tfz.beam_tables(engine, ctx.dev)
    prm = tfz.beam_params(engine, thr32, ceil, n, ctx.dev)
    return tabs, prm, ids, tfz._chunk_len(prm.E, prm.T, tabs.et_deep.shape[1])


def frontier_registers(log_text: str) -> dict:
    """ptxas's (registers, spill-store bytes) of every frontier kernel
    instance in the build log: ``beam_pool_thread_kernel``,
    ``beam_pool_kernel`` and ``beam_sorted_kernel`` for u8 ids with the
    tables on chip or in global memory and for int32 ids (tables global),
    and ``beam_order_kernel``."""
    import re

    out = {}
    for sym, chip in (("h", 1), ("h", 0), ("i", 0)):
        label = f"{'u8' if sym == 'h' else 'int32'},{'tables on chip' if chip else 'tables global'}"
        for name in ("beam_pool_thread_kernel", "beam_pool_kernel", "beam_sorted_kernel"):
            e = ptxas_entry(log_text, rf"{name}I{sym}Lb{chip}E")
            out[f"{name}<{label}>"] = e and e[1:]
    e = ptxas_entry(log_text, re.escape("beam_order_kernel"))
    out["beam_order_kernel"] = e and e[1:]
    return out


def compare_frontier(ctx, engine, text: str, thr: float, starts, what: str, nchunk=None,
                     timed=False) -> dict:
    """The frontier kernel (``pool_frontier`` / ``sorted_frontier`` on the
    card) against its plain version (``_pool_chunk`` / ``_beam_chunk``) on
    the card, on the same run of ``starts``: emissions and overflow flags
    bit for bit; the order kernel (``order_emissions``, captured from the
    call) against ``order_emissions_torch`` on the staged emissions, bit for
    bit. Records the launches of each (the write launch only where the run
    emits), the layout, whether the tables went on chip, and the kernel's
    stats (spilled starts, rounds sorted in memory). With ``timed``, the
    wrapper's CUDA-event ms (count launch, ``block_offsets``, the read, write
    launch, order kernel), the profiler's device ms per launch of the
    frontier kernel and of the order kernel, the order kernel's event ms
    beside its plain version's, the plain frontier's event ms and the I/O
    bounds (the starts read, a symbol each, the emissions and flags written;
    the order kernel's staged emissions read and outputs written)."""
    from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as tfz

    torch, tpb = ctx.torch, ctx.tpb
    tabs, prm, ids, chunk = frontier_inputs(ctx, engine, text, thr)
    nchunk = nchunk or chunk
    E = prm.E
    pairs = FRONTIER_KERNELS[min(E, 2)][0]
    kernel = " + ".join(k for _c, k in pairs)
    B = 32 + 24 * E
    starts = starts.to(ctx.dev)
    if E == 1:
        kern = lambda: (lambda em, st: ((em, None), st))(
            *tfz.pool_frontier(starts, tabs, prm, ids, nchunk))
        plain = lambda: (tfz._pool_chunk(starts, tabs, prm, ids, nchunk), None)
    else:
        kern = lambda: (lambda em, ov, st: ((em, ov), st))(
            *tfz.sorted_frontier(starts, tabs, prm, ids, nchunk, B))
        plain = lambda: tfz._beam_chunk(starts, tabs, prm, ids, nchunk, B)
    captured = []
    order = tfz.order_emissions

    def capture(*args):
        captured.append(args)
        return order(*args)

    before = dict(tpb.LAUNCHES)
    tfz.order_emissions = capture
    try:
        (em, ov), stats = kern()
    finally:
        tfz.order_emissions = order
    torch.cuda.synchronize()
    keys = [c for c, _k in pairs] + ["beam_order"]
    launched = {k: tpb.LAUNCHES[k] - before[k] for k in keys}
    require(all(launched[c] > 0 for c, _k in pairs), f"{what}: {kernel}: a kernel was not launched")
    want_em, want_ov = plain()
    got = [f.cpu() for f in em] + ([ov.cpu()] if ov is not None else [])
    want = [f.cpu() for f in want_em] + ([want_ov.cpu()] if want_ov is not None else [])

    def diff(got, want):
        same = all(a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())
                   for a, b in zip(got, want))
        err = max((float((a.double() - b.double()).abs().max()) if a.shape == b.shape and
                   a.numel() else 0.0 if a.shape == b.shape else float("inf")
                   for a, b in zip(got, want)), default=0.0)
        return same, err

    same, err = diff(got, want)
    order_same, order_err = True, 0.0
    if captured:
        staged, offsets, n_run, nc, T = captured[0]
        order_same, order_err = diff([f.cpu() for f in order(*captured[0])],
                                     [f.cpu() for f in tfz.order_emissions_torch(*captured[0])])
    Df, Dd = tabs.k32.et_full.shape[1], tabs.k32.et_deep.shape[1]
    MO, npat = tabs.k32.out_list.shape[1], tabs.pat_len.numel()
    lay = tfz.frontier_workspace(E, Df, Dd, prm.T)
    tb = tfz.tables_bytes(tabs.num_nodes, tabs.C, Df, MO, npat)
    mirror = (lay, tb, tfz.tables_on_chip(tb, lay, ids.element_size()))
    lib = tfz.frontier_layout(E, Df, Dd, prm.T, tabs.num_nodes, tabs.C, MO, npat,
                              ids.element_size())
    require(lib == mirror, f"{what}: the library's layout {lib} differs from ops/fuzzy.py's "
                           f"mirror {mirror}")
    n_over = int(ov.sum()) if ov is not None else 0
    emitting = int(torch.unique(em[0]).numel())
    rec = {"kernel": kernel, "E": E, "starts": int(starts.numel()), "nchunk": nchunk,
           "T": prm.T, "Df": Df, "Dd": Dd, "classes": tabs.C, "nodes": tabs.num_nodes,
           "ids": str(ids.dtype), "layout": lay._asdict(), "tables_bytes": tb,
           "tables_on_chip": bool(stats[8]),
           "order_hist_on_chip": tfz.order_hist_on_chip(prm.T),
           "emissions": int(em[0].numel()), "emitting_starts": emitting, "overflowed": n_over,
           "stats": list(stats), "spilled_starts": stats[4], "memory_sorted_rounds": stats[5],
           "handed_starts": stats[6], "handed_emissions": stats[7], "launches": launched, "max_abs_err": max(err, order_err), "equal": same,
           "order_equal": order_same}
    log(f"  {what}: {kernel} over {rec['starts']} starts (chunks of {nchunk}, T = {prm.T}, "
        f"Df / Dd {Df} / {Dd}, {tabs.C} classes, {tabs.num_nodes} nodes, {ids.dtype}; "
        f"{lay.light_chip} walks a thread, {lay.chip} entries a warp on chip, {lay.ws} bytes a "
        f"block, global scratch {lay.spill} bytes a warp; tables {tb} bytes "
        f"{'on chip' if rec['tables_on_chip'] else 'in global memory'}): {rec['emissions']} "
        f"emissions from {emitting} starts, {n_over} overflowed, stats (emissions, states, "
        f"rounds, overflowed, spilled, memory-sorted rounds, handed on, their emissions, tables "
        f"on chip) {list(stats)}; launches "
        f"{launched}; bit-equal to the plain version on the card {same}, the order kernel "
        f"{order_same} (max_abs_err {rec['max_abs_err']})")
    require(same, f"{what}: {kernel} differs from its plain version")
    require(order_same, f"{what}: beam_order_kernel differs from its plain version")
    require(stats[0] == rec["emissions"] and stats[3] == n_over,
            f"{what}: the kernel's stats disagree with its output")
    require(rec["tables_on_chip"] == lib[2],
            f"{what}: the count launch read the tables from "
            f"{'shared' if rec['tables_on_chip'] else 'global'} memory, its layout says otherwise")
    phases = 2 if rec["emissions"] else 1
    require(launched == {**{c: phases for c, _k in pairs}, "beam_order": phases - 1},
            f"{what}: launches {launched}: a write phase and an order launch exactly where the "
            f"run emits")
    if timed:
        rec["ms"] = event_ms(torch, kern, 3)
        # Three calls: the profiler on that machine drops an event now and
        # then, and launch_ms takes the mean of the events it kept.
        prof = profile_search(torch, kern, 3, tpb.LAUNCHES)
        rec["launch_ms"] = {k: launch_ms(prof, k) for _c, k in pairs}
        rec["device_ms"] = {k: device_ms(prof, k) for _c, k in pairs}
        rec["order_launch_ms"] = launch_ms(prof, "beam_order_kernel")
        rec["plain_ms"] = event_ms(torch, plain, 1)
        nbytes = starts.numel() * (8 + ids.element_size() + (E >= 2)) + 36 * rec["emissions"]
        rec["bound"] = bound_ms(nbytes, 0, INT_RATE)
        if E == 1:
            # The pool's warp path alone: each start handed to it, its list
            # entry, position and symbol read, its count written and its
            # offset read; each of its emissions staged once (24 bytes).
            rec["warp_bound"] = bound_ms(
                stats[6] * (4 + 8 + ids.element_size() + 4 + 4) + 24 * stats[7], 0, INT_RATE)
        if captured:
            rec["order_ms"] = event_ms(torch, lambda: order(*captured[0]), 10)
            rec["order_plain_ms"] = event_ms(
                torch, lambda: tfz.order_emissions_torch(*captured[0]), 3)
            rec["order_bound"] = bound_ms(
                60 * rec["emissions"] + 4 * (-(-rec["starts"] // nchunk) + 1), 0, INT_RATE)
        log(f"    wrapper {rec['ms']:.4f} ms by events (count phase, block_offsets, the read, "
            f"write phase, order kernel), device ms a launch {rec['launch_ms']} (both phases "
            f"{rec['device_ms']}), beam_order_kernel {rec['order_launch_ms']:.4f} device ms, "
            f"plain version {rec['plain_ms']:.3f} ms; bound {rec['bound'][0]:.5f} ms by "
            f"{rec['bound'][1]} = {rec['bound'][0] / rec['ms']:.2e} of the wrapper"
            + (f"; the warp path's own bound {rec['warp_bound'][0]:.6f} ms by "
               f"{rec['warp_bound'][1]} ({stats[6]} starts handed on, {stats[7]} emissions)"
               if E == 1 else ""))
        if captured:
            log(f"    order kernel {rec['order_ms']:.4f} ms by events, its plain version "
                f"{rec['order_plain_ms']:.4f} ms, bound {rec['order_bound'][0]:.5f} ms by "
                f"{rec['order_bound'][1]}")
    return rec


def frontier_kernel_check(ctx, engine, text: str, thr: float, stages, what: str) -> dict:
    """Phase 4j (e): the frontier kernel against its plain version on the
    card over the first run of ``text``'s candidate starts (as many chunks
    as ``beam_emissions`` gives a run on the card), timed."""
    from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as tfz

    t0 = time.perf_counter()
    tabs, prm, _ids, nchunk = frontier_inputs(ctx, engine, text, thr)
    run = tfz.run_len(prm.E, tabs, nchunk, prm.T, True)
    rec = compare_frontier(ctx, engine, text, thr, stages.cand[:run], f"{what}, first run",
                           timed=True)
    rec["seconds"] = time.perf_counter() - t0
    log(f"    {rec['seconds']:.1f} s")
    return rec


#: Phase 4j (e)'s small shapes by title: what each must reach (checked in
#: ``frontier_shape_checks``).
FRONTIER_SHAPE_NEEDS = {
    "E = 2, overflowing starts": ("overflow", "memory sort", "tables global"),
    "E = 3, B = 104": ("memory sort", "tables on chip"),
    "E = 4, rounds past the keys on chip": ("sort scratch", "memory sort", "tables on chip"),
    "E = 2, a node of 100 children": ("overflow", "memory sort"),
    "E = 1, a 200-character pattern": ("handed on", "pool scratch", "tables on chip"),
    "E = 1, more than 256 classes": ("int32", "tables global"),
    "E = 2, more than 256 classes": ("int32",),
    "E = 1, no start emits": ("no emission",),
    "E = 2, no start emits": ("no emission",),
    "E = 1, every start emits": ("every start emits",),
    "E = 2, every start emits": ("every start emits",),
    "E = 1, a 400-character pattern": ("order histograms global", "handed on", "pool scratch"),
}


def frontier_shapes(ctx):
    """Phase 4j (e)'s small shapes the cells do not reach, each (title,
    engine, text, threshold, starts or None for every position): an E = 2
    text whose starts overflow (a node of 41 children behind a two-character
    prefix the text spells: rounds past the register sort, the tables in
    global memory); an E = 3 engine (B = 104, tables on chip); the same
    dictionary at E = 4 and 0.3, whose rounds pass the keys a warp keeps on
    chip (its global scratch); a node of 100 children at E = 2 (overflowing
    starts); a pool past a thread's and a warp's walks on chip (a
    200-character pattern beside a node of 10 children: P = 4,406 walks);
    more than 256 classes (int32 ids) at E = 1 and E = 2; a run in which no
    start emits and one in which every start does, at E = 1 and E = 2; and
    the first 4 starts of a 400-a run for a 400-character pattern, beside
    hello's (T = 401: the order kernel's round histograms in global memory,
    emissions in rounds past 384)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 40)
    cjk = [chr(0x4E00 + i) for i in range(700)]
    L = ctx.Limits
    fill = lambda lo, hi, k: "".join(cjk[i] for i in rng.integers(lo, hi, k))

    def spelled(words, lo, hi, count, edit=True):
        parts = []
        for i in range(count):
            w = list(words[int(rng.integers(len(words)))])
            if edit and i % 2:
                w[int(rng.integers(len(w)))] = cjk[int(rng.integers(lo, hi))]
            parts.append(fill(lo, hi, int(rng.integers(2, 8))) + "".join(w))
        return "".join(parts)

    over = [cjk[0] + cjk[1] + cjk[10 + i] + cjk[100 + i] for i in range(41)]
    over += [cjk[200 + i] + fill(300, 500, 3) for i in range(30)]
    ascii_words = ["hello", "world", "help", "held", "yellow", "fellow", "mellow", "below"]
    e3_text = " ".join(ascii_words[int(i)] for i in rng.integers(0, 8, 400))
    e3_text += " helo wrld hepl yelow fellw mello bellow"
    deep = [cjk[0] + cjk[10 + i] + cjk[200 + i] for i in range(100)]
    pool_words = ["a" * 200] + ["b" + c for c in "cdefghijkl"]
    pool_text = " ".join(("a" * int(rng.integers(190, 206))) if i % 3 == 0 else
                         "b" + "cdefghijkl"[int(rng.integers(10))] for i in range(60))
    wide = sorted({fill(0, 600, 4) for _ in range(150)})
    # At E = 2 a root of 136 edges would overflow every start at its first
    # round: first characters from 20, the rest from 600.
    wide2 = sorted({cjk[600 + int(rng.integers(20))] + fill(0, 600, 3) for _ in range(150)})
    none_text = "zq xk vj " * 300
    every = ["a", "aa", "aaa"]
    long_text = "hello " * 20 + "a" * 400 + " hello"
    long_starts = ctx.torch.arange(124)
    shapes = [
        ("E = 2, overflowing starts", make_engine(ctx, over, L.new().edits(2)),
         spelled(over, 500, 700, 300), 0.6, None),
        ("E = 3, B = 104", make_engine(ctx, ascii_words, L.new().edits(3)), e3_text, 0.5, None),
        ("E = 4, rounds past the keys on chip", make_engine(ctx, ascii_words, L.new().edits(4)),
         e3_text, 0.3, None),
        ("E = 2, a node of 100 children", make_engine(ctx, deep, L.new().edits(2)),
         spelled(deep, 300, 700, 300), 0.6, None),
        ("E = 1, a 200-character pattern", make_engine(ctx, pool_words, L.new().edits(1)),
         pool_text, 0.8, None),
        ("E = 1, more than 256 classes", make_engine(ctx, wide, L.new().edits(1)),
         spelled(wide, 0, 600, 400), 0.7, None),
        ("E = 2, more than 256 classes", make_engine(ctx, wide2, L.new().edits(2)),
         spelled(wide2, 0, 620, 400), 0.6, None),
        ("E = 1, no start emits", make_engine(ctx, ascii_words, L.new().edits(1)), none_text,
         0.8, None),
        ("E = 2, no start emits", make_engine(ctx, ascii_words, L.new().edits(2)), none_text,
         0.8, None),
        ("E = 1, every start emits", make_engine(ctx, every, L.new().edits(1)), "a" * 3000,
         0.8, None),
        ("E = 2, every start emits", make_engine(ctx, every, L.new().edits(2)), "a" * 3000,
         0.6, None),
        ("E = 1, a 400-character pattern", make_engine(ctx, ["a" * 400, "hello"],
                                                        L.new().edits(1)),
         long_text, 0.8, long_starts),
    ]
    assert [s[0] for s in shapes] == list(FRONTIER_SHAPE_NEEDS)
    return shapes


def frontier_shape_checks(ctx) -> list:
    """Phase 4j (e): both frontier kernels and the order kernel against
    their plain versions on the card at ``frontier_shapes``, in chunks of
    256 (several chunks, the last short). Each shape must reach what
    ``FRONTIER_SHAPE_NEEDS`` names: overflowed starts, rounds sorted in
    memory, the tables on chip or in global memory, starts handed from the
    pool's thread path to its warp path, a pool's or a sorted warp's global
    scratch, int32 ids, no emission (no write phase), every start emitting,
    the order kernel's histograms in global memory."""
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    torch = ctx.torch
    recs = []
    for title, engine, text, thr, starts in frontier_shapes(ctx):
        t0 = time.perf_counter()
        n = len(view_of(text, engine.case_insensitive))
        starts = torch.arange(n) if starts is None else starts
        rec = compare_frontier(ctx, engine, text, thr, starts, title, nchunk=256)
        rec["what"], rec["seconds"] = title, time.perf_counter() - t0
        log(f"    {rec['seconds']:.1f} s")
        reached = {
            "overflow": rec["overflowed"] > 0,
            "memory sort": rec["memory_sorted_rounds"] > 0,
            "tables on chip": rec["tables_on_chip"],
            "tables global": not rec["tables_on_chip"],
            "sort scratch": rec["E"] >= 2 and rec["spilled_starts"] > 0,
            "pool scratch": rec["E"] == 1 and rec["spilled_starts"] > 0,
            "handed on": rec["E"] == 1 and rec["handed_starts"] > 0,
            "int32": rec["ids"] == "torch.int32",
            "no emission": rec["emissions"] == 0,
            "every start emits": rec["emitting_starts"] == rec["starts"],
            "order histograms global": not rec["order_hist_on_chip"] and rec["emissions"] > 0,
        }
        rec["reached"] = [k for k in FRONTIER_SHAPE_NEEDS[title] if reached[k]]
        require(rec["reached"] == list(FRONTIER_SHAPE_NEEDS[title]),
                f"{title}: reached {rec['reached']} of {list(FRONTIER_SHAPE_NEEDS[title])}")
        require(rec["emissions"] > 0 or "no emission" in rec["reached"], f"{title}: no emission")
        recs.append(rec)
    return recs


def beam_cell(ctx, tag: str, engine, text: str, thr: float, locked, want, oracle_locked=True):
    """Phase 4j (a)-(d): one beam-lane search through ``search_raw`` over
    ``text``: a first search (transcodes and uploads), then best of 3, the
    plain versions locked out (and the oracle, unless the search may rescue
    an overflowed start), the launch counters set to 0 just before and read
    just after. It must report ``device-fuzzy`` and equal ``want``, the
    context oracle's set. Then its stages alone (``beam_stage_profile``)
    and the whole search profiled once."""
    torch, tpb = ctx.torch, ctx.tpb
    t_phase = time.perf_counter()
    lock = locked if oracle_locked else [t for t in locked if t[0] is not ctx.oracle]
    reset_launches(tpb)
    with plain_locked(*lock):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = engine.search_raw(text, thr)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = engine.search_raw(text, thr)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = dict(tpb.LAUNCHES)
    stats = dict(engine.last_stats)
    keys = [match_key(m) for m in got]
    best = min(times)
    log(f"  {len(text.encode())} bytes ({stats['positions']} graphemes), first search "
        f"{first_s:.3f} s, best of 3 {best * 1e3:.3f} ms (all "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) = {len(text.encode()) / best / 1e6:.2f} "
        f"MB/s, {len(got)} matches; last_stats {stats}; launches {launches}")
    require(stats["backend"] == "device-fuzzy", f"{tag}: backend {stats['backend']}")
    for frontier_key, _k in FRONTIER_KERNELS[min(engine.max_edits_fast, 2)][0]:
        require(launches[frontier_key] > 0, f"{tag}: the search did not launch {frontier_key}")
    require(len(set(keys)) == len(keys), f"{tag}: a match repeats")
    outside, missing = set(keys) - want, want - set(keys)
    log(f"  context oracle: {len(want)} matches; equal {not outside and not missing} "
        f"({len(outside)} found outside it, {len(missing)} missing)")
    require(not outside and not missing, f"{tag}: the beam lane differs from the context oracle")
    with plain_locked(*lock):
        stages = beam_stage_profile(ctx, engine, text, thr)
        prof = profile_search(torch, lambda: engine.search_raw(text, thr), 1, tpb.LAUNCHES)
    st = stages.counted
    f_bytes = st["states"] * (60 + 60 + 2) + stages.emissions * 36
    f_bound = bound_ms(f_bytes, 0, INT_RATE)
    a_bound = anchors_bound(ctx, engine, thr, stages)
    log(f"  anchors {stages.anchors} ({stages.anchors / stages.n:.4f} of the positions), "
        f"frontier: {st['rounds']} rounds, {st['states']} states expanded, "
        f"{stages.emissions} emissions, {stages.overflow} overflowed starts; frontier "
        f"launches {({k: v for k, v in stages.prof_f['counted'].items() if v})}")
    for name, p in (("candidate starts", stages.prof_a), ("frontier", stages.prof_f),
                    ("whole search", prof)):
        log(f"  {name}: wall {p['wall']:.3f} ms, device busy {p['busy']:.3f} ms "
            f"({p['busy'] / p['wall']:.3f} of wall), {p['kernels']:.0f} kernel launches, "
            f"{p['copies']:.0f} copies, {p['waits']:.0f} host waits")
        for line in p["lines"][:6]:
            log(f"    {line}")
    log(f"  frontier bound (each expanded state read and written once, 60 bytes each, its two "
        f"symbols, each emission's 36 bytes): {f_bound[0]:.4f} ms by {f_bound[1]} = "
        f"{f_bound[0] / stages.prof_f['wall']:.2e} of its wall; {stages.chunks} chunks of "
        f"{stages.nchunk} starts (the JAX package's) in {stages.runs} runs of the frontier")
    log(f"  candidate starts bound (the text's symbols read once, the anchors written once, "
        f"the scan's integer instructions): {a_bound[0]:.4f} ms by {a_bound[1]} = "
        f"{a_bound[0] / stages.prof_a['wall']:.2e} of its wall")
    log(f"  phase {tag} {time.perf_counter() - t_phase:.1f} s")
    return SimpleNamespace(times=times, first_s=first_s, launches=launches, stats=stats,
                           matches=len(got), stages=stages, prof=prof, f_bytes=f_bytes,
                           f_bound=f_bound, a_bound=a_bound, nbytes=len(text.encode()))


def beam_record(tag: str, run) -> dict:
    """Phase 4j's line in the final JSON's ``torch_paths``."""
    st, p = run.stages, run.prof
    return {"name": f"beam lanes {tag}", "route": "torch", "bytes": run.nbytes,
            "positions": st.n, "anchors": st.anchors, "matches": run.matches,
            "overflow_rescues": run.stats.get("overflow_rescues"),
            "ms": [t * 1e3 for t in run.times], "first_s": run.first_s,
            "launches": run.launches, "search_kernels": p["kernels"],
            "search_copies": p["copies"], "search_waits": p["waits"],
            "search_wall_ms": p["wall"], "search_device_busy_ms": p["busy"],
            "anchors_wall_ms": st.prof_a["wall"], "anchors_busy_ms": st.prof_a["busy"],
            "anchors_kernels": st.prof_a["kernels"], "frontier_wall_ms": st.prof_f["wall"],
            "frontier_busy_ms": st.prof_f["busy"], "frontier_kernels": st.prof_f["kernels"],
            "frontier_waits": st.prof_f["waits"], "frontier_states": st.counted["states"],
            "frontier_rounds": st.counted["rounds"], "emissions": st.emissions,
            "chunks": st.chunks, "chunk_starts": st.nchunk,
            "frontier_bound_ms": run.f_bound[0], "frontier_bound_by": run.f_bound[1],
            "anchors_bound_ms": run.a_bound[0], "anchors_bound_by": run.a_bound[1]}


def beam_kernel_checks(ctx, fuzzy, joined: str, long_e, long_txt: str) -> tuple:
    """Phase 4j (e), the kernels: ``scan_bits``, ``block_offsets`` and
    ``hit_words`` against their plain versions on what 4j hands them: the
    packed anchors' segments of (a) (``STREAM_CHUNK`` symbols and their
    halo, the prefilter's tables at 0.8) and the seed engine's exact pass of
    (d) over its text. Returns the three max_abs_err."""
    import numpy as np

    tpb, torch = ctx.tpb, ctx.torch
    errs = [0, 0, 0]
    pk = tpb.packed_fuzzy_of(fuzzy)
    thr = np.float32(0.8)
    ks = [pk.filt.k_for(bp, thr) for bp in pk.filt.patterns]
    match, init, k = pk.fuzzy_masks(ks)
    halo = pk.m_max + k
    T = tpb.tables_from_numpy(pk.word_tbl, pk.starts, match, init, device=ctx.dev)
    ids = np.ascontiguousarray(pk.filt.transcode(joined)[0], dtype=np.uint8)
    n = len(ids)
    t0 = time.perf_counter()
    hits = 0
    for c0 in range(0, n, tpb.STREAM_CHUNK):
        lo, hi = max(0, c0 - halo), min(n, c0 + tpb.STREAM_CHUNK + halo)
        seg = torch.from_numpy(ids[lo:hi]).to(ctx.dev)
        c, e = compare_scan(tpb, torch, seg, T, halo, f"4j (a) anchors' segment [{lo}, {hi})",
                            want_hits=False)
        hits += c
        errs = [max(a, b) for a, b in zip(errs, e)]
    require(hits > 0, "4j (a): no hits in the anchors' segments")
    log(f"  (a)'s segments {time.perf_counter() - t0:.1f} s")
    seed = long_e._seed_filter_cache.seed_engine
    spk = tpb.packed_exact_of(seed)
    Ts, _cols, _shs = tpb._exact_consts(seed, spk, ctx.dev)
    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    sids, sn = device_corpus.resident(
        long_txt, ("pk-exact", tpb._space_token(seed)),
        lambda h: spk.transcode(h, view_of(h, seed.case_insensitive), seed.dense), ctx.dev)
    _c, e = compare_scan(tpb, torch, sids[:sn], Ts, spk.m_max,
                         f"4j (d) seed engine's exact pass ({len(seed.patterns())} pieces, "
                         f"W={spk.W})")
    errs = [max(a, b) for a, b in zip(errs, e)]
    return errs


def small_entry_points(ctx, fuzzy, many_e, corpus: str, many_text: str, locked, keyf):
    """Phase 4i (d): ``with_prefilter().search`` against ``search`` on 1 MiB;
    ``save`` then ``load(device="cuda")`` of the fuzzy1 and many1k engines,
    each loaded engine equal on 1 MiB; ``search_basic`` (the bench's
    39-character haystack), microseconds per call over 300 calls on the
    native host BFS, equal to the oracle."""
    import shutil
    import tempfile

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasick, SearchOptions

    tpb = ctx.tpb
    out = {}
    part = corpus[: 1 << 20]
    opts = SearchOptions.new().with_threshold(0.8).sorted().non_overlapping()
    reset_launches(tpb)
    with plain_locked(*locked):
        pf = fuzzy.with_prefilter()
        got = [keyf(m) for m in pf.search(part, opts)]
        pf_backend = fuzzy.last_stats["backend"]
        want = [keyf(m) for m in fuzzy.search(part, opts)]
    launches = dict(tpb.LAUNCHES)
    log(f"  with_prefilter().search on {len(part)} bytes: active {pf.is_active()}, backend "
        f"{pf_backend}, {len(got)} matches, equal to search {got == want}; launches {launches}")
    require(pf.is_active() and pf_backend == "device-fuzzy-dp", "prefilter: not the device path")
    require(got == want and len(got) > 100, "prefilter differs from search")
    out["prefilter"] = {"matches": len(got), "launches": launches}

    scratch = os.path.join(HERE, "build", "smoke")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    try:
        for name, eng, text, thr, backend in (
            ("fuzzy1", fuzzy, part, 0.8, "device-fuzzy-dp"),
            ("many1k", many_e, many_text[: 1 << 20], MANY_THRESHOLD, "device-fuzzy-many"),
        ):
            path = os.path.join(tmp, f"{name}.npz")
            t0 = time.perf_counter()
            eng.save(path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = FuzzyAhoCorasick.load(path, device="cuda")
            load_s = time.perf_counter() - t0
            loaded.backend = "device"
            reset_launches(tpb)
            with plain_locked(*locked):
                got = sorted(map(keyf, loaded.search_raw(text, thr)))
                lb = loaded.last_stats["backend"]
                want = sorted(map(keyf, eng.search_raw(text, thr)))
            launches = dict(tpb.LAUNCHES)
            log(f"  {name}: save {save_s:.3f} s ({os.path.getsize(path)} bytes), load "
                f"{load_s:.3f} s on {loaded.device}; loaded engine {lb}, {len(got)} matches on "
                f"{len(text)} bytes, equal {got == want}; launches {launches}")
            require(loaded.device.type == "cuda" and lb == backend, f"{name}: loaded engine's lane")
            require(got == want and len(got) > 10, f"{name}: loaded engine differs")
            out[f"save_load_{name}"] = {"save_s": save_s, "load_s": load_s, "matches": len(got),
                                        "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    basic = (ctx.Builder.new().fuzzy(ctx.Limits.new().edits(1)).case_insensitive(True)
             .device(ctx.dev).build(BASIC_WORDS))
    with plain_locked(*locked):
        basic.search_raw(BASIC_HAY, 0.7)
        reps = 300
        t0 = time.perf_counter()
        for _ in range(reps):
            got = basic.search_raw(BASIC_HAY, 0.7)
        us = (time.perf_counter() - t0) / reps * 1e6
        backend = basic.last_stats["backend"]
    got = sorted(map(keyf, got))
    basic.backend = "oracle"
    want = sorted(map(keyf, basic.search_raw(BASIC_HAY, 0.7)))
    log(f"  search_basic: {us:.2f} us per call over {reps} calls, backend {backend}, "
        f"{len(got)} matches, equal to the oracle {got == want}")
    require(backend == "native-bfs", "search_basic did not run the native BFS")
    require(got == want and len(got) == 10, "search_basic differs from the oracle")
    out["search_basic_us"] = us
    return out


# ---------------------------------------------------------------------------
# Phase 4e'': mapped4, the mapped lane past six scan rows at full size
# ---------------------------------------------------------------------------

#: OCR post-correction of names (``rn`` read for ``m``): 16 two-word names of
#: 18-24 characters (6 scan limbs) from the 13 headline words that are not
#: the corpus's ``NEEDLES``, name i = ``w[i % 13] + " " + w[(i + 5 + i // 13)
#: % 13]``. Three words (26-38 characters) would pass the mapped DP's 24
#: rows (``verify_dp.MAPPED_LMAX``) and 8 scan limbs, where both packages'
#: mapped lane declines; a name holding a needle would make each of the
#: corpus's ~12,000 needles a hit of the 8-row scan, three quarters of the
#: oracle's windows, with no match among them.
_MAPPED4_BASE = [w for w in HEADLINE if w not in NEEDLES]
MAPPED4_WORDS = [_MAPPED4_BASE[i % 13] + " " + _MAPPED4_BASE[(i + 5 + i // 13) % 13]
                 for i in range(16)]
MAPPED4_THRESHOLD = 0.8
#: Copies of the names planted in the 96 MiB corpus, each with 1-4 edits.
MAPPED4_COPIES = 4000
#: The prefix over which the oracle runs in whole (the host oracle takes
#: about 1.4 ms a character at edits(4) on these names).
MAPPED4_PREFIX = 32 << 10


def plant_phrases(text: str, seed: int, count: int, phrases):
    """``text`` (ASCII) with ``count`` of ``phrases`` written over it at
    seeded positions, in every second copy each ``m`` written ``rn`` first,
    then 1-4 ``edit()``s. Returns (text, [(start, end)] of the copies)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    buf = bytearray(text.encode())
    spans = []
    for j, at in enumerate(rng.integers(0, len(buf) - 64, size=count).tolist()):
        w = phrases[int(rng.integers(len(phrases)))]
        if j % 2:
            w = w.replace("m", "rn")
        for _ in range(int(rng.integers(1, 5))):
            w = edit(w, rng)
        buf[at:at + len(w)] = w.encode()
        spans.append((at, at + len(w)))
    return buf.decode(), spans


def merged_windows(intervals):
    """[lo, hi) intervals merged where they overlap or touch, ascending."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(w) for w in out]


def _oracle_windows(job):
    """Worker: the oracle's match keys over each of ``texts``, positions
    relative to the text."""
    name, thr, texts = job
    import torch

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern, oracle

    ctx = SimpleNamespace(dev=torch.device("cpu"), Builder=FuzzyAhoCorasickBuilder,
                          Limits=FuzzyLimits, Pattern=Pattern)
    engine = recipe_engine(ctx, name)
    return [[match_key(m) for m in oracle.search_raw(engine, t, thr)] for t in texts]


def mapped4_start(ctx, corpus: str, pool, workers: int):
    """Phase 3's share of phase 4e'': the mapped4 text (``corpus`` with
    ``MAPPED4_COPIES`` names planted), the engine, and the oracle's searches
    dealt out to the workers: over every merged window around a planted copy
    or a hit of the PLAIN scan on the card (``scan_bits_torch`` on the
    lane's own tables: a superset of match ends that no kernel computes),
    each hit with the ``m_max + E`` characters before it (the longest span
    a match has), and over the first ``MAPPED4_PREFIX`` characters in whole.
    Returns a namespace for :func:`mapped4_bar`."""
    torch, np, tpb, vdp = ctx.torch, ctx.np, ctx.tpb, ctx.vdp
    t0 = time.perf_counter()
    text, spans = plant_phrases(corpus, SEED + 23, MAPPED4_COPIES, MAPPED4_WORDS)
    engine = recipe_engine(ctx, "mapped4")
    pk = tpb.packed_fuzzy_of(engine)
    plan, run = lane_inputs(vdp, engine, text, MAPPED4_THRESHOLD, "mapped4")
    require(plan.k == 8 and not plan.dam and pk.W <= tpb.MAX_LIMBS,
            f"mapped4: scan budget {plan.k}, W {pk.W}")
    ids = torch.from_numpy(np.ascontiguousarray(pk.filt.transcode(text)[0])).to(ctx.dev)
    bits, _counts = tpb.scan_bits_torch(ids, run.T_scan, run.halo)
    hits = torch.nonzero(tpb.hit_flags(bits, ids.numel())).reshape(-1).cpu().numpy()
    reach = pk.m_max + plan.E
    windows = merged_windows([(max(0, p - reach + 1), p + 1) for p in hits.tolist()] + spans)
    # The prefix first (the longest job), then the windows in 8 shares a
    # worker, taken as workers come free.
    prefix = pool.apply_async(_oracle_windows,
                              (("mapped4", MAPPED4_THRESHOLD, [text[:MAPPED4_PREFIX]]),))
    shares = [list(range(len(windows)))[j::8 * workers] for j in range(8 * workers)]
    jobs = [("mapped4", MAPPED4_THRESHOLD, [text[slice(*windows[i])] for i in share])
            for share in shares]
    pending = pool.map_async(_oracle_windows, jobs, chunksize=1)
    covered = sum(hi - lo for lo, hi in windows)
    log(f"  mapped4: {len(MAPPED4_WORDS)} names of {min(map(len, MAPPED4_WORDS))}-"
        f"{max(map(len, MAPPED4_WORDS))} characters, W = {pk.W} limbs, A = {pk.A}, scan budget "
        f"k = {plan.k}, halo {run.halo}; {MAPPED4_COPIES} copies planted; the plain scan on the "
        f"card: {hits.size} hits; {len(windows)} merged windows of {covered} characters "
        f"({covered / len(text):.5f} of the text) dealt to the oracle's {workers} workers with "
        f"the first {MAPPED4_PREFIX} characters in whole; {time.perf_counter() - t0:.1f} s")
    return SimpleNamespace(text=text, engine=engine, windows=windows, shares=shares,
                           pending=pending, prefix=prefix, plain_hits=int(hits.size))


def mapped4_bar(m4):
    """The oracle's match set over mapped4's windows (``mapped4_start``),
    shifted to the text's positions, and the window count."""
    want = set()
    for share, found in zip(m4.shares, m4.pending.get()):
        for i, keys in zip(share, found):
            lo = m4.windows[i][0]
            want.update((p, lo + st, lo + en, *rest) for p, st, en, *rest in keys)
    return want, len(m4.windows)


def anchors_deep_check(ctx, text: str) -> int:
    """``fuzzy_anchors_packed`` at a plain budget of 8 rows (``edits(4)`` at
    0.5) on the card, resident and streamed in segments with halos, against
    the same call with the engine on the CPU; the card's calls must launch
    the deep scan instance. Returns the anchor count."""
    torch, np, tpb = ctx.torch, ctx.np, ctx.tpb
    words = ["sollicitudin", "ullamcorper", "pellentesque"]
    thr = np.float32(0.5)
    card = make_engine(ctx, words, ctx.Limits.new().edits(4))
    host = ctx.Builder.new().fuzzy(ctx.Limits.new().edits(4)).case_insensitive(True).device(
        "cpu").build(words)
    pk = tpb.packed_fuzzy_of(card)
    k = max(pk.filt.k_for(bp, thr) for bp in pk.filt.patterns)
    require(k == 8, f"the anchors' budget is {k}")
    n = 0
    saved = tpb.RESIDENT_MAX, tpb.STREAM_CHUNK
    for form, limits in (("resident", saved), ("streamed, 64 KiB segments", (1 << 16, 1 << 16))):
        tpb.RESIDENT_MAX, tpb.STREAM_CHUNK = limits
        try:
            reset_launches(tpb)
            got = tpb.fuzzy_anchors_packed(card, text, thr)
            launched = tpb.LAUNCHES["scan_bits_wide"]
            want = tpb.fuzzy_anchors_packed(host, text, thr)
        finally:
            tpb.RESIDENT_MAX, tpb.STREAM_CHUNK = saved
        equal = got.cpu().tolist() == want.tolist()
        log(f"  fuzzy_anchors_packed edits(4) at 0.5 (k = {k}), {len(text)} characters, {form}: "
            f"{got.numel()} anchors on the card, {want.numel()} on the CPU, equal {equal}; "
            f"scan_bits_wide launched {launched} times")
        require(equal and 0 < got.numel() < len(text) and launched > 0,
                f"the anchors at k = 8 ({form}) differ from the CPU's")
        n = got.numel()
    return n


# Phase 4k: the sharded lanes and the multi-host entry points (parallel/)
# ---------------------------------------------------------------------------

#: Phase 4k (c) and (d): ``bench.py:552-566``'s recipe, 24 MiB of the corpus,
#: fuzzy1 at 0.8, the first 8 dictionary words upper-cased as the table.
MULTIHOST_BYTES = 24 << 20
MULTIHOST_TABLE = [w.upper() for w in HEADLINE[:8]]
#: The groups of phase 4k's launch counts whose ``dp_pipeline`` launches
#: count on the ``dp_pipeline`` record (the dry run's, of its ``edits(1)``
#: engine, are listed apart in the JSON line).
K4_FAST = ("fuzzy1", "multihost")
#: The group of phase 4k's launch counts that runs the deep scan instances
#: and count_dp_rows_kernel (mapped4's), counted on their own records.
DEEP_K4 = ("mapped4",)
#: Seconds a 4k (d) worker may take, start-up and the process group included.
WORKER_TIMEOUT_S = 300


def sharded_cell(ctx, tag: str, engine, text: str, thr: float, mesh, locked, want_keys,
                 keys: tuple, profile: bool):
    """Phase 4k (a): one sharded search of ``engine`` over ``text`` on
    ``mesh`` (``sharded_exact_search`` for an exact engine, else
    ``sharded_fuzzy_search``): a first search and best of 3, the plain
    versions and the oracle locked out, the launch counters set to 0 just
    before and read just after; the tuples must equal ``want_keys`` (the
    engine's ``search_raw``), the kernels ``keys`` must have launched and no
    other; with ``profile`` the profiler's launches, copies, waits and busy
    share over 2 more searches."""
    from fuzzy_aho_corasick_tpu_torch.parallel.shard_search import (
        sharded_exact_search,
        sharded_fuzzy_search,
    )

    torch, tpb = ctx.torch, ctx.tpb
    exact = engine.max_edits_fast == 0
    search = sharded_exact_search if exact else sharded_fuzzy_search
    backend = "device-exact-sharded" if exact else "device-fuzzy-sharded"
    reset_launches(tpb)
    with plain_locked(*locked):
        t0 = time.perf_counter()
        got = search(engine, text, thr, mesh)
        first = time.perf_counter() - t0
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = search(engine, text, thr, mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = dict(tpb.LAUNCHES)
    stats = dict(engine.last_stats)
    got_keys = sorted(map(match_key, got))
    best = min(times)
    log(f"  {tag}: {len(mesh)} shards on {', '.join(str(d) for d in mesh)}: first "
        f"{first * 1e3:.3f} ms, best of 3 {best * 1e3:.3f} ms (all "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) = {len(text) / best / 1e6:.1f} MB/s, "
        f"{len(got)} matches, equal to search_raw {got_keys == want_keys}; last_stats {stats}; "
        f"launches {launches}")
    require(stats["backend"] == backend and stats["shards"] == len(mesh),
            f"{tag}: last_stats {stats}")
    require(got_keys == want_keys, f"{tag}: the sharded search differs from search_raw")
    require(all(launches[k] > 0 for k in keys), f"{tag}: the search did not launch {keys}")
    require(all(v == 0 for k, v in launches.items() if k not in keys),
            f"{tag}: the search launched a kernel of another lane")
    prof = None
    if profile:
        prof = profile_search(torch, lambda: search(engine, text, thr, mesh), 2, tpb.LAUNCHES)
        log(f"    torch.profiler over 2 searches: wall {prof['wall']:.3f} ms, device busy "
            f"{prof['busy']:.3f} ms ({prof['busy'] / prof['wall']:.4f} of wall); per search "
            f"{prof['kernels']:.1f} kernel launches, {prof['copies']:.1f} copies, "
            f"{prof['waits']:.1f} host waits")
        for line in prof["lines"][:6]:
            log(f"      {line}")
    return SimpleNamespace(first=first, times=times, launches=launches, stats=stats,
                           matches=len(got), prof=prof, nbytes=len(text.encode()))


def host_transcode_ms(engine, text: str) -> float:
    """The host's transcode of ``text`` into the two symbol streams the
    sharded fuzzy lane ships per search (the prefilter's and the dense
    classes'), best of 2, ms."""
    from fuzzy_aho_corasick_tpu_torch.ops.packed_bitap import packed_fuzzy_of
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    pk = packed_fuzzy_of(engine)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        view = view_of(text, engine.case_insensitive)
        pk.filt.transcode(text, hay_bytes=view.hay_bytes() if view.ascii else None)
        engine.dense.transcode(text, view)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def compare_step(tpb, vdp, torch, args, hits: int, what: str, prefix: str = "",
                 want_rows: bool = True, errs=None):
    """``dp_pipeline`` (the count-channel kernel, the list step's or the
    typed step's kernels) against ``dp_pipeline_torch`` on one slice's hits
    and inputs (``args``, the arguments of ``dp_pipeline``): the same rows
    in the same order, bit for bit, the same row tags and the same candidate
    count; for a typed or a list step each kernel of the step against its
    plain version (``compare_step_kernels``); and
    ``block_offsets`` against its plain version on every count array the
    step scans. Returns the step's and block_offsets' max_abs_err; with
    ``errs`` (a dict) the step's kernels' errors are folded into it."""
    rows_k, cand_k, tags_k = vdp.dp_pipeline(*args, tags=True)
    rows_p, cand_p, tags_p = vdp.dp_pipeline_torch(*args, tags=True)
    torch.cuda.synchronize()
    same = rows_k.shape == rows_p.shape and cand_k == cand_p and torch.equal(tags_k, tags_p)
    err = float((rows_k.long() - rows_p.long()).abs().max()) if same and rows_k.numel() else 0.0
    n_counts, err_offs = [], 0
    if hits:
        for counts in vdp.dp_pipeline_counts(*args) if step_kind(vdp, args) == "pipeline" else ():
            n_counts.append(counts.numel())
            err_offs = max(err_offs, int((tpb.block_offsets(counts).long()
                                          - tpb.block_offsets_torch(counts).long()).abs().max()))
        if step_kind(vdp, args) != "pipeline":
            for key, e in compare_step_kernels(tpb, vdp, torch, args, what).items():
                if errs is not None:
                    errs[key] = max(errs.get(key, 0), e)
    log(f"  {what}: {prefix}hits={hits} candidates={cand_k} vs {cand_p} rows={rows_k.shape[0]} "
        f"vs {rows_p.shape[0]}, max_abs_err {err}; block_offsets over the step's {n_counts} "
        f"counts, max_abs_err {err_offs}")
    require(same and err == 0.0, f"{what}: dp_pipeline disagrees with dp_pipeline_torch")
    require(err_offs == 0, f"{what}: block_offsets disagrees on the step's counts")
    require(rows_p.shape[0] > 0 or not want_rows, f"{what}: no rows to compare")
    if errs is not None:
        key = STEP_ERR[step_kind(vdp, args)]
        errs[key] = max(errs.get(key, 0), err)
    return err, err_offs


def shard_kernel_checks(ctx, engine, text: str, thr: float, mesh, what: str, errs: dict):
    """Phase 4k (e): one ``sharded_fuzzy_search`` of ``engine`` over ``text``
    on ``mesh`` with the inputs it hands the scan and the step captured
    (``packed_hits`` and ``dp_pipeline_ranges`` wrapped), then on the first
    shard's extended buffers (a zero left halo) and the last's (a zero right
    margin) the scan's three kernels and the step's kernels against their
    plain versions, bit for bit. Folds the max_abs_err into ``errs``."""
    from fuzzy_aho_corasick_tpu_torch.parallel.shard_search import sharded_fuzzy_search

    tpb, vdp, torch = ctx.tpb, ctx.vdp, ctx.torch
    scans, steps = [], []
    hits_fn, ranges_fn = tpb.packed_hits, vdp.dp_pipeline_ranges

    def spy_hits(ids, T, halo, *rest):
        scans.append((ids, T, halo))
        return hits_fn(ids, T, halo, *rest)

    def spy_ranges(pos, words, max_hits, *args):
        steps.append((pos, words, args))
        return ranges_fn(pos, words, max_hits, *args)

    tpb.packed_hits, vdp.dp_pipeline_ranges = spy_hits, spy_ranges
    try:
        sharded_fuzzy_search(engine, text, thr, mesh)
    finally:
        tpb.packed_hits, vdp.dp_pipeline_ranges = hits_fn, ranges_fn
    require(len(scans) == len(steps) == len(mesh), f"{what}: {len(scans)} scans captured")
    for d, edge in ((0, "zero left halo"), (len(mesh) - 1, "zero right margin")):
        ids, T, halo = scans[d]
        hits, e_scan = compare_scan(tpb, torch, ids, T, halo, f"{what}, shard {d} ({edge})")
        for key, e in zip(("scan_bits", "block_offsets", "hit_words"), e_scan):
            errs[key] = max(errs.get(key, 0), e)
        pos, words, args = steps[d]
        require(pos.numel() == hits, f"{what}, shard {d}: the captured hit list")
        window = args[0]
        err, err_offs = compare_step(
            tpb, vdp, torch, (pos, words) + tuple(args), hits, f"{what}, shard {d}",
            f"window [{window.start_lo}, {window.start_hi}) of {ids.numel()} symbols, ",
            errs=errs)
        key = STEP_ERR[step_kind(vdp, (pos, words) + tuple(args))]
        errs[key] = max(errs.get(key, 0), err)
        errs["block_offsets"] = max(errs["block_offsets"], err_offs)


def multihost_worker(argv) -> int:
    """Phase 4k (d), one process: ``initialize`` (rank ``argv[2]`` of 2, rank
    0 on ``127.0.0.1:argv[1]``), then ``search_multihost`` (a warm-up and
    one timed) and ``replace_multihost`` over the bytes of ``argv[3]`` with
    the fuzzy1 engine on ``cuda:0``; writes its match rows and segment
    beside them and prints one ``WORKER`` JSON line (times, launches)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.parallel import multihost

    port, rank, path = argv[0], int(argv[1]), argv[2]
    t0 = time.perf_counter()
    require(multihost.initialize(f"127.0.0.1:{port}", 2, rank, timeout_s=WORKER_TIMEOUT_S)
            == rank, "initialize returned another rank")
    init_s = time.perf_counter() - t0
    ctx = SimpleNamespace(dev=torch.device("cuda", 0), Builder=FuzzyAhoCorasickBuilder,
                          Limits=FuzzyLimits, Pattern=Pattern)
    engine = recipe_engine(ctx, "fuzzy1")
    with open(path, "rb") as f:
        corpus = f.read()
    multihost.search_multihost(engine, corpus, 0.8)
    reset_launches(tpb)
    t0 = time.perf_counter()
    found = multihost.search_multihost(engine, corpus, 0.8)
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = multihost.replace_multihost(engine, corpus, 0.8, MULTIHOST_TABLE)
    replace_s = time.perf_counter() - t0
    launches = dict(tpb.LAUNCHES)
    np.save(f"{path}.rows{rank}.npy", multihost._encode_matches(found))
    with open(f"{path}.seg{rank}", "wb") as f:
        f.write(seg)
    print("WORKER " + json.dumps({
        "rank": rank, "world": dist.get_world_size(), "init_s": init_s, "search_s": search_s,
        "replace_s": replace_s, "matches": len(found), "segment_bytes": len(seg),
        "backend": engine.last_stats["backend"], "launches": launches}), flush=True)
    dist.destroy_process_group()
    return 0


def run_workers(path: str):
    """Phase 4k (d): two ``multihost_worker`` processes joined by
    ``initialize``, both on ``cuda:0``. Returns their ``WORKER`` records.
    A worker that fails or passes ``WORKER_TIMEOUT_S`` fails the phase, and
    every worker still running then is killed."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke.multihost_worker(sys.argv[2:]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, HERE, str(port), str(rank), path],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    records = []
    try:
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                raise AssertionError(f"4k (d): worker {rank} passed {WORKER_TIMEOUT_S} s:\n"
                                     f"{err[-3000:]}")
            lines = [l for l in out.splitlines() if l.startswith("WORKER ")]
            require(proc.returncode == 0 and len(lines) == 1,
                    f"4k (d): worker {rank} exited {proc.returncode}:\n{out[-2000:]}{err[-3000:]}")
            records.append(json.loads(lines[0][len("WORKER "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return records


def multihost_cells(ctx, fuzzy, corpus: str, locked):
    """Phase 4k (c) and (d): ``replace_multihost`` to the bench's recipe
    (``bench.py:552-566``) over the first ``MULTIHOST_BYTES`` of the corpus
    with two logical hosts in this process (best of 3, MB/s; one more pass
    with each host's slice sharded over 3 logical shards of the card),
    equal to ``replace_stream``; then two processes under ``initialize``:
    both ranks' match lists identical and equal to the whole-input
    ``search_raw``, their segments concatenated in rank order equal to
    (c)'s bytes."""
    import io
    import shutil
    import tempfile

    import numpy as np

    from fuzzy_aho_corasick_tpu_torch.parallel import multihost

    torch, tpb = ctx.torch, ctx.tpb
    text = corpus[:MULTIHOST_BYTES]
    src = text.encode()
    out = {}
    reset_launches(tpb)
    with plain_locked(*locked):
        multihost.replace_multihost(fuzzy, src, 0.8, MULTIHOST_TABLE, 2)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = multihost.replace_multihost(fuzzy, src, 0.8, MULTIHOST_TABLE, 2)
            times.append(time.perf_counter() - t0)
        launches = dict(tpb.LAUNCHES)
        sharded = multihost.replace_multihost(fuzzy, src, 0.8, MULTIHOST_TABLE, 2,
                                              [ctx.dev] * 3)
        sharded_backend = fuzzy.last_stats["backend"]
        whole = sorted(map(match_key, fuzzy.search_raw(text, 0.8)))
        seq = io.BytesIO()
        fuzzy.replace_stream(io.BytesIO(src), seq, 0.8, lambda m: (
            MULTIHOST_TABLE[m.pattern_index] if m.pattern_index < len(MULTIHOST_TABLE) else None))
    seq = seq.getvalue()
    best = min(times)
    n_rep = sum(got.count(w.encode()) for w in MULTIHOST_TABLE)
    log(f"  (c) replace_multihost, 2 logical hosts, {len(src)} bytes: best of 3 "
        f"{best * 1e3:.3f} ms (all {', '.join(f'{t * 1e3:.3f}' for t in times)}) = "
        f"{len(src) / best / 1e6:.1f} MB/s, {len(got)} bytes out, {n_rep} replacements, equal to "
        f"replace_stream {got == seq}; with 3 logical shards per host ({sharded_backend}) equal "
        f"{sharded == got}; launches {launches}")
    require(got == seq, "4k (c): replace_multihost differs from replace_stream")
    require(sharded == got and sharded_backend == "device-fuzzy-sharded",
            "4k (c): the sharded hosts' replace differs")
    require(all(launches[k] > 0 for k in ("scan_bits", "block_offsets", "hit_words",
                                          "dp_pipeline")),
            "4k (c): replace_multihost did not launch the fuzzy lane's kernels")
    require(n_rep > 1000, "4k (c): too few replacements to be a real check")
    out["c"] = {"bytes": len(src), "ms": [t * 1e3 for t in times],
                "mb_per_s": len(src) / best / 1e6, "replacements": n_rep, "launches": launches}

    scratch = os.path.join(HERE, "build", "smoke")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    try:
        path = os.path.join(tmp, "corpus.bin")
        with open(path, "wb") as f:
            f.write(src)
        t0 = time.perf_counter()
        records = run_workers(path)
        wall = time.perf_counter() - t0
        rows = [np.load(f"{path}.rows{r}.npy") for r in range(2)]
        segs = []
        for r in range(2):
            with open(f"{path}.seg{r}", "rb") as f:
                segs.append(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gathered = [sorted(map(match_key, multihost._decode_matches(fuzzy, src, r))) for r in rows]
    log(f"  (d) 2 processes under initialize (gloo), both on cuda:0, {wall:.1f} s of wall: "
        + "; ".join(f"rank {rec['rank']}: init {rec['init_s']:.2f} s, search_multihost "
                    f"{rec['search_s'] * 1e3:.1f} ms, replace_multihost "
                    f"{rec['replace_s'] * 1e3:.1f} ms, {rec['matches']} matches, segment "
                    f"{rec['segment_bytes']} bytes, {rec['backend']}, launches {rec['launches']}"
                    for rec in records))
    log(f"  (d) the ranks' lists identical {np.array_equal(rows[0], rows[1])}, equal to the "
        f"whole-input search_raw {gathered[0] == whole}; segments concatenated equal to (c) "
        f"{segs[0] + segs[1] == got}")
    require(np.array_equal(rows[0], rows[1]), "4k (d): the two ranks' lists differ")
    require(gathered[0] == whole, "4k (d): the gathered list differs from the whole-input search")
    require(len(whole) > 1000, "4k (d): too few matches to be a real check")
    require(segs[0] + segs[1] == got, "4k (d): the segments differ from (c)'s bytes")
    require(all(rec["world"] == 2 for rec in records), "4k (d): a worker's group is not of 2")
    require(all(rec["launches"][k] > 0 for rec in records
                for k in ("scan_bits", "block_offsets", "hit_words", "dp_pipeline")),
            "4k (d): a worker did not launch the fuzzy lane's kernels")
    out["d"] = {"wall_s": wall, "workers": records, "matches": len(whole)}
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: {PKG}/ is not beside this script; run it from the "
              "repository root", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import multiprocessing

    # The context oracle's worker processes, one set for the run, started
    # once the kernels are built and stopped however the run ends.
    workers = max(1, min(8, os.cpu_count() or 1))
    pools = []

    def start_pool():
        pools.append(multiprocessing.get_context("spawn").Pool(
            workers, initializer=_oracle_worker_init))
        return pools[0]

    try:
        return smoke(torch, start_pool, workers)
    finally:
        for pool in pools:
            pool.terminate()
            pool.join()


def smoke(torch, start_pool, workers: int) -> int:
    """Phases 1-6 on the card; ``start_pool()`` starts the context oracle's
    ``workers`` processes."""
    import numpy as np

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern, oracle
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build, exact, many
    from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as tfz
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as vdp
    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    dev = torch.device("cuda")
    ctx = SimpleNamespace(torch=torch, np=np, tpb=tpb, vdp=vdp, many=many, dev=dev, oracle=oracle,
                          Builder=FuzzyAhoCorasickBuilder, Limits=FuzzyLimits, Pattern=Pattern)
    t_start = time.perf_counter()

    def phase(title):
        log(f"{title} [{time.perf_counter() - t_start:.1f} s into the run]")

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("phase 1 card:")
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    kern = _cuda_build.load()
    ctx.kern = kern
    main_lines, n_inst, n_spill, max_regs = ptxas_summary(kern.log)
    log(f"phase 2 build: {kern.path.relative_to(HERE)} nvcc {kern.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s); {n_inst} kernel instantiations, "
        f"{n_spill} with spills, max {max_regs} registers")
    for line in kern.log.splitlines():
        if line.startswith("[done "):
            log(f"  nvcc job {line}")
    for line in main_lines:
        log(f"  ptxas {line}")

    # 3. kernel vs plain on the card
    phase("phase 3 kernel vs plain:")
    pool = ctx.pool = start_pool()
    ctx.workers = workers
    corpus = build_corpus(CORPUS_BYTES, SEED)
    require(len(corpus) == CORPUS_BYTES, "corpus size")
    mapped_corpus = sparse_modem(corpus)
    many_text = many_corpus(corpus[:MANY_BYTES], many_words(1000, 7))

    # The context oracle of phases 4b-4e: the contexts once per corpus, the
    # oracle searches once per engine, begun here in the worker processes
    # beside the comparisons of this phase and of phase 5, which no clock on
    # the host times.
    t0 = time.perf_counter()
    mapped_contexts = pool.apply_async(word_contexts, (mapped_corpus,))
    many_contexts = pool.apply_async(word_contexts, (many_text,))
    # Phase 4i's stream past RESIDENT_MAX: the corpus, a space, the corpus.
    joined = corpus + " " + corpus
    joined_contexts = pool.apply_async(word_contexts, (joined,))
    # Phase 4j's texts: two CJK corpora (contexts by characters) and the
    # many1k corpus with a-runs.
    beam_texts = {name: cjk_corpus(MANY_BYTES, SEED + 21 + i, beam_words(name),
                                   CJK_FILLER_LEN[name])
                  for i, name in enumerate(("cjk1", "cjk2"))}
    beam_texts["long"] = arun_text(many_text)
    beam_contexts = {name: pool.apply_async(cjk_contexts, (text, CJK_TAIL[name]))
                     for name, text in beam_texts.items() if name != "long"}
    beam_contexts["long"] = pool.apply_async(word_contexts, (beam_texts["long"],))
    contexts_of, pending = {corpus: word_contexts(corpus)}, {}
    results_of = {}  # (name, text, thr) -> the oracle's per-context results

    def oracle_start(name, text, thr):
        if text not in contexts_of:
            contexts_of[text] = word_contexts(text)
        pending[name, text, thr] = context_oracle_start(pool, workers, name, thr,
                                                        contexts_of[text][0])
        results_of[name, text, thr] = pending[name, text, thr]

    def oracle_set(name, text, thr):
        if (name, text, thr) not in pending:  # a prefix the lane fell back to
            oracle_start(name, text, thr)
        contexts, starts = contexts_of[text]
        return (context_oracle_set(pending.pop((name, text, thr)), workers, starts),
                len(contexts))

    oracle_jobs = (("many1k", many_text, MANY_THRESHOLD), ("forbid", corpus, 0.62),
                   ("fuzzy1", corpus, 0.8), ("typed", corpus, 0.8), ("mapped", mapped_corpus, 0.8),
                   ("fuzzy2", corpus, 0.62), ("typed14", corpus, 0.62))
    for job in oracle_jobs:
        if job[1] is mapped_corpus:
            contexts_of[mapped_corpus] = mapped_contexts.get()
        if job[1] is many_text:
            contexts_of[many_text] = many_contexts.get()
        oracle_start(*job)
    beam_jobs = tuple((name, text, BEAM_THRESHOLD[name]) for name, text in beam_texts.items())
    for name, text, thr in beam_jobs:
        if name in beam_contexts:
            contexts_of[text] = beam_contexts[name].get()
        oracle_start(name, text, thr)
    log(f"  word contexts (tail {CONTEXT_TAIL}): {len(contexts_of[corpus][0])} distinct in the "
        f"{len(corpus)}-byte corpus, {len(contexts_of[mapped_corpus][0])} in the "
        f"{len(mapped_corpus)}-byte one, {len(contexts_of[many_text][0])} in the "
        f"{len(many_text)}-byte many1k one, {time.perf_counter() - t0:.1f} s; the oracle's "
        f"{workers} workers have the six engines' searches")
    m4 = mapped4_start(ctx, corpus, pool, workers)
    engine = (FuzzyAhoCorasickBuilder.new().case_insensitive(True).device(dev)
              .build(HEADLINE))
    engine.backend = "device"
    pk = tpb.packed_exact_of(engine)
    require((pk.W, pk.A, pk.m_max) == (3, 21, 12), f"headline tables W/A/m_max {pk.W}/{pk.A}/{pk.m_max}")
    T, cols, shs = tpb._exact_consts(engine, pk, dev)
    exact_ids = lambda text: torch.from_numpy(
        pk.transcode(text, view_of(text, True), engine.dense)).to(dev)
    errs_scan = [0, 0, 0]  # scan_bits, block_offsets, hit_words

    def scan_case(ids, tables, halo, what, want_hits=True, chunk=None):
        count, errs = compare_scan(tpb, torch, ids, tables, halo, what, want_hits, chunk)
        for i, e in enumerate(errs):
            errs_scan[i] = max(errs_scan[i], e)
        return count

    slice4 = corpus[: 4 << 20]
    ids4 = exact_ids(slice4)
    scan_case(ids4, T, pk.m_max, "exact k=0 W=3 A=21, 4 MiB")
    edited = plant(slice4, SEED + 1, 4000)
    for k, dam in ((1, True), (2, False), (3, True)):
        TF, lut, halo = fuzzy_tables(tpb, HEADLINE, k, dam, dev)
        fids = torch.from_numpy(lut[np.frombuffer(edited.encode(), np.uint8)]).to(dev)
        scan_case(fids, TF, halo,
                  f"k={k} {'Damerau' if dam else 'plain'} W={TF.W}, 4 MiB planted edits")
        if k == 1:
            for shift in (1, 5):
                scan_case(fids[shift:], TF, halo, f"k=1 Damerau, view unaligned by {shift}")
    # No hit anywhere; a hit at every position; streams shorter than a word.
    n_zero = scan_case(exact_ids("lorem ipsum dolor sit amet " * 40000), T, pk.m_max,
                       "exact, filler only", want_hits=False)
    require(n_zero == 0, "filler text has hits")
    TA, lut_a, halo_a = fuzzy_tables(tpb, ["a", "aa"], 1, False, dev)
    n_all = 3 * tpb.SCAN_BLOCK_SYMS + 77
    require(scan_case(torch.from_numpy(lut_a[np.full(n_all, ord("a"), np.uint8)]).to(dev),
                      TA, halo_a, "k=1 'a'/'aa' over a run of a: every position hits") == n_all,
            "not every position hit")
    for n_short in (1, 15, 16, 17, 33):
        scan_case(exact_ids("phaetra tincidunt phaetra sagittis ")[:n_short], T, pk.m_max,
                  f"exact, stream of {n_short}", want_hits=False)
    # Words ending on, before and after the edges of the scan's blocks and
    # of a thread's chunks, at every chunk length the kernel takes.
    filler = ("lorem ipsum dolor sit amet " * 4000).encode()[: 2 * tpb.SCAN_BLOCK_SYMS + 500]
    for chunk in tpb.SCAN_CHUNKS:
        for d in (-1, 0, 1):
            edges = [e + d for e in (chunk, 2 * chunk, tpb.SCAN_BLOCK_SYMS, 2 * tpb.SCAN_BLOCK_SYMS)]
            buf = bytearray(filler)
            for end in edges:  # the word's last symbol at position end - 1
                buf[end - 7: end] = b"phaetra"
            ids_e = exact_ids(buf.decode())
            scan_case(ids_e, T, pk.m_max, f"exact, chunk {chunk}, words ending {d:+d} around "
                      "block and chunk edges", chunk=chunk)
            _c, pos_e, _w = tpb.packed_hits(ids_e, T, pk.m_max)
            require(pos_e.tolist() == [e - 1 for e in edges],
                    "the hits at block and chunk edges are not the planted ones, in order")
    for chunk in tpb.SCAN_CHUNKS:
        scan_case(fids, TF, halo, f"k=3 Damerau, chunk {chunk}", chunk=chunk)
    errs_scan[1] = max(errs_scan[1], offsets_edge_checks(tpb, torch, np, dev))

    fuzzy = recipe_engine(ctx, "fuzzy1")
    uni = make_engine(ctx, UNICODE_WORDS, FuzzyLimits.new().edits(1))
    require(uni.dense.has_multibyte_edges, "the Unicode dictionary has multi-byte edges")
    fuzzy2 = make_engine(ctx, HEADLINE, FuzzyLimits.new().edits(2))
    uni_text = unicode_corpus(40000, SEED + 3)
    err_dp_all = 0.0
    for eng, text, thr, what, wide in (
        (fuzzy, edited, 0.8, "DP headline edits(1), 4 MiB planted edits", False),
        (fuzzy, edited, 0.8, "DP headline edits(1), int32 ids", True),
        (fuzzy2, edited, 0.8, "DP headline edits(2), 4 MiB planted edits", False),
        (uni, uni_text, 0.6, "DP multi-byte edges (dead-end), Unicode", False),
        (uni, uni_text, 0.6, "DP multi-byte edges (dead-end), int32 ids", True),
    ):
        err_dp_all = max(err_dp_all, compare_dp(vdp, torch, eng, text, thr, what, wide))
    keyf = match_key
    # A threshold that a match's similarity ties exactly.
    tie_text = plant(corpus[: 256 << 10], SEED + 5, 600)
    tie = max(np.float32(m.similarity) for m in fuzzy.search_raw(tie_text, 0.8)
              if m.similarity < 1.0)
    tie_dev = sorted(map(keyf, fuzzy.search_raw(tie_text, float(tie))))
    fuzzy.backend = "oracle"
    tie_ora = sorted(map(keyf, fuzzy.search_raw(tie_text, float(tie))))
    fuzzy.backend = "device"
    n_tied = sum(1 for t in tie_dev if t[3] == tie.view(np.uint32).item())
    log(f"  threshold {float(tie)!r} tied by {n_tied} matches: device {len(tie_dev)} vs oracle "
        f"{len(tie_ora)} matches, equal {tie_dev == tie_ora}")
    require(tie_dev == tie_ora and n_tied > 0, "device disagrees with the oracle at a tied threshold")
    # The step's errors by kind (dp_pipeline, list_step and its kernels).
    step_errs = {"dp_pipeline": 0.0}
    _err, err_offs = compare_pipeline(
        tpb, vdp, torch, np, uni, uni_text, 0.6,
        "pipeline multi-byte edges (dead-end), Unicode, int32 ids", wide=True, errs=step_errs)
    errs_scan[1] = max(errs_scan[1], err_offs)
    uni2 = make_engine(ctx, UNICODE_WORDS, FuzzyLimits.new().edits(2))
    for eng, text, thr, what, shift, want_rows in (
        (fuzzy, edited, 0.8, "pipeline headline edits(1), 4 MiB planted edits", 0, True),
        (fuzzy, edited, 0.8, "pipeline headline edits(1), views unaligned by 3", 3, True),
        (fuzzy2, edited, 0.8, "pipeline headline edits(2) (k=2 scan), 4 MiB planted edits", 0, True),
        (fuzzy2, edited, 0.8, "pipeline headline edits(2), views unaligned by 3", 3, True),
        (uni, uni_text, 0.6, "pipeline multi-byte edges (dead-end), Unicode", 0, True),
        (uni2, uni_text, 0.6, "pipeline multi-byte edges (dead-end) edits(2), Unicode", 0, True),
        (fuzzy, tie_text, float(tie), "pipeline at the tied threshold", 0, True),
        (fuzzy, "lorem ipsum dolor sit amet " * 20000, 0.8, "pipeline, filler only", 0, False),
        (fuzzy2, "lorem ipsum dolor sit amet " * 20000, 0.9, "pipeline edits(2), filler only", 0,
         False),
        (fuzzy, "tincidunt " * 30000, 0.8, "pipeline, a hit run at every word", 0, True),
    ):
        _err, err_offs = compare_pipeline(tpb, vdp, torch, np, eng, text, thr, what, shift,
                                          want_rows, errs=step_errs)
        errs_scan[1] = max(errs_scan[1], err_offs)
    err_pipe_all = step_errs["dp_pipeline"]

    lanes = tuple(recipe_engine(ctx, name) for name in LANES)
    lane_errs = lane_kernel_checks(ctx, edited, keyf, lanes)
    rows_errs, rows_regs = rows_kernel_checks(ctx, edited, uni_text[: 16 << 10])
    for key, err in rows_errs.items():
        lane_errs[key] = max(lane_errs[key], err)
    typed_rows_errs, typed_rows_regs = typed_rows_checks(ctx, edited, corpus)
    for key, err in typed_rows_errs.items():
        lane_errs[key] = max(lane_errs[key], err)
    lane_errs["typed_expand"] = max(lane_errs["typed_expand"], expand_kernel_checks(ctx))
    deep_errs = deep_kernel_checks(ctx)
    anchors_deep_check(ctx, plant(corpus[: 256 << 10], SEED + 26, 300, (1, 3)))
    for key, err in step_errs.items():
        lane_errs[key] = max(lane_errs.get(key, 0), err)
    err_dp_all = max(err_dp_all, lane_errs["banded_dp"])
    err_pipe_all = max(err_pipe_all, lane_errs["dp_pipeline"])
    errs_scan[1] = max(errs_scan[1], lane_errs["block_offsets"])
    many_errs = many_kernel_checks(ctx, many_text)
    errs_scan[1] = max(errs_scan[1], many_errs["block_offsets"])

    plain_names = [(tpb, n) for n in ("scan_flags_torch", "replay_words_torch", "scan_bits_torch",
                                      "block_offsets_torch", "hit_words_torch")]
    plain_names += [(vdp, n) for n in ("expand_candidates", "banded_dp_torch", "emit_rows",
                                       "dp_pipeline_torch", "banded_dp_typed_torch",
                                       "emit_rows_typed")]
    plain_names += [(many, n) for n in ("expand_candidates_sparse", "dp_list_torch",
                                        "many_step_torch", "many_pipeline_torch",
                                        "_packed_hits_torch")]
    plain_names.append((exact, "goto_walk_torch"))
    plain_names += [(tfz, n) for n in ("_pool_chunk", "_beam_chunk", "order_emissions_torch")]
    scan_keys = ("scan_bits", "block_offsets", "hit_words")

    # 5. parity, ahead of phase 4: the oracle's workers are busy meanwhile.
    forbid_e, typed_e, mapped_e = lanes
    phase("phase 5 parity:")
    key = lambda m: (m.pattern_index, m.start, m.end,
                     np.float32(m.similarity).view(np.uint32).item(), m.edits)
    prefix = corpus[: 64 << 10]
    for what, text in (("64 KiB prefix", prefix),
                       ("64 KiB prefix + 400 planted words", plant(prefix, SEED + 2, 400, (0, 0)))):
        dev_r = sorted(map(key, engine.search_raw(text, 0.5)))
        engine.backend = "oracle"
        ora_r = sorted(map(key, engine.search_raw(text, 0.5)))
        engine.backend = "device"
        log(f"  {what}, device vs oracle: {len(dev_r)} vs {len(ora_r)} matches, "
            f"equal {dev_r == ora_r}")
        require(dev_r == ora_r and len(dev_r) > 0, "device disagrees with the oracle")
    part = corpus[: 8 << 20]
    resident_r = sorted(map(key, engine.search_raw(part, 0.5)))
    saved = tpb.RESIDENT_MAX, tpb.STREAM_CHUNK
    tpb.RESIDENT_MAX, tpb.STREAM_CHUNK = 1 << 22, 1 << 21
    stream_r = sorted(map(key, engine.search_raw(part, 0.5)))
    tpb.RESIDENT_MAX, tpb.STREAM_CHUNK = saved
    log(f"  8 MiB streaming (2 MiB slices) vs resident: {len(stream_r)} vs "
        f"{len(resident_r)} matches, equal {stream_r == resident_r}")
    require(stream_r == resident_r and len(stream_r) > 0, "streaming disagrees with resident")
    text = plant(corpus[: 32 << 10], SEED + 4, 300)
    dev_r = sorted(map(keyf, fuzzy.search_raw(text, 0.8)))
    require(fuzzy.last_stats["backend"] == "device-fuzzy-dp", "fuzzy parity backend")
    fuzzy.backend = "oracle"
    ora_r = sorted(map(keyf, fuzzy.search_raw(text, 0.8)))
    fuzzy.backend = "device"
    log(f"  fuzzy 32 KiB prefix + 300 planted 1-2 edit words, device vs oracle: "
        f"{len(dev_r)} vs {len(ora_r)} matches, equal {dev_r == ora_r}")
    require(dev_r == ora_r and len(dev_r) > 100, "fuzzy device disagrees with the oracle")
    whole_r = sorted(map(keyf, fuzzy.search_raw(part, 0.8)))
    require(fuzzy.last_stats["slices"] == 1, "8 MiB runs as one slice")
    saved = vdp.SLICE_SYMS
    vdp.SLICE_SYMS = 1 << 20
    try:
        sliced_r = sorted(map(keyf, fuzzy.search_raw(part, 0.8)))
        n_slices = fuzzy.last_stats["slices"]
    finally:
        vdp.SLICE_SYMS = saved
    log(f"  fuzzy 8 MiB in {n_slices} slices of 1 MiB vs unsliced: {len(sliced_r)} vs "
        f"{len(whole_r)} matches, equal {sliced_r == whole_r}")
    require(n_slices == 8 and sliced_r == whole_r and len(whole_r) > 0,
            "sliced fuzzy search disagrees with unsliced")

    typed14 = recipe_engine(ctx, "typed14")
    for eng, thr, backend, what in ((forbid_e, 0.62, "device-fuzzy-dp-forbid", "forbid"),
                                    (typed_e, 0.8, "device-fuzzy-dp-typed", "typed"),
                                    (typed14, 0.62, "device-fuzzy-dp-typed",
                                     "typed edits(2).substitutions(1)"),
                                    (mapped_e, 0.8, "device-fuzzy-dp-mapped", "mapped")):
        lane_text = sparse_modem(plant_words(text, SEED + 9, 60, ["modem", "moderm", "modern"]))
        dev_r = sorted(map(keyf, eng.search_raw(lane_text, thr)))
        require(eng.last_stats["backend"] == backend, f"{what} parity backend")
        eng.backend = "oracle"
        ora_r = sorted(map(keyf, eng.search_raw(lane_text, thr)))
        eng.backend = "device"
        log(f"  {what} lane, 32 KiB prefix + planted words, device vs oracle: {len(dev_r)} vs "
            f"{len(ora_r)} matches, equal {dev_r == ora_r}")
        require(dev_r == ora_r and len(dev_r) > 100, f"{what} lane disagrees with the oracle")
    whole_r = sorted(map(keyf, forbid_e.search_raw(part, 0.62)))
    require(forbid_e.last_stats["slices"] == 1, "8 MiB runs as one slice")
    saved = vdp.SLICE_SYMS
    vdp.SLICE_SYMS = 1 << 20
    try:
        sliced_r = sorted(map(keyf, forbid_e.search_raw(part, 0.62)))
        n_slices = forbid_e.last_stats["slices"]
    finally:
        vdp.SLICE_SYMS = saved
    log(f"  forbid lane, 8 MiB in {n_slices} slices of 1 MiB vs unsliced: {len(sliced_r)} vs "
        f"{len(whole_r)} matches, equal {sliced_r == whole_r}")
    require(n_slices == 8 and sliced_r == whole_r and len(whole_r) > 0,
            "sliced forbid search disagrees with unsliced")

    # 4. main path, full size. The host's clock times the searches from here
    # on: the oracle's workers have to be idle.
    t0 = time.perf_counter()
    for job in oracle_jobs + beam_jobs:
        pending[job].wait()
    t1 = time.perf_counter()
    m4.pending.wait()
    m4.prefix.wait()
    log(f"  waited {time.perf_counter() - t0:.1f} s more for the context oracle's workers "
        f"({time.perf_counter() - t1:.1f} s of it for mapped4's windows and prefix)")
    phase("phase 4 main path:")
    for key in tpb.LAUNCHES:
        tpb.LAUNCHES[key] = 0
    with plain_locked(*plain_names):
        t0 = time.perf_counter()
        got = engine.search_raw(corpus, 0.5)
        first_s = time.perf_counter() - t0
        engine.search_raw(corpus, 0.5)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = engine.search_raw(corpus, 0.5)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = dict(tpb.LAUNCHES)
    best = min(times)
    log(f"  {len(corpus)} bytes, first search {first_s:.3f} s (transcode + upload), "
        f"best of 3 {best * 1e3:.3f} ms (all {', '.join(f'{t * 1e3:.3f}' for t in times)}) = "
        f"{len(corpus) / best / 1e9:.3f} GB/s, {len(got)} matches, launches {launches}")
    require(all(launches[k] > 0 for k in scan_keys), "main path did not launch the scan's kernels")
    require(launches["dp"] == 0 and launches["dp_pipeline"] == 0, "exact path launched a DP kernel")
    require(engine.last_stats["backend"] == "device-exact-packed", "main path backend")
    dev_set = {(m.pattern_index, m.start, m.end) for m in got}
    require(all(m.similarity == 1.0 and m.edits == 0 for m in got), "exact matches carry weight 1.0")
    low = corpus.lower()
    want = set()
    for pi, w in enumerate(HEADLINE):
        at = low.find(w)
        while at >= 0:
            want.add((pi, at, at + len(w)))
            at = low.find(w, at + 1)
    log(f"  independent str.find count {len(want)}; equal: {dev_set == want}")
    require(len(got) == len(dev_set) and dev_set == want, "main path disagrees with str.find")
    require(len(want) > 1000, "too few matches to be a real check")

    # Where the time goes.
    ids_dev, _n = device_corpus.resident(
        corpus, ("pk-exact", tpb._space_token(engine)),
        lambda h: pk.transcode(h, view_of(h, True), engine.dense), dev)
    dev_s = event_ms(torch, lambda: tpb._run_exact_kernel(ids_dev, T, pk.m_max, cols, shs), 5)
    prof_x = profile_search(torch, lambda: engine.search_raw(corpus, 0.5), 5, tpb.LAUNCHES)
    log(f"  breakdown: search_raw {best * 1e3:.3f} ms; device pass + readback {dev_s:.3f} ms; "
        f"host rest {best * 1e3 - dev_s:.3f} ms")
    log(f"  torch.profiler over 5 searches: wall {prof_x['wall']:.3f} ms per search, device busy "
        f"{prof_x['busy']:.3f} ms ({prof_x['busy'] / prof_x['wall']:.3f} of wall); per search "
        f"{prof_x['kernels']:.1f} kernel launches, {prof_x['copies']:.1f} copies, "
        f"{prof_x['waits']:.1f} host waits")
    for line in prof_x["lines"][:8]:
        log(f"    {line}")

    # 4b. fuzzy main path, full size
    phase("phase 4b fuzzy main path:")
    t_phase = time.perf_counter()
    for k in tpb.LAUNCHES:
        tpb.LAUNCHES[k] = 0
    with plain_locked(*plain_names):
        t0 = time.perf_counter()
        got_f = fuzzy.search_raw(corpus, 0.8)
        first_f = time.perf_counter() - t0
        fuzzy.search_raw(corpus, 0.8)
        times_f = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got_f = fuzzy.search_raw(corpus, 0.8)
            torch.cuda.synchronize()
            times_f.append(time.perf_counter() - t0)
    launches_f = dict(tpb.LAUNCHES)
    best_f = min(times_f)
    stats = dict(fuzzy.last_stats)
    log(f"  {len(corpus)} bytes, first search {first_f:.3f} s (transcode + upload), "
        f"best of 3 {best_f * 1e3:.3f} ms (all {', '.join(f'{t * 1e3:.3f}' for t in times_f)}) = "
        f"{len(corpus) / best_f / 1e9:.3f} GB/s, {len(got_f)} matches, launches {launches_f}")
    log(f"  last_stats {stats}")
    require(stats["backend"] == "device-fuzzy-dp", "fuzzy main path backend")
    require(all(launches_f[k] > 0 for k in scan_keys + ("dp_pipeline",)),
            "fuzzy main path did not launch the scan's kernels and the pipeline kernel")
    require(launches_f["dp"] == launches_f["dp_typed"] == 0
            and all(launches_f[k] == 0 for k in TYPED_KEYS + LIST_KEYS),
            "fuzzy main path went through a kernel of another lane")
    dev_f = {keyf(m) for m in got_f}
    require(len(dev_f) == len(got_f), "fuzzy main path repeats a match")
    t0 = time.perf_counter()
    want_f, n_ctx = oracle_set("fuzzy1", corpus, 0.8)
    log(f"  independent context oracle (tail {CONTEXT_TAIL}): {n_ctx} contexts, {len(want_f)} matches, "
        f"{time.perf_counter() - t0:.1f} s; equal: {dev_f == want_f}")
    require(dev_f == want_f, "fuzzy main path disagrees with the context oracle")
    require(len(want_f) > 1000, "too few fuzzy matches to be a real check")
    log(f"  fuzzy matches {len(got_f)} = 3 x exact matches ({len(got)}): "
        f"{len(got_f) == 3 * len(got)}")
    prof_f = profile_search(torch, lambda: fuzzy.search_raw(corpus, 0.8), 3, tpb.LAUNCHES)
    log(f"  torch.profiler over 3 searches: wall {prof_f['wall']:.3f} ms per search, device busy "
        f"{prof_f['busy']:.3f} ms ({prof_f['busy'] / prof_f['wall']:.3f} of wall); per search "
        f"{prof_f['kernels']:.1f} kernel launches, {prof_f['copies']:.1f} copies, "
        f"{prof_f['waits']:.1f} host waits, over {stats['slices']} slices; dp_pipeline: the "
        f"wrapper counted {prof_f['counted']['dp_pipeline']} launches, the profiler shows "
        f"{event_count(prof_f, 'dp_pipeline_kernel')} events")
    for line in prof_f["lines"]:
        log(f"    {line}")
    kernel_names = ("scan_bits_kernel", "block_offsets_kernel", "hit_words_kernel",
                    "dp_pipeline_kernel")
    for name in kernel_names:
        log(f"    {name}: {device_ms(prof_f, name):.4f} ms device time per fuzzy search, "
            f"{device_ms(prof_x, name):.4f} ms per exact search")
    stages, n_stage = stage_breakdown(torch, tpb, vdp, fuzzy, corpus, 0.8)
    require(n_stage == len(got_f), "stage breakdown found other matches")
    log(f"  stages (host clock, synchronised, ms per search): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")
    log(f"  phase 4b {time.perf_counter() - t_phase:.1f} s")

    # 4c, 4c', 4d, 4e. the forbid lane, the default edits(2), the typed and
    # the mapped lanes, full size. The oracle is locked out beside the plain
    # versions: a lane that declined would run for hours on it. The forbid,
    # edits(2) and mapped searches run the count-channel list step, none of
    # them dp_pipeline_kernel (lane_main_path holds every other counter at 0).
    locked = plain_names + [(oracle, "search_raw")]
    lane_runs = {}
    fuzzy2_e = recipe_engine(ctx, "fuzzy2")
    for tag, name, title, eng, text, thr, backend, pipe_keys, floor in (
        ("4c", "forbid", "forbid lane, edits(2).swaps(0), threshold 0.62", forbid_e, corpus, 0.62,
         "device-fuzzy-dp-forbid", LIST_KEYS, 1000),
        ("4c'", "fuzzy2", "fuzzy2_default, edits(2) with swaps, threshold 0.62 (bench.py:347-384)",
         fuzzy2_e, corpus, 0.62, "device-fuzzy-dp", LIST_KEYS, 1000),
        ("4d", "typed", "typed lane, edits(1) with an exact-only and a substitutions(1) pattern, "
         "threshold 0.8", typed_e, corpus, 0.8, "device-fuzzy-dp-typed", TYPED_KEYS, 1000),
        ("4d'", "typed14", "typed14, edits(2).substitutions(1): 5 bands x 14 type vectors, the "
         "typed DP past 32 cells, threshold 0.62", typed14, corpus, 0.62,
         "device-fuzzy-dp-typed", TYPED_KEYS, 1000),
        ("4e", "mapped", "mapped lane, headline + modern, rn <-> m, edits(1), threshold 0.8, every 50th "
         "commodo a modem", mapped_e, mapped_corpus, 0.8, "device-fuzzy-dp-mapped",
         LIST_KEYS, 1000),
    ):
        phase(f"phase {tag} {title}:")
        lane_runs[tag] = lane_main_path(ctx, tag, name, eng, text, thr, backend, locked,
                                        scan_keys, pipe_keys, oracle_set, floor)
    n_modem = sum(1 for m in mapped_e.search_raw(lane_runs["4e"].text[: 4 << 20], 0.8)
                  if m.pattern_index == len(HEADLINE) and m.similarity == 1.0
                  and m.substitutions == 1)
    log(f"  4e: {n_modem} modem -> modern matches at similarity 1.0 in the first 4 MiB")
    require(n_modem > 0, "the mapped lane found no modem through the mapping")

    # 4e''. mapped4: the mapped lane past six scan rows (edits(4), rn <-> m,
    # a scan budget of 8 rows) at full size, held against the oracle over
    # every window around a planted copy or a hit of the plain scan, and
    # over a prefix in whole.
    phase(f"phase 4e'' mapped4: {len(MAPPED4_WORDS)} two-word names, rn <-> m, edits(4), "
          f"threshold {MAPPED4_THRESHOLD}, {MAPPED4_COPIES} copies with 1-4 edits planted:")
    lane_runs["4e''"] = lane_main_path(
        ctx, "4e''", "mapped4", m4.engine, m4.text, MAPPED4_THRESHOLD, "device-fuzzy-dp-mapped",
        locked, DEEP_SCAN_KEYS, LIST_KEYS, lambda _n, _t, _thr: mapped4_bar(m4), MAPPED4_COPIES,
        ties=True)
    require(lane_runs["4e''"].text is m4.text, "4e'': the lane declined at full size")
    with plain_locked(*locked):
        head = sorted(map(match_key, m4.engine.search_raw(m4.text[:MAPPED4_PREFIX],
                                                           MAPPED4_THRESHOLD)))
    whole = sorted(m4.prefix.get()[0])
    log(f"  4e'': the first {MAPPED4_PREFIX} characters in whole: {len(head)} matches on the card, "
        f"{len(whole)} by the oracle, equal as (pattern, start, end, similarity) "
        f"{spans_of(head) == spans_of(whole)}, with the edit counts {head == whole}")
    require(spans_of(head) == spans_of(whole) and len(head) > 0,
            "4e'': the prefix differs from the oracle's")

    # 4f. the large-dictionary lane, many1k, folded then plain.
    many_e = recipe_engine(ctx, "many1k")
    t0 = time.perf_counter()
    want_many, n_ctx = oracle_set("many1k", many_text, MANY_THRESHOLD)
    log(f"  many1k context oracle (tail {CONTEXT_TAIL}): {n_ctx} contexts, {len(want_many)} "
        f"matches, {time.perf_counter() - t0:.1f} s")
    require(len(want_many) > MANY_TYPOS // 2, "many1k: too few matches to be a real check")
    many_runs = {}
    for tag, fold in (("4f folded", True), ("4f plain", False)):
        phase(f"phase {tag}: many1k, 1,000 words, edits(1), threshold {MANY_THRESHOLD}, "
              f"{'the folded layout' if fold else 'the plain chunking (fold switch off)'}:")
        many_runs[tag] = many_main_path(ctx, tag, many_e, many_text, MANY_THRESHOLD, fold, locked,
                                        want_many)

    # 4g, 4h. Exact dictionaries past the narrow packed lane, over the 24 MiB
    # many1k corpus with 4,000 exact copies of the first 300 words planted:
    # exact-wide (those 300 words, the wide packed scan at k = 0) and exact1k
    # (all 1,000 words, past 64 limbs: the goto walk's kernels).
    words1k = many_words(1000, 7)
    exact_text = plant_words(many_text, SEED + 11, MANY_TYPOS, words1k[:300])
    wide_e, k1_e = make_exact(ctx, words1k[:300]), make_exact(ctx, words1k)
    W_wide = tpb.packed_exact_of(wide_e).W
    exact_runs = {}
    phase(f"phase 4g exact-wide: the first 300 many1k words, exact, threshold 0.5, W = {W_wide} "
          f"limbs:")
    require(tpb.MAX_LIMBS < W_wide <= tpb.MAX_SCAN_LIMBS, "exact-wide: not the wide packed form")
    exact_runs["exact-wide"] = exact_main_path(
        ctx, "exact-wide", wide_e, words1k[:300], exact_text, "device-exact-packed", locked,
        ("scan_bits_wide", "block_offsets", "hit_words_wide"))
    require(exact_runs["exact-wide"].stats["limbs"] == W_wide, "exact-wide: limbs in last_stats")
    phase(f"phase 4h exact1k: the {len(words1k)} many1k words, exact, threshold 0.5, past "
          f"{tpb.MAX_SCAN_LIMBS} limbs (the goto walk):")
    require(tpb.packed_exact_of(k1_e) is None, "exact1k: the dictionary packs")
    walk_keys = ("goto_walk", "block_offsets")
    exact_runs["exact1k"] = exact_main_path(ctx, "exact1k", k1_e, words1k, exact_text,
                                            "device-exact", locked, walk_keys)
    walk_err = walk_kernel_checks(ctx, k1_e, exact_text, beam_texts["cjk1"])
    # A 70-character pattern (past the packed lane's 64) over 1 MiB with 64
    # runs of 70-80 a's: overlapping matches.
    long_e = make_exact(ctx, ["a" * 70])
    rng = np.random.default_rng(SEED + 13)
    buf = bytearray(many_text[: 1 << 20].encode())
    for at in rng.integers(0, len(buf) - 100, size=64).tolist():
        r = int(rng.integers(70, 81))
        buf[at:at + r + 2] = (" " + "a" * r + " ").encode()
    long_text = buf.decode()
    with plain_locked(*locked):
        got_long = long_e.search_raw(long_text, 0.5)
    want_long = find_set(long_text, ["a" * 70])
    got_long_set = {(m.pattern_index, m.start, m.end) for m in got_long}
    log(f"  70-character pattern over {len(long_text)} bytes: backend "
        f"{long_e.last_stats['backend']}, {len(got_long)} matches, str.find {len(want_long)}, "
        f"equal {got_long_set == want_long}")
    require(long_e.last_stats["backend"] == "device-exact" and got_long_set == want_long
            and len(got_long) == len(want_long) > 64, "70-character pattern disagrees")

    # 4i. The entry points above search_raw, through what a user calls:
    # streaming replace (fuzzy1, then exact), a stream past RESIDENT_MAX, the
    # prefilter, save / load and search_basic; plain versions and oracle
    # locked out, the counters set to 0 before each and read after.
    entry = {}
    for tag, eng, thr, keys in (("4i (a) fuzzy1", fuzzy, 0.8, scan_keys + ("dp_pipeline",)),
                                ("4i (b) exact", engine, 0.5, scan_keys)):
        phase(f"phase {tag}: replace_stream_parallel over the {len(corpus)}-byte corpus, "
              f"threshold {thr}:")
        entry[tag] = stream_replace_cell(ctx, tag, eng, corpus, thr, locked, keys)
    phase(f"phase 4i (c): search_stream_parallel, fuzzy1, over the corpus, a space and the "
          f"corpus ({len(joined)} bytes):")
    t0 = time.perf_counter()
    contexts_j, starts_j = joined_contexts.get()
    raw_j, n_new = reused_oracle_set("fuzzy1", 0.8, contexts_of[corpus][0],
                                     results_of["fuzzy1", corpus, 0.8].get(), workers,
                                     contexts_j, starts_j)
    log(f"  context oracle (tail {CONTEXT_TAIL}) over the joined text: {len(contexts_j)} "
        f"contexts, {n_new} not in the corpus's (searched here), {len(raw_j)} matches, "
        f"{time.perf_counter() - t0:.1f} s")
    entry["4i (c) joined"] = joined_stream_cell(ctx, fuzzy, joined, raw_j, locked,
                                                scan_keys + ("dp_pipeline",))
    phase("phase 4i (d): prefilter, save / load, search_basic:")
    entry["4i (d)"] = small_entry_points(ctx, fuzzy, many_e, corpus, many_text, locked, keyf)
    phase("phase 4i (e): the kernels of 4i's paths against their plain versions on the inputs "
          "those paths hand them:")
    errs_4i, err_pipe_4i = stream_kernel_checks(ctx, fuzzy, engine, corpus, joined)
    for i, e in enumerate(errs_4i):
        errs_scan[i] = max(errs_scan[i], e)
    err_pipe_all = max(err_pipe_all, err_pipe_4i)

    # 4j. The beam-frontier lanes, through search_raw: one search past
    # RESIDENT_MAX (packed anchors in segments, the E = 1 pool), a CJK
    # dictionary at E = 1 and at E = 2 (the seed filter, the pool and the
    # sorted beam) and a pattern past 63 graphemes; the plain versions
    # locked out, and the oracle where no start can overflow.
    beam, beam_engines = {}, {}
    t_4j = time.perf_counter()
    phase(f"phase 4j (a): one search_raw of fuzzy1 over the joined text ({len(joined)} bytes, "
          f"past RESIDENT_MAX), threshold 0.8:")
    require(len(joined) > tpb.RESIDENT_MAX, "the joined text is under RESIDENT_MAX")
    beam["4j (a)"] = beam_cell(ctx, "4j (a)", fuzzy, joined, 0.8, locked, raw_j)
    require(beam["4j (a)"].matches == len(raw_j), "4j (a): not the context oracle's count")
    beam_engines["4j (a)"] = (fuzzy, joined, 0.8)
    for tag, name, title, oracle_locked in (
        ("4j (b)", "cjk1", "CJK, 60 words of 4 characters, edits(1)", True),
        ("4j (c)", "cjk2", "CJK, 40 words of 5-8 characters, edits(2)", False),
        ("4j (d)", "long", "a 70-character pattern and hello, edits(1), over the many1k corpus "
                           "with 64 runs of 69-72 a's", True),
    ):
        text, thr = beam_texts[name], BEAM_THRESHOLD[name]
        phase(f"phase {tag}: {title}, threshold {thr}, {len(text.encode())} bytes:")
        eng = recipe_engine(ctx, name)
        t0 = time.perf_counter()
        want_b, n_ctx = oracle_set(name, text, thr)
        if name == "long":
            # The word contexts hold hello's matches; the a-runs' windows
            # the 70-character pattern's.
            want_b = {k for k in want_b if k[0] == 1} | arun_oracle_set(ctx, text, thr)
        log(f"  context oracle: {n_ctx} contexts, {len(want_b)} matches, "
            f"{time.perf_counter() - t0:.1f} s")
        require(len(want_b) > 60, f"{tag}: too few matches to be a real check")
        beam[tag] = beam_cell(ctx, tag, eng, text, thr, locked, want_b, oracle_locked)
        beam_engines[tag] = (eng, text, thr)
    for tag, keys in (("4j (a)", ("scan_bits",)), ("4j (d)", scan_keys)):
        require(all(beam[tag].launches[k] > 0 for k in keys),
                f"{tag}: the search did not launch {', '.join(keys)}")
    phase("phase 4j (e): the kernels of 4j's paths against their plain versions on its inputs "
          "(the frontier kernels on each cell's first run and on twelve small shapes):")
    errs_4j = beam_kernel_checks(ctx, fuzzy, joined, beam_engines["4j (d)"][0],
                                 beam_texts["long"])
    walk_err = max(walk_err, seed_walk_checks(ctx, beam_engines, ("4j (b)", "4j (c)")))
    for i, e in enumerate(errs_4j):
        errs_scan[i] = max(errs_scan[i], e)
    frontier_runs = {}
    for tag in ("4j (a)", "4j (b)", "4j (c)", "4j (d)"):
        eng, text, thr = beam_engines[tag]
        frontier_runs[tag] = frontier_kernel_check(ctx, eng, text, thr, beam[tag].stages, tag)
    frontier_small = frontier_shape_checks(ctx)
    regs_f = frontier_registers(kern.log)
    log(f"  ptxas of the frontier kernels (registers, spill-store bytes): {regs_f}")
    require(all(v is not None for v in regs_f.values()),
            "a frontier kernel instance is missing from ptxas")
    require(not any(v[1] for v in regs_f.values()), "a frontier kernel spills registers")
    log(f"  phase 4j {time.perf_counter() - t_4j:.1f} s")

    # 4k. The sharded lanes and the multi-host entry points (parallel/): the
    # engines of phases 4-4e over their 96 MiB texts on 3 logical shards of
    # the card and on default_mesh() (every card), the dry run,
    # replace_multihost in one process and in two under initialize, and the
    # kernels on the first and the last shard's buffers.
    from fuzzy_aho_corasick_tpu_torch.parallel.dryrun import dryrun_multichip
    from fuzzy_aho_corasick_tpu_torch.parallel.shard_search import default_mesh

    t_4k = time.perf_counter()
    mesh3 = [dev] * 3
    meshes = (("3 logical shards", mesh3), ("default_mesh()", default_mesh()))
    step_keys = scan_keys + ("dp_pipeline",)
    sharded, k4 = {}, {}
    for name, eng, text, thr, keys, want_n in (
        ("exact", engine, corpus, 0.5, walk_keys, len(got)),
        ("fuzzy1", fuzzy, corpus, 0.8, step_keys, len(got_f)),
        ("forbid", forbid_e, lane_runs["4c"].text, 0.62, scan_keys + LIST_KEYS,
         lane_runs["4c"].matches),
        ("typed", typed_e, lane_runs["4d"].text, 0.8, scan_keys + TYPED_KEYS,
         lane_runs["4d"].matches),
        ("mapped", mapped_e, lane_runs["4e"].text, 0.8, scan_keys + LIST_KEYS,
         lane_runs["4e"].matches),
        ("mapped4", m4.engine, m4.text, MAPPED4_THRESHOLD, DEEP_SCAN_KEYS + LIST_KEYS,
         lane_runs["4e''"].matches),
    ):
        phase(f"phase 4k (a) {name}: the sharded lane over {len(text)} bytes, threshold {thr}:")
        with plain_locked(*locked):
            want = sorted(map(match_key, eng.search_raw(text, thr)))
        require(len(want) == want_n, f"4k (a) {name}: search_raw found {len(want)}, its phase "
                f"{want_n}")
        for mesh_name, mesh in meshes:
            cell = sharded_cell(ctx, f"4k (a) {name}, {mesh_name}", eng, text, thr, mesh, locked,
                                want, keys, profile=mesh is mesh3)
            sharded[f"{name}, {mesh_name}"] = cell
            k4.setdefault(name, []).append(cell.launches)
        if name != "exact":
            log(f"  host transcode of the two symbol streams per search: "
                f"{host_transcode_ms(eng, text):.3f} ms")
    phase("phase 4k (b): dryrun_multichip over every card and over 3 logical shards:")
    reset_launches(tpb)
    with plain_locked(*plain_names):
        dry = {"default_mesh": dryrun_multichip(torch.cuda.device_count()),
               "3 logical shards": dryrun_multichip(3, mesh3)}
    k4["dryrun"] = [dict(tpb.LAUNCHES)]
    log(f"  {dry}; launches {k4['dryrun'][0]}")
    phase(f"phase 4k (c), (d): replace_multihost and search_multihost over {MULTIHOST_BYTES} "
          f"bytes, fuzzy1 at 0.8, table {MULTIHOST_TABLE[0]!r}..:")
    multi = multihost_cells(ctx, fuzzy, corpus, locked)
    k4["multihost"] = [multi["c"]["launches"]] + [w["launches"] for w in multi["d"]["workers"]]
    phase("phase 4k (e): the kernels against their plain versions on the first and the last "
          "shard's extended buffers of (a), 3 logical shards:")
    errs_4k = {}
    shard_kernel_checks(ctx, fuzzy, corpus, 0.8, mesh3, "4k (e) fuzzy1", errs_4k)
    shard_kernel_checks(ctx, typed_e, lane_runs["4d"].text, 0.8, mesh3, "4k (e) typed", errs_4k)
    errs_4k["goto_walk"] = shard_walk_checks(ctx, engine, corpus, mesh3)
    walk_err = max(walk_err, errs_4k["goto_walk"])
    for i, key in enumerate(scan_keys):
        errs_scan[i] = max(errs_scan[i], errs_4k[key])
    err_pipe_all = max(err_pipe_all, errs_4k["dp_pipeline"])
    for key in TYPED_KEYS + ("typed_step",):
        lane_errs[key] = max(lane_errs[key], errs_4k.get(key, 0))
    log(f"  max_abs_err {errs_4k}")
    k4_s = time.perf_counter() - t_4k
    log(f"  phase 4k {k4_s:.1f} s")

    def k4_sum(name, groups=None, skip=()):
        return sum(counts[name] for group, sets in k4.items()
                   if (groups is None or group in groups) and group not in skip
                   for counts in sets)

    # 6. times, bounds and agreement at the main paths' shapes
    phase("phase 6 times at main-path shapes (CUDA events; device time is the profiler's above):")
    plan, run = lane_inputs(vdp, fuzzy, corpus, 0.8, "main-path shapes")
    fpart = run.parts[0]
    log(f"  fuzzy slice 1 of {len(run.parts)}: {fpart.local_n} symbols "
        f"({fpart.ids_pf.numel()} padded), k={plan.k} damerau={plan.dam} halo={run.halo}")
    scan_rec = {}
    for tag, ids_s, T_s, halo_s in (("exact", ids_dev, T, pk.m_max),
                                    ("fuzzy", fpart.ids_pf, run.T_scan, run.halo)):
        hits = scan_case(ids_s, T_s, halo_s, f"{tag} main-path shape")
        bits_s, counts_s = tpb.scan_bits(ids_s, T_s, halo_s)
        offs_s = tpb.block_offsets(counts_s)
        n_s, W_s = ids_s.numel(), T_s.W
        instr = scan_instr(W_s, T_s.k, T_s.damerau)
        rec = {
            "scan_bits": (
                event_ms(torch, lambda: tpb.scan_bits(ids_s, T_s, halo_s), 20),
                event_ms(torch, lambda: tpb.scan_bits_torch(ids_s, T_s, halo_s), 3),
                bound_ms(n_s + n_s / 8 + 4 * counts_s.numel(), instr * n_s, INT_RATE), None),
            "block_offsets": (
                event_ms(torch, lambda: tpb.block_offsets(counts_s), 20),
                event_ms(torch, lambda: tpb.block_offsets_torch(counts_s), 20),
                bound_ms(8 * counts_s.numel() + 4, counts_s.numel(), INT_RATE),
                event_ms(torch, lambda: torch.cumsum(counts_s, 0, dtype=torch.int32), 20)),
            "hit_words": (
                event_ms(torch, lambda: tpb.hit_words(ids_s, bits_s, offs_s, hits, T_s, halo_s), 20),
                event_ms(torch, lambda: tpb.hit_words_torch(ids_s, bits_s, offs_s, hits, T_s, halo_s), 5),
                bound_ms(n_s / 8 + 4 * offs_s.numel() + hits * (halo_s + 8 + 16 * W_s),
                         instr * hits * halo_s, INT_RATE), None),
        }
        scan_rec[tag] = rec
        for name, (ms, plain, (b_ms, b_by), lib) in rec.items():
            log(f"  {name} {tag}: {n_s} symbols, {hits} hits, kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {b_ms:.3g} ms by {b_by} ({b_ms / ms:.3g} of the kernel's "
                f"time)" + (f", torch.cumsum {lib:.4f} ms" if lib is not None else ""))
        whole = event_ms(torch, lambda: tpb.packed_hits(ids_s, T_s, halo_s), 20)
        log(f"  packed_hits {tag} (three kernels and the count's readback): {whole:.4f} ms")

    # The scan at every chunk length the kernel takes, on streams on both
    # sides of the lengths where scan_chunk switches, beside its pick.
    fill = torch.cuda.get_device_properties(dev).multi_processor_count * tpb.SCAN_FILL_THREADS
    ids_fz = torch.cat([p.ids_pf[: p.local_n] for p in run.parts])
    sweep = []
    for tag, ids_s, T_s, halo_s, n_main in (
            ("exact k=0", ids_dev, T, pk.m_max, ids_dev.numel()),
            (f"fuzzy k={plan.k} damerau={plan.dam}", ids_fz, run.T_scan, run.halo,
             fpart.ids_pf.numel())):
        sizes = {n_main, *(int(fill * c * f) // 16 * 16 for c in (256, 512) for f in (0.75, 1.25))}
        for n_s in sorted(x for x in sizes if x <= ids_s.numel()):
            head = ids_s[:n_s]
            ms = {c: event_ms(torch, lambda c=c: tpb.scan_bits(head, T_s, halo_s, c), 10)
                  for c in tpb.SCAN_CHUNKS}
            picked = tpb.scan_chunk(n_s, dev)
            log(f"  scan_bits {tag}, {n_s} symbols, by chunk: "
                + ", ".join(f"{c}: {t:.4f} ms" for c, t in ms.items())
                + f"; scan_chunk picks {picked}, {ms[picked] / min(ms.values()):.3f} x the best")
            sweep.append({"tables": tag, "n": n_s, "ms_by_chunk": ms, "picked": picked})
    del ids_fz

    # The DP step on slice 1: the pipeline kernel, and the DP-only kernel on
    # the same candidates.
    hits_f, pos_f, words_f = tpb.packed_hits(fpart.ids_pf, run.T_scan, run.halo)
    p_args = pipeline_args(vdp, np, plan, run, fpart, pos_f, words_f, 0.8)
    rows_k, cand_k = vdp.dp_pipeline(*p_args)
    rows_p, cand_p = vdp.dp_pipeline_torch(*p_args)
    _h, cf, cs = vdp.dp_candidates(run, fpart)
    dp_args = (cf, cs, fpart.ids_de, fpart.local_n, run.T, run.pens, plan.E, run.deadend)
    pen_k, cnt_k = vdp.banded_dp(*dp_args)
    pen_p, cnt_p = vdp.banded_dp_torch(*dp_args)
    torch.cuda.synchronize()
    require(torch.equal(rows_k, rows_p) and cand_k == cand_p == cf.numel(),
            "dp_pipeline disagrees at main-path shapes")
    require(torch.equal(pen_k.view(torch.int32), pen_p.view(torch.int32))
            and torch.equal(cnt_k, cnt_p), "DP kernel disagrees at main-path shapes")
    B, NE = 2 * plan.E + 1, plan.E + 1
    cells = int(run.T.depth[cf.long()].sum()) * B * NE
    tables = sum(t.numel() * t.element_size() for t in (
        run.T.path_cls, run.T.path_node, run.T.depth, run.T.sim, run.T.node_ceil))
    window = cf.numel() * (run.T.Lmax + 2 * plan.E + 2)
    pipe_bound = bound_ms(pos_f.numel() * 8 + words_f.numel() * 8 + tables + window
                          + rows_k.numel() * 4, cells * DP_CELL_INSTR, F32_RATE)
    dp_bound = bound_ms(cf.numel() * 8 + tables + window + pen_k.numel() * 8,
                        cells * DP_CELL_INSTR, F32_RATE)
    # block_offsets as the pipeline calls it: the count pass's counts.
    counts_pipe, = vdp.dp_pipeline_counts(*p_args)
    offs_pipe, offs_pipe_p = tpb.block_offsets(counts_pipe), tpb.block_offsets_torch(counts_pipe)
    err_offs = int((offs_pipe.long() - offs_pipe_p.long()).abs().max())
    errs_scan[1] = max(errs_scan[1], err_offs)
    require(err_offs == 0, "block_offsets disagrees on the pipeline's counts at main-path shapes")
    offs_pipe_rec = (
        event_ms(torch, lambda: tpb.block_offsets(counts_pipe), 20),
        event_ms(torch, lambda: tpb.block_offsets_torch(counts_pipe), 20),
        bound_ms(8 * counts_pipe.numel() + 4, counts_pipe.numel(), INT_RATE),
        event_ms(torch, lambda: torch.cumsum(counts_pipe, 0, dtype=torch.int32), 20))
    log(f"  block_offsets on the pipeline's {counts_pipe.numel()} counts: kernel "
        f"{offs_pipe_rec[0]:.4f} ms, plain {offs_pipe_rec[1]:.4f} ms, bound "
        f"{offs_pipe_rec[2][0]:.5f} ms by {offs_pipe_rec[2][1]}, torch.cumsum "
        f"{offs_pipe_rec[3]:.4f} ms, max_abs_err {err_offs}")
    pipe_ms = event_ms(torch, lambda: vdp.dp_pipeline(*p_args), 20)
    pipe_plain_ms = event_ms(torch, lambda: vdp.dp_pipeline_torch(*p_args), 3)
    dp_ms = event_ms(torch, lambda: vdp.banded_dp(*dp_args), 20)
    dp_plain_ms = event_ms(torch, lambda: vdp.banded_dp_torch(*dp_args), 3)
    prof_p = profile_search(torch, lambda: vdp.dp_pipeline(*p_args), 20, tpb.LAUNCHES)
    log(f"  dp_pipeline E={plan.E}: {hits_f} hits x {plan.n_combo} combos, {cand_k} candidates, "
        f"{rows_k.shape[0]} rows; wrapper (two passes, offsets, totals' readback) {pipe_ms:.4f} ms, "
        f"{pipeline_device_time(prof_p, 'dp_pipeline')}, plain "
        f"{pipe_plain_ms:.4f} ms, bound {pipe_bound[0]:.4f} ms by {pipe_bound[1]}, max_abs_err 0")
    log(f"  banded_dp E={plan.E}: {cf.numel()} candidates, "
        f"{int(torch.isfinite(pen_k).sum())} live channels, kernel {dp_ms:.4f} ms, "
        f"plain {dp_plain_ms:.4f} ms, bound {dp_bound[0]:.4f} ms by {dp_bound[1]}, max_abs_err 0")
    lane_times = {
        tag: lane_kernel_times(ctx, f"{tag} {what}", eng, lane_runs[tag].text, thr)
        for tag, what, eng, thr in (("4c", "forbid", forbid_e, 0.62), ("4d", "typed", typed_e, 0.8),
                                    ("4e", "mapped", mapped_e, 0.8),
                                    ("4e''", "mapped4", m4.engine, MAPPED4_THRESHOLD))}
    # typed14 (4d'): 5 bands x 14 type vectors behind a k = 2 scan, the
    # typed DP past 32 cells, at its full slice.
    lane_times["4d'"] = lane_kernel_times(ctx, "4d' typed14", typed14, lane_runs["4d'"].text,
                                          0.62)
    # The list step's emission at its grid's edges on fuzzy2's slice 1 too
    # (forbid2's, mapped's and mapped4's ran in lane_kernel_times).
    plan2, run2 = lane_inputs(vdp, fuzzy2_e, lane_runs["4c'"].text, 0.62, "4c' fuzzy2")
    _h2, pos2, words2 = tpb.packed_hits(run2.parts[0].ids_pf, run2.T_scan, run2.halo)
    lane_errs["count_emit"] = max(
        [lane_errs["count_emit"], emit_edge_checks(ctx, "4c' fuzzy2", pipeline_args(
            vdp, np, plan2, run2, run2.parts[0], pos2, words2, 0.62))]
        + [lane_t.emit_err for tag, lane_t in lane_times.items() if tag not in ("4d", "4d'")])
    lane_errs["typed_emit"] = max(lane_errs["typed_emit"], lane_times["4d"].emit_err,
                                  lane_times["4d'"].emit_err)
    for tag, lane_t in lane_times.items():
        if tag == "4e''":  # the deep instances
            for key, e in zip(("scan_bits_wide[k=7..24]", "block_offsets",
                               "hit_words_wide[k=7..24]"), lane_t.scan_errs):
                deep_errs[key] = max(deep_errs[key], e)
            continue
        for i, e in enumerate(lane_t.scan_errs):
            errs_scan[i] = max(errs_scan[i], e)
    many_rec, many_main_errs, step_passes, many_detail = many_kernel_times(
        ctx, many_e, many_text, MANY_THRESHOLD)
    for key, err in many_main_errs.items():
        many_errs[key] = max(many_errs[key], err)
    errs_scan[1] = max(errs_scan[1], many_errs["block_offsets"])
    wide_rec, wide_errs, wide_detail = wide_exact_times(ctx, wide_e, exact_text, errs_scan[1])
    errs_scan[1] = wide_errs["block_offsets"]
    deep_rec, deep_main_errs, deep_detail = deep_times(ctx, m4.engine, m4.text, MAPPED4_THRESHOLD)
    for key, err in deep_main_errs.items():
        deep_errs[key] = max(deep_errs[key], err)
    errs_scan[1] = max(errs_scan[1], deep_errs["block_offsets"], wide_errs["block_offsets"])
    walk_t = walk_times(ctx, walk_inputs(ctx, k1_e, exact_text))
    walk_t["exact1k_host_split_ms"] = exact1k_host_split(ctx, k1_e, exact_text)
    # block_offsets at every shape the searches hand it, and two more, beside
    # torch.cumsum.
    offs_shapes = []
    for tag, rec in scan_rec.items():
        ms, plain, bound, lib = rec["block_offsets"]
        offs_shapes.append({"what": f"{tag} scan's counts", "ms": ms, "plain_ms": plain,
                            "bound_ms": bound[0], "library_ms": lib})
    offs_shapes.append({"what": "fuzzy1 count pass", "len": counts_pipe.numel(),
                        "ms": offs_pipe_rec[0], "plain_ms": offs_pipe_rec[1],
                        "bound_ms": offs_pipe_rec[2][0], "library_ms": offs_pipe_rec[3]})
    for lane_t in lane_times.values():
        offs_shapes += lane_t.offsets
    ms, plain, bound, lib = many_rec["block_offsets"]
    offs_shapes.append({"what": "many1k folded chunk", "ms": ms, "plain_ms": plain,
                        "bound_ms": bound[0], "library_ms": lib})
    rng_o = np.random.default_rng(SEED + 19)
    for n_o in (129864, (1 << 22) + 7):
        counts_o = torch.from_numpy(rng_o.integers(0, 100, n_o).astype(np.int32)).to(dev)
        offs_shapes.append(offsets_times(tpb, torch, counts_o, f"synthetic, {n_o} counts"))
    range_recs = [compare_ranges(ctx, fuzzy, corpus, 0.8, "dp_pipeline (FAST) in ranges"),
                  compare_ranges(ctx, typed_e, lane_runs["4d"].text, 0.8,
                                 "the typed step in ranges")]
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    src = f"{PKG}/csrc/packed_bitap.cu"
    jax_pb = "fuzzy_aho_corasick_tpu/ops/packed_bitap.py"

    def record(name, source, replaces, n_launch, err, ms, plain_ms, bound, lib, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib, **extra}

    # Phase 4i's paths (the streams, the prefilter, the loaded engines):
    # their launches count as the main path's too.
    entry_launches = [entry[tag].launches for tag in ("4i (a) fuzzy1", "4i (b) exact",
                                                      "4i (c) joined")]
    entry_launches += [rec["launches"] for rec in entry["4i (d)"].values()
                       if isinstance(rec, dict)]
    entry_launches += [run.launches for run in beam.values()]

    def entry_sum(name):
        return sum(counts[name] for counts in entry_launches)

    kernels = []
    for i, (name, replaces) in enumerate((
        ("scan_bits", f"{jax_pb}:534"), ("block_offsets", "fuzzy_aho_corasick_tpu/ops/compact.py:1"),
        ("hit_words", f"{jax_pb}:620"),
    )):
        ms, plain, bound, lib = scan_rec["exact"][name]
        f_ms, f_plain, f_bound, _lib = scan_rec["fuzzy"][name]
        kernels.append(record(
            name, src, replaces, launches[name] + launches_f[name]
            + sum(lane.launches[name] for lane in (*lane_runs.values(), *many_runs.values(),
                                                   *exact_runs.values())) + entry_sum(name)
            + k4_sum(name),
            errs_scan[i], ms, plain,
            bound, lib, launches_4k=k4_sum(name), fuzzy_ms=f_ms, fuzzy_plain_ms=f_plain,
            fuzzy_bound_ms=f_bound[0],
            **({"pipeline_counts_ms": offs_pipe_rec[0], "pipeline_counts_plain_ms": offs_pipe_rec[1],
                "pipeline_counts_bound_ms": offs_pipe_rec[2][0],
                "pipeline_counts_library_ms": offs_pipe_rec[3],
                "many1k_counts_ms": many_rec[name][0], "many1k_counts_plain_ms": many_rec[name][1],
                "many1k_counts_bound_ms": many_rec[name][2][0],
                "many1k_counts_library_ms": many_rec[name][3],
                "shapes": offs_shapes} if name == "block_offsets" else {}),
            device_ms_per_exact_search=search_ms(prof_x, name),
            device_ms_per_fuzzy_search=search_ms(prof_f, name)))
    kernels.append(record(
        "dp_pipeline", f"{PKG}/csrc/dp_pipeline.cu", "fuzzy_aho_corasick_tpu/ops/verify_dp.py:1297",
        launches_f["dp_pipeline"] + entry_sum("dp_pipeline") + k4_sum("dp_pipeline", K4_FAST),
        err_pipe_all, pipe_ms, pipe_plain_ms, pipe_bound, None,
        launches_4k=k4_sum("dp_pipeline", K4_FAST),
        device_ms_per_fuzzy_search=search_ms(prof_f, "dp_pipeline")))
    # The DP-only kernel shares the pipeline's DP body; no search runs it, so
    # it is held against its plain version here and not counted on a path.
    held = [record("banded_dp", f"{PKG}/csrc/banded_dp.cu",
                   "fuzzy_aho_corasick_tpu/ops/verify_dp.py:292", 0, err_dp_all, dp_ms,
                   dp_plain_ms, dp_bound, None)]
    # The count-channel list step of phases 4c, 4c' and 4e (and of their
    # sharded searches and the dry run in 4k): its DP and its emission, timed
    # at slice 1 of forbid2 (the record's ms) and of mapped; the DP-only
    # entry point of the forbid and mapped variants.
    jax_vd = "fuzzy_aho_corasick_tpu/ops/verify_dp.py"
    list_tags = ("4c", "4c'", "4e")
    f_t, m_t = lane_times["4c"], lane_times["4e"]
    # count_dp's E >= 4 form, count_dp_rows_kernel, has its own record below
    # (mapped4's searches): its launches are left out here, count_emit's not.
    for name, replaces, tags, skip in (
            ("count_dp", f"{jax_vd}:355, {jax_vd}:611", list_tags, DEEP_K4),
            ("count_emit", f"{jax_vd}:1487", list_tags + ("4e''",), ())):
        kernels.append(record(
            name, f"{PKG}/csrc/dp_list.cu", replaces,
            sum(lane_runs[tag].launches[name] for tag in tags) + entry_sum(name)
            + k4_sum(name, skip=skip), lane_errs[name], *f_t.steps[name],
            launches_4k=k4_sum(name, skip=skip),
            device_ms_per_search={tag: search_ms(lane_runs[tag].prof, name)
                                  for tag in list_tags},
            mapped_ms=m_t.steps[name][0], mapped_plain_ms=m_t.steps[name][1],
            mapped_bound_ms=m_t.steps[name][2][0],
            instance={"forbid2": f_t.regs[name], "mapped": m_t.regs[name]},
            step_ms={"forbid2": f_t.pipe[0], "mapped": m_t.pipe[0]},
            step_device_ms={"forbid2": f_t.device_ms, "mapped": m_t.device_ms}))
    # count_dp_rows_kernel<E, MAPS> (E = 4..6): mapped4's searches (4e'' and
    # its sharded ones in 4k (a)), timed at slice 1 of mapped4; every
    # instance held against its plain version in phase 3.
    m4_t, m4_run = lane_times["4e''"], lane_runs["4e''"]
    kernels.append(record(
        "count_dp[rows, maps]", f"{PKG}/csrc/dp_list.cu", f"{jax_vd}:611",
        m4_run.launches["count_dp"] + k4_sum("count_dp", DEEP_K4), lane_errs["count_dp"],
        *m4_t.steps["count_dp"], launches_4k=k4_sum("count_dp", DEEP_K4),
        device_ms_per_search=search_ms(m4_run.prof, "count_dp", "count_dp_rows_kernel"),
        instance=m4_t.regs["count_dp"], instances=rows_regs,
        step_ms=m4_t.pipe[0], step_device_ms=m4_t.device_ms))
    for tag, dp_name, dp_replaces in (("4c", "banded_dp[forbid]", f"{jax_vd}:355"),
                                      ("4e", "banded_dp[maps]", f"{jax_vd}:611")):
        held.append(record(dp_name, f"{PKG}/csrc/banded_dp.cu", dp_replaces, 0, err_dp_all,
                           *lane_times[tag].dp, None))
    # The typed step of phases 4d and 4d', a kernel each: what their
    # searches launched, the times at slice 1 of 4d (typed) and of 4d'
    # (typed14), and the DP-only entry point. The DP is two kernels: up to
    # 32 cells typed_dp_kernel<G> (4d), past them typed_dp_rows_kernel<E, S,
    # G> (4d', every instance held against its plain version in phase 3).
    # The emission is the list step's count_emit_kernel.
    lane, lane_t, t14, run14 = lane_runs["4d"], lane_times["4d"], lane_times["4d'"], lane_runs["4d'"]
    lane_errs["typed_emit"] = max(lane_errs["typed_emit"], lane_errs["typed_step"])
    lane_errs["count_emit"] = max(lane_errs["count_emit"], lane_errs["list_step"])
    for name, source, replaces in (("typed_expand", "dp_typed.cu", f"{jax_vd}:1411"),
                                   ("typed_emit", "dp_list.cu", f"{jax_vd}:1208")):
        # The expansion serves the list step too: its launches are both steps'.
        n_list = sum(lane_runs[tag].launches[name] for tag in list_tags + ("4e''",))
        kern_name = KERNEL_OF.get(name, name + "_kernel")
        kernels.append(record(
            name, f"{PKG}/csrc/{source}", replaces,
            lane.launches[name] + run14.launches[name] + n_list + k4_sum(name),
            lane_errs[name], *lane_t.steps[name], launches_4k=k4_sum(name),
            device_ms_per_search={tag: search_ms(lane_runs[tag].prof, name, kern_name)
                                  for tag in ("4d", "4d'")},
            typed14_ms=t14.steps[name][0], typed14_plain_ms=t14.steps[name][1],
            typed14_bound_ms=t14.steps[name][2][0], instance=lane_t.regs[name],
            **({"list_step": {tag: {"ms": lane_times[tag].steps[name][0],
                                    "plain_ms": lane_times[tag].steps[name][1],
                                    "bound_ms": lane_times[tag].steps[name][2][0],
                                    "device_ms_per_search": search_ms(lane_runs[tag].prof, name,
                                                                      name)}
                              for tag in ("4c", "4e", "4e''")}} if name == "typed_expand"
               else {"kernel": "count_emit_kernel"})))
    kernels.append(record(
        "typed_dp", f"{PKG}/csrc/dp_typed.cu", f"{jax_vd}:935",
        lane.launches["typed_dp"] + k4_sum("typed_dp"), lane_errs["typed_dp"],
        *lane_t.steps["typed_dp"], launches_4k=k4_sum("typed_dp"),
        device_ms_per_search=search_ms(lane.prof, "typed_dp"), instance=lane_t.regs["typed_dp"]))
    kernels.append(record(
        "typed_dp[rows]", f"{PKG}/csrc/dp_typed.cu", f"{jax_vd}:935",
        run14.launches["typed_dp"], lane_errs["typed_dp"], *t14.steps["typed_dp"],
        launches_4k=0,
        device_ms_per_search=search_ms(run14.prof, "typed_dp", "typed_dp_rows_kernel"),
        instance=t14.regs["typed_dp"], instances=typed_rows_regs,
        step_ms=t14.pipe[0], step_device_ms=t14.device_ms))
    held.append(record("banded_dp_typed", f"{PKG}/csrc/dp_typed.cu", f"{jax_vd}:935", 0,
                       lane_errs["banded_dp_typed"], *lane_t.dp, None))
    # The large-dictionary lane of phase 4f: the kernels its searches
    # launched, at the folded layout's main-path shape.
    jax_many = "fuzzy_aho_corasick_tpu/ops/many.py"
    for name, source, replaces in (
        ("scan_bits_wide", "scan_wide.cu", f"{jax_pb}:534"),
        ("hit_words_wide", "scan_wide.cu", f"{jax_pb}:620"),
        ("many_step", "many_step.cu", f"{jax_many}:330, {jax_many}:469"),
    ):
        kernels.append(record(
            name, f"{PKG}/csrc/{source}", replaces,
            sum(run.launches[name] for run in many_runs.values()) + entry_sum(name)
            + k4_sum(name, skip=DEEP_K4),
            many_errs[name],
            *many_rec[name], launches_4k=k4_sum(name, skip=DEEP_K4),
            device_ms_per_search={tag: search_ms(run.prof, name)
                                  for tag, run in many_runs.items()},
            **({"pass_device_ms": step_passes} if name == "many_step" else
               wide_fields(many_detail, name))))
    # The wide kernels at k = 0, the exact-wide search of phase 4g.
    for name, replaces in (("scan_bits_wide[k=0]", f"{jax_pb}:534"),
                           ("hit_words_wide[k=0]", f"{jax_pb}:620")):
        base = name.split("[")[0]
        kernels.append(record(
            name, f"{PKG}/csrc/scan_wide.cu", replaces, exact_runs["exact-wide"].launches[base],
            wide_errs[name], *wide_rec[name], launches_4k=0,
            device_ms_per_search=search_ms(exact_runs["exact-wide"].prof, base),
            **wide_fields(wide_detail, base)))
    # The wide kernels past six rows (the deep instances): mapped4's searches
    # (4e'' and its sharded ones in 4k (a)), timed at mapped4's shape.
    for name, replaces in (("scan_bits_wide[k=7..24]", f"{jax_pb}:534"),
                           ("hit_words_wide[k=7..24]", f"{jax_pb}:620")):
        base = name.split("[")[0]
        kernels.append(record(
            name, f"{PKG}/csrc/scan_wide.cu", replaces,
            lane_runs["4e''"].launches[base] + k4_sum(base, DEEP_K4), deep_errs[name],
            *deep_rec[name], launches_4k=k4_sum(base, DEEP_K4),
            device_ms_per_search=search_ms(lane_runs["4e''"].prof, base),
            **wide_fields(deep_detail, base)))
    # The goto walk at exact1k's shape; its launches on every main path:
    # exact1k (4h), the seed filter's exact pass (4j) and the sharded exact
    # lane (4k).
    kernels.append(record(
        "goto_walk", f"{PKG}/csrc/goto_walk.cu", "fuzzy_aho_corasick_tpu/ops/exact.py:45",
        exact_runs["exact1k"].launches["goto_walk"] + entry_sum("goto_walk")
        + k4_sum("goto_walk"), walk_err, walk_t["ms"], walk_t["plain_ms"], walk_t["bound"],
        walk_t["library_ms"], launches_4k=k4_sum("goto_walk"),
        kernels=["goto_walk_count_kernel", "goto_walk_emit_kernel"],
        library_call="torch.gather of the goto table's root row (the root step alone)",
        device_ms_per_search=device_ms(exact_runs["exact1k"].prof, "goto_walk_"),
        **{k: walk_t[k] for k in ("pass_device_ms", "alive_per_span", "arrivals", "tiles",
                                  "launches_copies_waits_per_walk", "exact1k_host_split_ms")}))
    # The beam frontier's kernels: their launches on 4j (a)-(d), the record's
    # times on the first run of (d) (the pool) and of (c) (the sorted beam),
    # every cell's first run and 4j (e)'s small shapes beside them, ptxas's
    # registers and spills, and the frontier's launches and host waits per
    # search; the order kernel timed on (a)'s first run (the most emissions).
    per_search = {tag: {"launches": run.stages.prof_f["kernels"],
                        "waits": run.stages.prof_f["waits"],
                        "counted": {k: v for k, v in run.stages.prof_f["counted"].items() if v},
                        "runs": run.stages.runs} for tag, run in beam.items()}
    for lane, cells in ((1, ("4j (a)", "4j (b)", "4j (d)")), (2, ("4j (c)",))):
        pairs, replaces = FRONTIER_KERNELS[lane]
        runs = {tag: frontier_runs[tag] for tag in cells}
        main = runs[cells[-1]]
        small = [r for r in frontier_small if (r["E"] == 1) == (lane == 1)]
        for i, (key, kname) in enumerate(pairs):
            # The lane's first kernel carries the wrapper's time (both of its
            # kernels, block_offsets, the read, the order kernel) and the
            # lane's bound; a second one (the pool's warp path) its own device
            # time over both phases and the bound of what it moves (the
            # starts handed to it and their emissions). The plain version is
            # the lane's function's.
            kernels.append(record(
                key, f"{PKG}/csrc/beam.cu", replaces, entry_sum(key),
                max(r["max_abs_err"] for r in (*runs.values(), *small)),
                main["ms"] if i == 0 else main["device_ms"][kname], main["plain_ms"],
                main["bound"] if i == 0 else main["warp_bound"], None, launches_4k=0,
                kernel=kname,
                ms_is="the wrapper by events" if i == 0 else "its device ms over both phases",
                launch_ms=main["launch_ms"][kname],
                device_ms_per_search={tag: search_ms(beam[tag].prof, key, kname) for tag in cells},
                frontier_per_search={tag: per_search[tag] for tag in cells},
                registers={k: v for k, v in regs_f.items() if kname + "<" in k},
                first_runs={tag: {k: (v[0] if k in ("bound", "order_bound", "warp_bound")
                                      else v)
                                  for k, v in r.items()} for tag, r in runs.items()},
                shapes=small))
    first = frontier_runs["4j (a)"]
    kernels.append(record(
        "beam_order", f"{PKG}/csrc/beam.cu",
        "fuzzy_aho_corasick_tpu/ops/fuzzy.py:57 (the emission order of both frontier kernels)",
        entry_sum("beam_order"),
        max(r["max_abs_err"] for r in (*frontier_runs.values(), *frontier_small)),
        first["order_ms"], first["order_plain_ms"], first["order_bound"], None, launches_4k=0,
        kernel="beam_order_kernel", launch_ms=first["order_launch_ms"],
        registers={"beam_order_kernel": regs_f["beam_order_kernel"]},
        first_runs={tag: {k: r.get(k) for k in ("emissions", "order_ms", "order_plain_ms",
                                                 "order_launch_ms")}
                    for tag, r in frontier_runs.items()},
        library_call="none: a stable sort of the run's (chunk, round) keys gives the "
                     "permutation, not the moved emissions"))
    ranged = [{"name": f"{key}[3 ranges]", "one_range_ms": one, "three_ranges_ms": three,
               "plain_three_ranges_ms": plain} for key, one, three, plain in range_recs]
    streams = {tag: {"bytes": run.nbytes, "ms": [t * 1e3 for t in run.times],
                     "mb_per_s": run.nbytes / min(run.times) / 1e6, "stages": run.stages,
                     "replacements": run.replacements, "launches": run.launches,
                     "producer_alone_ms": run.prep_ms, "replace_stream_s": run.seq_s}
               for tag, run in entry.items() if tag.startswith(("4i (a)", "4i (b)"))}
    jr = entry["4i (c) joined"]
    streams["4i (c) joined"] = {"bytes": jr.nbytes, "s": jr.seconds, "matches": jr.matches,
                                "oracle_raw_matches": jr.raw, "launches": jr.launches,
                                "lru_device_bytes": jr.held,
                                "lru_device_bytes_before": jr.held_before,
                                "torch_allocated_bytes": jr.allocated}
    streams["4i (d)"] = entry["4i (d)"]
    print(json.dumps({"kernels": kernels, "held_against_plain_only": held,
                      "entry_points": streams,
                      "ranged_pipelines": ranged,
                      "phase_4k": {
                          "seconds": k4_s,
                          "sharded": {tag: {
                              "bytes": cell.nbytes, "first_ms": cell.first * 1e3,
                              "ms": [t * 1e3 for t in cell.times],
                              "mb_per_s": cell.nbytes / min(cell.times) / 1e6,
                              "matches": cell.matches, "last_stats": cell.stats,
                              "launches": cell.launches,
                              **({"launches_copies_waits": [cell.prof["kernels"],
                                                            cell.prof["copies"],
                                                            cell.prof["waits"]],
                                  "profiled_wall_ms": cell.prof["wall"],
                                  "device_busy_ms": cell.prof["busy"]}
                                 if cell.prof is not None else {})}
                              for tag, cell in sharded.items()},
                          "dryrun": dry, "dryrun_launches": k4["dryrun"][0],
                          "replace_multihost": multi["c"], "two_processes": multi["d"],
                          "max_abs_err": errs_4k},
                      "torch_paths": [beam_record(tag, run) for tag, run in beam.items()],
                      "scan_chunk_sweep": sweep,
                      "searches": {
                          "exact_ms": [t * 1e3 for t in times],
                          "typed_step_device_ms_per_search": lane_runs["4d"].step_ms,
                          "fuzzy_ms": [t * 1e3 for t in times_f],
                          **{f"{tag.replace(' ', '_')}_ms": [t * 1e3 for t in run.times]
                             for tag, run in many_runs.items()},
                          **{f"{tag.replace(' ', '_')}_launches_copies_waits": [
                              run.prof["kernels"], run.prof["copies"], run.prof["waits"]]
                             for tag, run in many_runs.items()},
                          **{f"{tag}_ms": [t * 1e3 for t in lane.times]
                             for tag, lane in lane_runs.items()},
                          **{f"{tag}_launches_copies_waits": [
                              lane.prof["kernels"], lane.prof["copies"], lane.prof["waits"]]
                             for tag, lane in lane_runs.items()},
                          "exact_launches_copies_waits": [prof_x["kernels"], prof_x["copies"], prof_x["waits"]],
                          **{f"{tag}_ms": [t * 1e3 for t in run.times]
                             for tag, run in exact_runs.items()},
                          **{f"{tag}_launches_copies_waits": [
                              run.prof["kernels"], run.prof["copies"], run.prof["waits"]]
                             for tag, run in exact_runs.items()},
                          "fuzzy_launches_copies_waits": [prof_f["kernels"], prof_f["copies"], prof_f["waits"]]}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
