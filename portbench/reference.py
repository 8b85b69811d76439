"""The plain reference: the raw fuzzy match set, in NumPy and plain PyTorch.

It imports nothing of the port and nothing of JAX, and it takes nothing
the port made: it is handed the pattern strings, the limits, the threshold
and the mappings as the configuration states them, and the text as bytes.
From those it works out again everything the port derives: the trie's
prefixes and outputs, the per-node prune ceilings, the similarity table,
the penalties and the mapping transitions.

The semantics are the upstream crate's per-start search (``src/search.rs``
of ``fuzzy-aho-corasick``), for an engine with a total edit budget E (its
fast path), no per-pattern limits, no beam, unit pattern weights and an
ASCII text. For each start s the search walks the trie from the root with
states (node, position, span, edit counts, penalty):

* exact: the node's edge on the text character (penalty 0);
* substitution: another edge, penalty ``p_sub * (1 - sim(edge, char))``,
  skipped where it passes the remaining budget ``max_pen - penalty``;
* mapping: a pattern-side grapheme string on the trie against its
  text-side string, penalty ``p_sub * (1 - score)``, kept while the new
  penalty is at most ``max_pen``; it counts as a substitution;
* swap: the node's path on the next two characters in the other order,
  ``p_swap``;
* insertion: a text character skipped, ``p_ins``, never before the first
  character is consumed; the span's end stays;
* deletion: an edge taken without a character, ``p_del``, also at the end
  of the text.

Each edit needs ``edits < E``; a state whose penalty passes its node's
ceiling ``prune_len - prune_len / weight * threshold`` is dropped. A state
at a node emits every pattern that is a suffix of the node's string (the
Aho-Corasick outputs), with similarity ``(len - penalty) / len * weight``,
kept at or above the threshold; the best similarity per (pattern, start,
end) is the result. Every sum and product is float32, in the order of the
path, as the crate computes it.

How it is computed:

1. candidate starts (``candidate_starts``): for each emitting node string
   u, a semi-global edit distance of the reversed u against the reversed
   text, each edit of any kind counted 1 and capped at E + 1, row by row
   over the whole text on the device; a start whose distance passes E holds
   no match of u (sound: every match's path is such an alignment);
2. the exact penalties (``exact_rows``): at each candidate (u, start), a
   dynamic program over (node depth, text offset, edit counts by kind)
   keeping the least penalty, in two layers (the span's end at the offset,
   or before it after insertions). Least penalties with the same counts
   dominate the crate's search states, whose deduplication keys are those
   counts, and every guard above is monotone in the penalty, so the least
   penalties are the crate's, bit for bit;
3. the similarities, the threshold and the best per (pattern, start, end),
   in NumPy float32. Where more than one set of edit counts reaches the
   best similarity (a tie), every such set is kept: the crate's choice among
   them follows its queue's order, which is not part of the match.

``dtype=torch.bfloat16`` computes the penalties and similarities in
bfloat16: the control that the comparison has to fail.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

f32 = np.float32

#: The crate's default penalties (src/structs.rs:381-393), float32.
P_SUB = f32(f32(1.1) * f32(1.3))
P_INS = f32(f32(0.4) * f32(1.3))
P_DEL = f32(f32(0.7) * f32(1.3))
P_SWAP = f32(f32(0.4) * f32(1.3))
#: Edit kinds, in the order of a breakdown tuple (insertions, deletions,
#: substitutions, swaps).
INS, DEL, SUB, SWAP = range(4)
#: Bytes of state one block of candidates of the exact program may hold,
#: on the card and on the CPU.
BLOCK_BYTES = {"cuda": 1 << 33, "cpu": 1 << 28}


def similarity_table() -> np.ndarray:
    """The crate's default substitution similarity (src/builder.rs:492-526)
    as a 128 x 128 float32 table [pattern char, text char]: 1 on the
    diagonal, 0.6 between two vowels, 0.4 between two consonants, a few
    letter and digit look-alikes, else 0."""
    t = np.zeros((128, 128), np.float32)
    np.fill_diagonal(t, 1.0)
    vowels = "aeiou"
    consonants = [chr(c) for c in range(ord("a"), ord("z") + 1) if chr(c) not in vowels]
    for a in vowels:
        for b in vowels:
            if a != b:
                t[ord(a), ord(b)] = f32(0.6)
    for a in consonants:
        for b in consonants:
            if a != b:
                t[ord(a), ord(b)] = f32(0.4)
    for a, b, s in (("o", "0", 0.6), ("l", "1", 0.7), ("i", "1", 0.6), ("s", "5", 0.5)):
        t[ord(a), ord(b)] = t[ord(b), ord(a)] = f32(s)
    return t


def breakdowns(E: int):
    """Every (insertions, deletions, substitutions, swaps) with at most E in
    all, and for each kind the index of the breakdown with one fewer of it
    (``len`` where there is none): the program's transitions in counts."""
    combos = [c for c in itertools.product(range(E + 1), repeat=4) if sum(c) <= E]
    index = {c: i for i, c in enumerate(combos)}
    src = []
    for kind in range(4):
        row = []
        for c in combos:
            if c[kind] == 0:
                row.append(len(combos))
            else:
                d = list(c)
                d[kind] -= 1
                row.append(index[tuple(d)])
        src.append(row)
    return combos, src


class Problem:
    """What the reference is told, and what it derives from it."""

    def __init__(self, patterns, edits: int, threshold: float, mappings=(),
                 case_insensitive: bool = True):
        fold = (lambda s: s.lower()) if case_insensitive else (lambda s: s)
        self.patterns = [fold(p) for p in patterns]
        for p in self.patterns:
            if not p or not p.isascii():
                raise ValueError(f"the reference takes non-empty ASCII patterns, not {p!r}")
        self.case_insensitive = case_insensitive
        self.E = int(edits)
        self.thr = f32(threshold)
        # Trie nodes are the prefixes of the patterns. reach[u]: the longest
        # pattern below u (unit weights: prune_len / weight = prune_len).
        reach = {}
        for p in self.patterns:
            for i in range(len(p) + 1):
                reach[p[:i]] = max(reach.get(p[:i], 0), len(p))
        by_string = {}
        for q, p in enumerate(self.patterns):
            by_string.setdefault(p, []).append(q)
        # Outputs: every pattern that is a suffix of the node's string.
        outputs = {}
        for u in reach:
            outs = [q for k in range(len(u)) for q in by_string.get(u[k:], ())]
            if outs:
                outputs[u] = sorted(outs)
        self.emitting = sorted(outputs)
        self.outputs = [outputs[u] for u in self.emitting]
        self.ceil = {u: f32(f32(L) - f32(f32(L) * self.thr)) for u, L in reach.items()}
        self.max_pen = self.ceil[""]
        self.ceilings = [np.array([self.ceil[u[:i]] for i in range(len(u) + 1)], np.float32)
                         for u in self.emitting]
        # Directed mapping transitions (pattern side, text side, penalty),
        # src/builder.rs:383-442.
        self.maps = []
        for a, b, score in mappings:
            ga, gb = fold(a), fold(b)
            if not ga or not gb or ga == gb:
                continue
            pen = f32(P_SUB * f32(f32(1.0) - f32(score)))
            self.maps += [(ga, gb, pen), (gb, ga, pen)]
        sim = similarity_table()
        self.subpen = (P_SUB * (f32(1.0) - sim)).astype(np.float32)
        self.grow = max([1] + [len(h) - len(p) for p, h, _ in self.maps])

    def span_max(self, u_len: int) -> int:
        """The longest text span a path over ``u_len`` pattern characters
        with at most E edits consumes."""
        return u_len + self.E * self.grow


def text_tensor(text: str, case_insensitive: bool, device) -> torch.Tensor:
    raw = np.frombuffer(text.encode("ascii"), np.uint8)
    if case_insensitive:
        raw = np.where((raw >= 65) & (raw <= 90), raw + 32, raw).astype(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(raw)).to(device)


class BitText:
    """The reversed text as bit masks over the reversed ends j = 0 .. n,
    64 to an int64 word: ``mask(c)`` has bit j set where the character
    consumed on the way to j, ``rev[j - 1]``, is c."""

    def __init__(self, text: torch.Tensor):
        self.n = n = text.numel()
        self.words = (n + 1 + 63) // 64
        self.rev = torch.flip(text, (0,))
        self.weights = (torch.ones(64, dtype=torch.int64, device=text.device)
                        << torch.arange(64, device=text.device))
        self.weights[63] = -(1 << 63)
        self._masks = {}

    def pack(self, bits: torch.Tensor) -> torch.Tensor:
        """Bools over j = 0 .. n as int64 words."""
        pad = torch.zeros(self.words * 64, dtype=torch.bool, device=bits.device)
        pad[:bits.numel()] = bits
        return (pad.reshape(-1, 64).long() * self.weights).sum(1)

    def mask(self, c: str) -> torch.Tensor:
        m = self._masks.get(c)
        if m is None:
            bits = torch.zeros(self.n + 1, dtype=torch.bool, device=self.rev.device)
            bits[1:] = self.rev == ord(c)
            m = self._masks[c] = self.pack(bits)
        return m

    def ones(self) -> torch.Tensor:
        return self.pack(torch.ones(self.n + 1, dtype=torch.bool, device=self.rev.device))

    def positions(self, m: torch.Tensor) -> torch.Tensor:
        """The j (ascending) whose bit is set in ``m``."""
        nz = torch.nonzero(m).reshape(-1)
        bits = (m[nz, None] >> torch.arange(64, device=m.device)) & 1
        w, b = torch.nonzero(bits, as_tuple=True)
        j = nz[w] * 64 + b
        return j[j <= self.n]


def shift(m: torch.Tensor, k: int) -> torch.Tensor:
    """Bit j of the result is bit j - k of ``m`` (0 < k < 64)."""
    carry = torch.zeros_like(m)
    carry[1:] = (m[:-1] >> (64 - k)) & ((1 << k) - 1)
    return (m << k) | carry


def candidate_starts(problem: Problem, bt: BitText, u: str) -> torch.Tensor:
    """The starts (int64, ascending) at which u may match within E edits:
    the semi-global unit-cost edit distance of reversed u against the
    reversed text, in Wu and Manber's bit-parallel form over the text
    (Myers' and Navarro's survey, section 6): ``M[e]`` of row i has bit j set
    where the last i characters of u align with edits <= e ending at
    reversed end j; a row's masks follow from the rows above and, by
    increasing e, from its own (insertions)."""
    E = problem.E
    ur = u[::-1]
    maps = [(p[::-1], h[::-1]) for p, h, _ in problem.maps]
    zero = torch.zeros(bt.words, dtype=torch.int64, device=bt.rev.device)
    rows = [[bt.ones()] * (E + 1)]
    keep = max([2] + [len(p) for p, _ in maps])
    for i in range(1, len(ur) + 1):
        up = rows[-1]
        up1 = [shift(m, 1) for m in up]
        c = bt.mask(ur[i - 1])
        sw = shift(c, 1) & bt.mask(ur[i - 2]) if i >= 2 and E else None
        here = []
        for e in range(E + 1):
            m = up1[e] & c                                            # matched
            if e:
                m |= up1[e - 1] | up[e - 1] | shift(here[e - 1], 1)  # sub, del, ins
                if sw is not None:                                    # swap
                    m |= shift(rows[-2][e - 1], 2) & sw
                for p, h in maps:                                    # mapping
                    lp, lh = len(p), len(h)
                    if i >= lp and ur[i - lp:i] == p:
                        cond = shift(rows[-lp][e - 1], lh)
                        for k, ch in enumerate(h):
                            mk = bt.mask(ch)
                            cond &= shift(mk, lh - 1 - k) if lh - 1 - k else mk
                        m |= cond
            here.append(m)
        rows.append(here)
        if len(rows) > keep + 1:
            rows.pop(0)
    ends = bt.positions(rows[-1][E] if rows[-1] else zero)
    ends = ends[ends >= 1]
    return torch.flip(bt.n - ends, (0,))


def exact_rows(problem: Problem, text: torch.Tensor, cand_u: np.ndarray, cand_s: np.ndarray,
               dtype=torch.float32):
    """The least penalty of every (candidate, end offset, breakdown) at the
    candidate's emitting node, as NumPy arrays (candidate, offset,
    breakdown, penalty as float32), for the candidates (u index, start)."""
    combos, src = breakdowns(problem.E)
    NB = len(combos)
    dev = text.device
    out = []
    if cand_u.size == 0:
        return (np.zeros(0, np.int64),) * 3 + (np.zeros(0, np.float32),)
    L = max(len(problem.emitting[u]) for u in np.unique(cand_u).tolist())
    W = problem.span_max(L) + 2
    per = max(1, BLOCK_BYTES[dev.type] // (24 * (W + 1) * (NB + 1) * 4))
    for lo in range(0, cand_u.size, per):
        blk = np.arange(lo, min(lo + per, cand_u.size))
        c, j, b, pen = _exact_block(problem, text, L, W, cand_u[blk], cand_s[blk], src, NB,
                                    dtype, dev)
        out.append((blk[c], j, b, pen))
    cat = [np.concatenate([o[k] for o in out]) for k in range(4)]
    return cat[0], cat[1], cat[2], cat[3]


def _exact_block(problem, text, L, W, us, ss, src, NB, dtype, dev):
    """Row by row over the node depth i, every text offset j = 0 .. W and
    breakdown at once: ``D[i]`` the states whose span ends at j, ``I[i]``
    those past their span's end (after insertions), [C, W + 1, NB + 1], the
    last column of a breakdown +inf (no such breakdown)."""
    E = problem.E
    n = text.numel()
    C = us.size
    inf = float("inf")
    s_t = torch.from_numpy(ss).to(dev)
    at = s_t[:, None] + torch.arange(W, device=dev)[None, :]
    valid = at < n                                     # offset j - 1 consumable
    tc = torch.where(valid, text[at.clamp(max=n - 1)].long(), torch.zeros_like(at))
    ulen = torch.tensor([len(problem.emitting[u]) for u in us.tolist()], device=dev)
    pc = torch.zeros(C, L, dtype=torch.long, device=dev)
    ceil = torch.full((C, L + 1), -inf, dtype=dtype, device=dev)
    for k, u in enumerate(us.tolist()):
        word = problem.emitting[u]
        pc[k, :len(word)] = torch.tensor([ord(ch) for ch in word])
        ceil[k, :len(word) + 1] = torch.from_numpy(problem.ceilings[u]).to(dtype)
    subpen = torch.from_numpy(problem.subpen).to(dev, dtype).reshape(-1)
    max_pen = torch.tensor(float(problem.max_pen), dtype=dtype, device=dev)
    pins, pdel, pswap = (torch.tensor(float(p), dtype=dtype, device=dev)
                         for p in (P_INS, P_DEL, P_SWAP))
    srcs = [torch.tensor(x, dtype=torch.long, device=dev) for x in src]
    INF = torch.tensor(inf, dtype=dtype, device=dev)

    def step(g, add):
        """g + add where the edit passes the remaining budget max_pen - g."""
        return torch.where(add <= max_pen - g, g + add, INF)

    def grid():
        return torch.full((C, W + 1, NB + 1), inf, dtype=dtype, device=dev)

    def prune(t, i):
        t[..., :NB] = torch.where(t[..., :NB] > ceil[:, i, None, None], INF, t[..., :NB])
        return t

    maps = []
    for p, h, mpen in problem.maps:
        lh = len(h)
        cols = valid[:, lh - 1:]
        for k, ch in enumerate(h):
            cols = cols & (tc[:, k:W - lh + 1 + k] == ord(ch))
        maps.append((p, lh, torch.tensor(float(mpen), dtype=dtype, device=dev),
                     torch.tensor([ord(ch) for ch in p], device=dev), cols))
    emit = torch.full((C, W + 1, NB), inf, dtype=dtype, device=dev)
    D0 = grid()
    D0[:, 0, 0] = 0
    Ds, Is = [D0], [grid()]
    for i in range(1, L + 1):
        Dp, Ip = Ds[-1], Is[-1]
        S = torch.minimum(Dp, Ip)
        d = grid()
        d[..., :NB] = step(Dp[..., srcs[DEL]], pdel)          # a deletion keeps the layer
        eq = (tc == pc[:, i - 1:i]) & valid
        x = torch.where(eq[..., None], S[:, :-1, :NB], INF)     # exact
        pen = subpen[pc[:, i - 1:i] * 128 + tc][..., None]
        x = torch.minimum(x, torch.where((~eq & valid)[..., None],
                                         step(S[:, :-1][..., srcs[SUB]], pen), INF))
        d[:, 1:, :NB] = torch.minimum(d[:, 1:, :NB], x)
        if i >= 2:                                               # a swap
            S2 = torch.minimum(Ds[-2], Is[-2])
            sw = ((tc[:, :-1] == pc[:, i - 1:i]) & (tc[:, 1:] == pc[:, i - 2:i - 1])
                  & valid[:, 1:])
            d[:, 2:, :NB] = torch.minimum(d[:, 2:, :NB], torch.where(
                sw[..., None], step(S2[:, :-2][..., srcs[SWAP]], pswap), INF))
        for p, lh, mpen, pt, cols in maps:                       # a mapping
            lp = len(p)
            if i >= lp and len(Ds) >= lp:
                Sm = torch.minimum(Ds[-lp], Is[-lp])
                hit = (pc[:, i - lp:i] == pt).all(1)[:, None] & cols
                g = Sm[:, :W + 1 - lh][..., srcs[SUB]] + mpen
                d[:, lh:, :NB] = torch.minimum(d[:, lh:, :NB], torch.where(
                    hit[..., None] & (g <= max_pen), g, INF))
        d = prune(d, i)
        ins = grid()
        ins[..., :NB] = step(Ip[..., srcs[DEL]], pdel)
        for _ in range(E):                                       # insertions
            g = torch.minimum(d[:, 1:W], ins[:, 1:W])[..., srcs[INS]]
            ins[:, 2:, :NB] = torch.minimum(ins[:, 2:, :NB], torch.where(
                valid[:, 1:W, None], step(g, pins), INF))
        ins = prune(ins, i)
        emit = torch.where((ulen == i)[:, None, None], d[..., :NB], emit)
        Ds.append(d)
        Is.append(ins)
        keep = max([2] + [len(p) for p, _, _, _, _ in maps])
        if len(Ds) > keep:
            Ds.pop(0)
            Is.pop(0)
    c, j, b = torch.nonzero(torch.isfinite(emit), as_tuple=True)
    pen = emit[c, j, b].float()
    return (c.cpu().numpy(), j.cpu().numpy(), b.cpu().numpy(), pen.cpu().numpy())


def match_set(problem: Problem, text: str, device="cpu", dtype=torch.float32, stats=None):
    """The raw match set of ``problem`` over ``text``: a dict (pattern,
    start, end) -> (similarity float32, frozenset of the breakdowns
    (insertions, deletions, substitutions, swaps) that reach it)."""
    clock = time.perf_counter()
    t = text_tensor(text, problem.case_insensitive, device)
    bt = BitText(t)
    cu, cs = [], []
    for ui, u in enumerate(problem.emitting):
        st = candidate_starts(problem, bt, u).cpu().numpy()
        cu.append(np.full(st.size, ui, np.int64))
        cs.append(st.astype(np.int64))
    del bt
    cand_u = np.concatenate(cu) if cu else np.zeros(0, np.int64)
    cand_s = np.concatenate(cs) if cs else np.zeros(0, np.int64)
    filtered = time.perf_counter()
    c, j, b, pen = exact_rows(problem, t, cand_u, cand_s, dtype)
    if stats is not None:
        stats.update(candidates=int(cand_u.size), filter_s=filtered - clock,
                     exact_s=time.perf_counter() - filtered)
    combos, _ = breakdowns(problem.E)
    result = {}
    thr = problem.thr
    for q_rows in _by_output(problem, cand_u[c]):
        rows, q = q_rows
        Lq = f32(len(problem.patterns[q]))
        if dtype == torch.float32:
            p = pen[rows]
            sim = ((Lq - p) / Lq).astype(np.float32) * f32(1.0)
            ok = sim >= thr
        else:
            p = torch.from_numpy(pen[rows]).to(dtype)
            lq = torch.tensor(float(Lq), dtype=dtype)
            s16 = ((lq - p) / lq) * torch.tensor(1.0, dtype=dtype)
            ok = (s16 >= torch.tensor(float(thr), dtype=dtype)).numpy()
            sim = s16.float().numpy()
        for r, sv in zip(rows[ok].tolist(), sim[ok].tolist()):
            key = (q, int(cand_s[c[r]]), int(cand_s[c[r]] + j[r]))
            bd = combos[int(b[r])]
            sv = f32(sv)
            have = result.get(key)
            if have is None or sv > have[0]:
                result[key] = (sv, {bd})
            elif sv == have[0]:
                have[1].add(bd)
    return {k: (v[0], frozenset(v[1])) for k, v in result.items()}


def _by_output(problem, us):
    """(row indices, pattern) for every output pattern of the rows' nodes."""
    for ui in np.unique(us):
        rows = np.flatnonzero(us == ui)
        for q in problem.outputs[int(ui)]:
            yield rows, q
