/* Native host fast paths for fuzzy_aho_corasick_tpu_torch (a copy of the
 * JAX package's native/fastpath.c; the two must stay bit-equal).
 *
 * The CUDA kernels consume dense symbol-id streams; these routines produce
 * them (and run the bit-parallel prefilter recurrence, the small-haystack
 * BFS search and the streaming replace's emission) at memory-bandwidth speed
 * on the host, replacing NumPy fancy-indexing loops. Compiled on first use
 * by utils/native.py (gcc -O3 -shared) into build/native/, bound via ctypes;
 * every entry point has a NumPy fallback so the package works without a
 * toolchain.
 *
 * Counterpart of the reference's host-side hot paths: the ASCII transcode
 * fast lane (reference src/prefilter.rs:251-259, src/grapheme.rs:76-125) and
 * the shift-AND scan (reference src/prefilter.rs:410-435).
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* Byte stream -> symbol ids via a 256-entry table (case folding baked in). */
void transcode_u8(const uint8_t *in, int64_t n, const uint8_t *table,
                  uint8_t *out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = table[in[i]];
  }
}

/* Byte stream -> int32 symbol ids via a 256-entry int32 table. */
void transcode_i32(const uint8_t *in, int64_t n, const int32_t *table,
                   int32_t *out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = table[in[i]];
  }
}

/* Bit-parallel Wu-Manber shift-AND scan over k+1 error rows (bit-exact port
 * of the recurrence at reference src/prefilter.rs:410-435). Sets hit[i] = 1
 * for every end position i+1 with levenshtein(pattern, window) <= k; the
 * caller derives candidate windows [end - m - k, end].
 *
 * mask: per-symbol-id bit masks, (alphabet + 1) entries.
 * r, nr: caller-provided scratch of k+1 u64 each (r pre-initialised to the
 *        (1 << d) - 1 start state, so chunks can resume mid-stream).
 */
void bitap_scan(const uint64_t *mask, int32_t m, int32_t k, const uint8_t *ids,
                int64_t n, uint64_t *r, uint64_t *nr, uint8_t *hit) {
  const uint64_t match_bit = 1ULL << (m - 1);
  for (int64_t i = 0; i < n; i++) {
    const uint64_t bc = mask[ids[i]];
    nr[0] = ((r[0] << 1) | 1ULL) & bc;
    for (int32_t d = 1; d <= k; d++) {
      nr[d] = ((r[d] << 1) & bc) | ((r[d - 1] | nr[d - 1]) << 1) | r[d - 1] |
              1ULL;
    }
    hit[i] = (nr[k] & match_bit) != 0;
    /* swap r and nr */
    for (int32_t d = 0; d <= k; d++) {
      uint64_t tmp = r[d];
      r[d] = nr[d];
      nr[d] = tmp;
    }
  }
}

/* Damerau-aware shift-AND scan: k extra pending-transposition rows make an
 * adjacent swap cost ONE error instead of two — the host form of the packed
 * device kernel's recurrence (ops/packed_bitap._kernel_factory: the bcn/sbc
 * shifted char masks open and complete pending transpositions). Lets the
 * host prefilter scan swap-permitting budgets with k = edits instead of
 * k = 2*edits (the reference doubles k because plain bitap has no swap move,
 * src/prefilter.rs:174-183).
 *
 * s, ns: caller-zeroed pending-row scratch of k+1 u64 each (row 0 unused). */
void bitap_scan_damerau(const uint64_t *mask, int32_t m, int32_t k,
                        const uint8_t *ids, int64_t n, uint64_t *r,
                        uint64_t *nr, uint64_t *s, uint64_t *ns,
                        uint8_t *hit) {
  const uint64_t match_bit = 1ULL << (m - 1);
  for (int64_t i = 0; i < n; i++) {
    const uint64_t bc = mask[ids[i]];
    const uint64_t bcn = bc >> 1; /* bit j == "p[j+1] == c" */
    const uint64_t sbc = bc << 1; /* bit j+1 == "p[j] == c" */
    nr[0] = ((r[0] << 1) | 1ULL) & bc;
    for (int32_t d = 1; d <= k; d++) {
      nr[d] = ((r[d] << 1) & bc) | ((r[d - 1] | nr[d - 1]) << 1) | r[d - 1] |
              1ULL;
      /* Complete a pending transposition: s[d] holds "read p[j+1] last
       * step from a d-1 prefix through j-1"; reading p[j] now lands on
       * bit j+1 at row d (swap = one error). */
      nr[d] |= (s[d] << 1) & sbc;
      /* Open new pending transpositions from row d-1 (fresh starts
       * included: a swap of the first two pattern chars begins from the
       * empty prefix — the |1 mirrors the starts OR). */
      ns[d] = ((r[d - 1] << 1) | 1ULL) & bcn;
    }
    hit[i] = (nr[k] & match_bit) != 0;
    for (int32_t d = 0; d <= k; d++) {
      uint64_t tmp = r[d];
      r[d] = nr[d];
      nr[d] = tmp;
    }
    for (int32_t d = 1; d <= k; d++) {
      uint64_t tmp = s[d];
      s[d] = ns[d];
      ns[d] = tmp;
    }
  }
}

/* Fused transcode + root-step: byte stream -> depth-1 node id (+1; 0 = dead)
 * via a single 256-entry table, so the device can skip its one-hot matmul
 * when the host has cycles to spare. */
void root_step_u8(const uint8_t *in, int64_t n, const int32_t *table,
                  int32_t *out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = table[in[i]];
  }
}

/* ---------------------------------------------------------------------------
 * Native BFS search hot loop (the reference's monomorphized
 * search_unsorted_impl, src/search.rs:418-1119, for the FAST-path
 * configurations: global total-edit budget 0..=6, no mappings, no
 * per-pattern limits, no beams, ASCII haystack).
 *
 * Bit-exact mirror of the Python oracle (oracle.py — itself the conformance
 * model of the reference): same queue-append order, same f32 op order
 * (compile with -ffp-contract=off so no FMA contraction changes results),
 * same visited-dedup semantics, same per-node prune ceilings and push
 * guards, and the 2-gram window skip for 1-edit searches
 * (src/search.rs:504-552). Emission rows (start, span-len, pattern, penalty
 * bits, packed counts) go to the caller; the shared host decode
 * (ops/emit.decode_matches) applies the threshold and the
 * best-per-(start, end, pattern) reduction.
 *
 * Returns the emission count, or -1 when a fixed-capacity structure
 * overflowed (the caller falls back to the Python oracle — capacity is a
 * speed envelope, never a correctness boundary).
 */

#define BFS_QCAP 32768      /* states per start window */
#define BFS_HCAP 65536      /* visited slots (power of two) */

typedef struct {
  int32_t node, j, ms, me;
  float pen;
  uint8_t edits, ins, dels, subs, swaps;
} BfsState;

static inline uint64_t bfs_mix(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

/* visited: open addressing keyed by the packed state id, epoch-tagged so no
 * per-window clearing. Matches oracle dedup: skip when prev <= pen. */
typedef struct {
  uint64_t key[BFS_HCAP];
  float pen[BFS_HCAP];
  uint32_t epoch[BFS_HCAP];
} BfsVisited;

/* Thread-local scratch: concurrent searches scale per-thread like the
 * reference's freely shared &FuzzyAhoCorasick (the ctypes call releases the
 * GIL, so two host threads overlap their C work). */
static __thread BfsVisited bfs_vis;
static __thread uint32_t bfs_epoch = 0;

/* emission best-per-(start, end, pattern) map (reference
 * src/search.rs:694-737): strictly-greater similarity replaces, first
 * emission wins ties. Epoch-tagged like the visited table; winners live in
 * the caller's out_rows. */
#define BFS_EMAP_CAP (1 << 17)   /* slots (power of two) */
#define BFS_EMAX (BFS_EMAP_CAP / 2) /* max winners: half load factor */
typedef struct {
  uint64_t key[BFS_EMAP_CAP];
  int32_t idx[BFS_EMAP_CAP];
  uint32_t epoch[BFS_EMAP_CAP];
} BfsEmap;

static __thread BfsEmap bfs_emap;
static __thread uint32_t bfs_emap_epoch = 0;

static int bfs_row_cmp(const void *a, const void *b) {
  const int32_t *ra = (const int32_t *)a, *rb = (const int32_t *)b;
  if (ra[2] != rb[2]) return ra[2] < rb[2] ? -1 : 1;             /* pattern */
  if (ra[0] != rb[0]) return ra[0] < rb[0] ? -1 : 1;             /* start */
  int32_t ea = ra[0] + ra[1], eb = rb[0] + rb[1];
  if (ea != eb) return ea < eb ? -1 : 1;                          /* end */
  return 0;
}

static int64_t bfs_core(
    /* automaton (dense class space) */
    const int32_t *goto_tab,     /* [n_nodes, C] exact transition, -1 = none */
    const int32_t *edge_target,  /* [n_nodes, max_deg], -1 padded */
    const int32_t *edge_class,   /* [n_nodes, max_deg] */
    int32_t max_deg,
    const int32_t *out_count,    /* [n_nodes] */
    const int32_t *out_list,     /* [n_nodes, max_out], -1 padded */
    int32_t max_out,
    const int8_t *sb_edge,       /* [n_nodes, C] single-byte-edge flag */
    const float *sim,            /* [C, C] class-pair similarity */
    int32_t C,
    const float *node_ceil,      /* [n_nodes] prune ceiling at this thr */
    const float *pat_len,        /* [P] grapheme length, f32 */
    const float *pat_weight,     /* [P] */
    /* config */
    int32_t mef,                 /* 0 = exact, 1..6 = FAST edit budget */
    float thr,                   /* similarity threshold (f32) */
    float max_pen, float p_sub, float p_ins, float p_del, float p_swap,
    float min_sym_sim,
    /* 2-gram window skip (mef == 1 only); masks over CLASS ids */
    int32_t use_window_skip,
    const uint64_t *skip_first,  /* [ (C+63)/64 ] bitmask */
    const uint64_t *skip_second,
    /* haystack: raw ASCII bytes + 256-entry byte->class table (the
     * transcode runs inline — one less Python round trip per call) */
    const uint8_t *hay, const uint8_t *cls_table, int64_t text_len,
    /* output rows: [cap][5] = start, me_len, pattern, pen_bits, counts */
    int32_t *out_rows, int64_t out_cap) {
  int64_t n_out = 0;
  BfsState queue[BFS_QCAP];

  static __thread uint8_t ids_static[1 << 16];
  uint8_t *ids = ids_static;
  uint8_t *ids_heap = 0;
  if (text_len > (int64_t)sizeof(ids_static)) {
    ids_heap = (uint8_t *)malloc((size_t)text_len);
    if (!ids_heap) return -1;
    ids = ids_heap;
  }
  for (int64_t i = 0; i < text_len; i++) ids[i] = cls_table[hay[i]];
#define BFS_RET(v) do { free(ids_heap); return (v); } while (0)

  if (++bfs_emap_epoch == 0) { /* u32 wrap */
    memset(bfs_emap.epoch, 0, sizeof(bfs_emap.epoch));
    bfs_emap_epoch = 1;
  }

  for (int64_t start0 = 0; start0 < text_len; start0++) {
    if (use_window_skip) {
      uint32_t c0 = ids[start0];
      if (!((skip_first[c0 >> 6] >> (c0 & 63)) & 1ULL)) {
        if (start0 + 1 >= text_len) continue;
        uint32_t c1 = ids[start0 + 1];
        if (!((skip_second[c1 >> 6] >> (c1 & 63)) & 1ULL)) continue;
      }
    }

    if (++bfs_epoch == 0) { /* u32 wrap: hard-clear once per 4G windows */
      memset(bfs_vis.epoch, 0, sizeof(bfs_vis.epoch));
      bfs_epoch = 1;
    }

    int64_t q_len = 1, q_idx = 0;
    queue[0] = (BfsState){0, (int32_t)start0, (int32_t)start0,
                          (int32_t)start0, 0.0f, 0, 0, 0, 0, 0};

    while (q_idx < q_len) {
      BfsState s = queue[q_idx++];

      /* dedup key: relative offsets all < 256 for bounded-depth tries */
      uint64_t dk = ((uint64_t)s.node << 40) |
                    ((uint64_t)(s.j - start0) << 32) |
                    ((uint64_t)(s.ms - start0) << 24) |
                    ((uint64_t)(s.me - start0) << 16) |
                    ((uint64_t)s.ins << 12) | ((uint64_t)s.dels << 8) |
                    ((uint64_t)s.subs << 4) | (uint64_t)s.swaps;
      uint64_t h = bfs_mix(dk) & (BFS_HCAP - 1);
      int skip = 0;
      for (;;) {
        if (bfs_vis.epoch[h] != bfs_epoch) {
          bfs_vis.epoch[h] = bfs_epoch;
          bfs_vis.key[h] = dk;
          bfs_vis.pen[h] = s.pen;
          break;
        }
        if (bfs_vis.key[h] == dk) {
          if (bfs_vis.pen[h] <= s.pen) { skip = 1; }
          else { bfs_vis.pen[h] = s.pen; }
          break;
        }
        h = (h + 1) & (BFS_HCAP - 1);
      }
      if (skip) continue;

      if (s.pen > node_ceil[s.node]) continue;

      const int32_t *edges_t = edge_target + (int64_t)s.node * max_deg;
      const int32_t *edges_c = edge_class + (int64_t)s.node * max_deg;
      float remaining = max_pen - s.pen;
      int32_t n_output = out_count[s.node];

      if (n_output) {
        if (s.edits <= mef) {
          const int32_t *ol = out_list + (int64_t)s.node * max_out;
          for (int32_t o = 0; o < n_output; o++) {
            int32_t p = ol[o];
            /* similarity in the oracle's f32 op order (src/search.rs:705) */
            float pl = pat_len[p];
            float sv = ((pl - s.pen) / pl) * pat_weight[p];
            if (sv < thr) continue;
            uint64_t ek = ((uint64_t)(uint32_t)s.ms << 32) |
                          ((uint64_t)(uint32_t)(s.me - s.ms) << 24) |
                          (uint64_t)(uint32_t)p;
            uint64_t eh = bfs_mix(ek) & (BFS_EMAP_CAP - 1);
            for (;;) {
              if (bfs_emap.epoch[eh] != bfs_emap_epoch) {
                if (n_out >= out_cap) BFS_RET(-2); /* retryable */
                if (n_out >= BFS_EMAX) BFS_RET(-1);
                bfs_emap.epoch[eh] = bfs_emap_epoch;
                bfs_emap.key[eh] = ek;
                bfs_emap.idx[eh] = (int32_t)n_out;
                int32_t *row = out_rows + n_out * 5;
                row[0] = s.ms;
                row[1] = s.me - s.ms;
                row[2] = p;
                memcpy(&row[3], &sv, 4);
                row[4] = (int32_t)s.ins | ((int32_t)s.dels << 8) |
                         ((int32_t)s.subs << 16) | ((int32_t)s.swaps << 24);
                n_out++;
                break;
              }
              if (bfs_emap.key[eh] == ek) {
                int32_t *row = out_rows + bfs_emap.idx[eh] * 5;
                float cur;
                memcpy(&cur, &row[3], 4);
                if (sv > cur) { /* strict: first emission wins ties */
                  memcpy(&row[3], &sv, 4);
                  row[4] = (int32_t)s.ins | ((int32_t)s.dels << 8) |
                           ((int32_t)s.subs << 16) | ((int32_t)s.swaps << 24);
                }
                break;
              }
              eh = (eh + 1) & (BFS_EMAP_CAP - 1);
            }
          }
        }
      }
      if (mef == 0) { /* exact config: no edit branches can emit */
        if (s.j < text_len) {
          int32_t nx = goto_tab[(int64_t)s.node * C + ids[s.j]];
          if (nx >= 0) {
            if (q_len >= BFS_QCAP) BFS_RET(-1);
            int32_t msn = (s.me == s.ms) ? s.j : s.ms;
            queue[q_len++] = (BfsState){nx, s.j + 1, msn, s.j + 1, s.pen,
                                        0, 0, 0, 0, 0};
          }
        }
        continue;
      }

      int is_last_edit = s.edits + 1 >= mef;
      int32_t cur_cls = (s.j < text_len) ? ids[s.j] : -1;

      if (s.j < text_len) {
        int32_t next_cls =
            (is_last_edit && s.edits < mef && s.j + 1 < text_len)
                ? ids[s.j + 1]
                : -1;
        int32_t ms_next = (s.me == s.ms) ? s.j : s.ms;

        /* exact transition (src/search.rs:776-798) */
        int32_t exact_next = goto_tab[(int64_t)s.node * C + cur_cls];
        if (exact_next >= 0) {
          if (q_len >= BFS_QCAP) BFS_RET(-1);
          queue[q_len++] = (BfsState){exact_next, s.j + 1, ms_next, s.j + 1,
                                      s.pen, s.edits, s.ins, s.dels, s.subs,
                                      s.swaps};
        }

        /* substitutions (src/search.rs:803-874) */
        if (s.edits < mef) {
          const float *simrow_base = sim; /* indexed [edge_cls * C + cur] */
          for (int32_t d = 0; d < max_deg; d++) {
            int32_t tgt = edges_t[d];
            if (tgt < 0) break;
            if (tgt == exact_next) continue;
            int32_t ec = edges_c[d];
            float sv = (ec == cur_cls) ? 1.0f
                                       : simrow_base[(int64_t)ec * C + cur_cls];
            if (sv < min_sym_sim) continue;
            float penalty = p_sub * (1.0f - sv);
            if (penalty > remaining) continue;
            if (is_last_edit) {
              if (!out_count[tgt] &&
                  (next_cls < 0 || !sb_edge[(int64_t)tgt * C + next_cls]))
                continue;
            }
            if (q_len >= BFS_QCAP) BFS_RET(-1);
            queue[q_len++] = (BfsState){tgt, s.j + 1, ms_next, s.j + 1,
                                        s.pen + penalty, (uint8_t)(s.edits + 1),
                                        s.ins, s.dels, (uint8_t)(s.subs + 1),
                                        s.swaps};
          }
        }

        /* swap / transposition (src/search.rs:935-989) */
        if (s.j + 1 < text_len && p_swap <= remaining && s.edits < mef) {
          int32_t nc = (next_cls >= 0) ? next_cls : ids[s.j + 1];
          int32_t mid = goto_tab[(int64_t)s.node * C + nc];
          if (mid >= 0) {
            int32_t node2 = goto_tab[(int64_t)mid * C + cur_cls];
            if (node2 >= 0) {
              if (q_len >= BFS_QCAP) BFS_RET(-1);
              queue[q_len++] = (BfsState){node2, s.j + 2, s.ms, s.j + 2,
                                          s.pen + p_swap,
                                          (uint8_t)(s.edits + 1), s.ins,
                                          s.dels, s.subs,
                                          (uint8_t)(s.swaps + 1)};
            }
          }
        }

        /* insertion (src/search.rs:994-1029) */
        if ((s.ms != s.me || s.ms != s.j) && p_ins <= remaining &&
            s.edits < mef) {
          int dead = 0;
          if (is_last_edit && !n_output) {
            dead = (next_cls < 0 ||
                    !sb_edge[(int64_t)s.node * C + next_cls]);
          }
          if (!dead) {
            if (q_len >= BFS_QCAP) BFS_RET(-1);
            queue[q_len++] = (BfsState){s.node, s.j + 1, s.ms, s.me,
                                        s.pen + p_ins, (uint8_t)(s.edits + 1),
                                        (uint8_t)(s.ins + 1), s.dels, s.subs,
                                        s.swaps};
          }
        }
      }

      /* deletion — even at j == len (src/search.rs:1035-1089) */
      if (p_del <= remaining && s.edits < mef) {
        int have_cur = (is_last_edit && s.j < text_len);
        for (int32_t d = 0; d < max_deg; d++) {
          int32_t tgt = edges_t[d];
          if (tgt < 0) break;
          if (is_last_edit) {
            if (!out_count[tgt] &&
                (!have_cur || !sb_edge[(int64_t)tgt * C + cur_cls]))
              continue;
          }
          if (q_len >= BFS_QCAP) BFS_RET(-1);
          queue[q_len++] = (BfsState){tgt, s.j, s.ms, s.me, s.pen + p_del,
                                      (uint8_t)(s.edits + 1), s.ins,
                                      (uint8_t)(s.dels + 1), s.subs, s.swaps};
        }
      }
    }
  }
  /* canonical (pattern, start, end) output order — the device lanes' decode
   * order; winners are unique per key so the sort is total. */
  qsort(out_rows, (size_t)n_out, 5 * sizeof(int32_t), bfs_row_cmp);
  BFS_RET(n_out);
}
#undef BFS_RET

/* Persistent per-(engine, threshold) configuration handle: the per-call
 * ctypes marshal of ~30 arguments costs more than the BFS itself on
 * microsecond-class searches, so the constants bind once and the hot call
 * passes 5 arguments (reference analog: the monomorphized engine object,
 * src/search.rs:204-393). */
typedef struct {
  const int32_t *goto_tab, *edge_target, *edge_class;
  int32_t max_deg;
  const int32_t *out_count, *out_list;
  int32_t max_out;
  const int8_t *sb_edge;
  const float *sim;
  int32_t C;
  const float *node_ceil, *pat_len, *pat_weight;
  int32_t mef;
  float thr, max_pen, p_sub, p_ins, p_del, p_swap, min_sym;
  int32_t use_ws;
  const uint64_t *skip_first, *skip_second;
  const uint8_t *cls_table;
} BfsEngineCfg;

void *bfs_engine_new(
    const int32_t *goto_tab, const int32_t *edge_target,
    const int32_t *edge_class, int32_t max_deg, const int32_t *out_count,
    const int32_t *out_list, int32_t max_out, const int8_t *sb_edge,
    const float *sim, int32_t C, const float *node_ceil, const float *pat_len,
    const float *pat_weight, int32_t mef, float thr, float max_pen,
    float p_sub, float p_ins, float p_del, float p_swap, float min_sym_sim,
    int32_t use_window_skip, const uint64_t *skip_first,
    const uint64_t *skip_second, const uint8_t *cls_table) {
  BfsEngineCfg *e = (BfsEngineCfg *)malloc(sizeof(BfsEngineCfg));
  if (!e) return 0;
  e->goto_tab = goto_tab;
  e->edge_target = edge_target;
  e->edge_class = edge_class;
  e->max_deg = max_deg;
  e->out_count = out_count;
  e->out_list = out_list;
  e->max_out = max_out;
  e->sb_edge = sb_edge;
  e->sim = sim;
  e->C = C;
  e->node_ceil = node_ceil;
  e->pat_len = pat_len;
  e->pat_weight = pat_weight;
  e->mef = mef;
  e->thr = thr;
  e->max_pen = max_pen;
  e->p_sub = p_sub;
  e->p_ins = p_ins;
  e->p_del = p_del;
  e->p_swap = p_swap;
  e->min_sym = min_sym_sim;
  e->use_ws = use_window_skip;
  e->skip_first = skip_first;
  e->skip_second = skip_second;
  e->cls_table = cls_table;
  return e;
}

void bfs_engine_free(void *p) { free(p); }

int64_t bfs_search_h(const void *hp, const uint8_t *hay, int64_t text_len,
                     int32_t *out_rows, int64_t out_cap) {
  const BfsEngineCfg *e = (const BfsEngineCfg *)hp;
  return bfs_core(e->goto_tab, e->edge_target, e->edge_class, e->max_deg,
                  e->out_count, e->out_list, e->max_out, e->sb_edge, e->sim,
                  e->C, e->node_ceil, e->pat_len, e->pat_weight, e->mef,
                  e->thr, e->max_pen, e->p_sub, e->p_ins, e->p_del, e->p_swap,
                  e->min_sym, e->use_ws, e->skip_first, e->skip_second, hay,
                  e->cls_table, text_len, out_rows, out_cap);
}

/* Legacy full-argument form (kept for differential tooling). */
int64_t bfs_search(
    const int32_t *goto_tab, const int32_t *edge_target,
    const int32_t *edge_class, int32_t max_deg, const int32_t *out_count,
    const int32_t *out_list, int32_t max_out, const int8_t *sb_edge,
    const float *sim, int32_t C, const float *node_ceil, const float *pat_len,
    const float *pat_weight, int32_t mef, float thr, float max_pen,
    float p_sub, float p_ins, float p_del, float p_swap, float min_sym_sim,
    int32_t use_window_skip, const uint64_t *skip_first,
    const uint64_t *skip_second, const uint8_t *hay, const uint8_t *cls_table,
    int64_t text_len, int32_t *out_rows, int64_t out_cap) {
  return bfs_core(goto_tab, edge_target, edge_class, max_deg, out_count,
                  out_list, max_out, sb_edge, sim, C, node_ceil, pat_len,
                  pat_weight, mef, thr, max_pen, p_sub, p_ins, p_del, p_swap,
                  min_sym_sim, use_window_skip, skip_first, skip_second, hay,
                  cls_table, text_len, out_rows, out_cap);
}

/* ---------------------------------------------------------------------------
 * Streaming-replace host helpers (reference src/stream.rs:533-638 worker
 * pool + src/matches.rs:86-112 interval scheduling). The streaming layer's
 * two remaining Python loops at match density — greedy non-overlap over the
 * rank order and the per-window byte emit — dominate a 2-core host's budget;
 * both are memcpy-class work.
 */

/* Greedy non-overlap (interval scheduling) over rows ALREADY in rank order.
 * Coordinates are superwindow-global; windows are disjoint byte ranges, so
 * per-window greedy == global greedy restricted to each window. occ is a
 * caller-zeroed byte-occupancy map of the full coordinate range (calloc'd
 * pages — only match spans are ever touched); keep[i] = 1 iff row i
 * survives. Touching intervals (e1 == s2) do not clash (half-open spans,
 * reference src/matches.rs:97-103). */
void greedy_nonoverlap(const int64_t *s, const int64_t *e, int64_t n,
                       uint8_t *occ, uint8_t *keep) {
  for (int64_t i = 0; i < n; i++) {
    const int64_t a = s[i], b = e[i];
    uint8_t clash = 0;
    for (int64_t j = a; j < b; j++) {
      if (occ[j]) {
        clash = 1;
        break;
      }
    }
    keep[i] = !clash;
    if (!clash) {
      for (int64_t j = a; j < b; j++) occ[j] = 1;
    }
  }
}

/* Whole-BATCH table-replacement emit: one C pass over every window of a
 * superwindow batch (the per-window form below costs a Python call's
 * wrapper work per window — buffer alloc, marshal, slice, write — which,
 * times the windows of a batch, dominated the replace pipeline's emit stage).
 * Window w's bytes live at data + doff[w] (the superwindow join inserts
 * separators, so windows are NOT contiguous); match rows are (s, e) in
 * window-local coords, ascending per window, wid non-decreasing. state[0]
 * carries the absolute emitted cursor across windows AND batches (a match
 * may overhang its window's commit; the next window resumes after it).
 * Returns bytes written to out. */
int64_t replace_emit_batch(
    const uint8_t *data, const int64_t *doff, const int64_t *base,
    const int64_t *commit, int32_t nwin, const int64_t *s, const int64_t *e,
    const int32_t *pat, const int32_t *wid, int64_t n, const uint8_t *tbl,
    const int64_t *tbl_off, int32_t ntbl, const uint8_t *keep_orig,
    int64_t *state, uint8_t *out) {
  int64_t o = 0;
  int64_t r = 0;
  for (int32_t w = 0; w < nwin; w++) {
    const uint8_t *d = data + doff[w];
    int64_t cur = state[0] - base[w]; /* may be < 0 after a short window */
    if (cur < 0) cur = 0;
    const int64_t cm = commit[w];
    for (; r < n && wid[r] == w; r++) {
      const int64_t a = s[r], b = e[r];
      if (a < cur) continue; /* earlier match extended past commit */
      if (cur < a) {
        memcpy(out + o, d + cur, a - cur);
        o += a - cur;
      }
      const int32_t p = pat[r];
      if (p < ntbl && !keep_orig[p]) {
        const int64_t rl = tbl_off[p + 1] - tbl_off[p];
        memcpy(out + o, tbl + tbl_off[p], rl);
        o += rl;
      } else {
        memcpy(out + o, d + a, b - a);
        o += b - a;
      }
      cur = b;
    }
    if (cur < cm) {
      memcpy(out + o, d + cur, cm - cur);
      o += cm - cur;
      cur = cm;
    }
    state[0] = base[w] + cur;
  }
  return o;
}

/* Table-replacement emit for one window: copy [cur, commit) of data into out,
 * swapping each match span [s_i, e_i) for its pattern's replacement bytes
 * (tbl + tbl_off, keep_orig[p] = 1 -> keep the original span). Matches must
 * be position-sorted and non-overlapping; ones starting before cur belong to
 * an earlier window and are skipped (reference src/stream.rs:641-705).
 * state[0] = cur in, final cur out; returns bytes written to out. */
int64_t replace_emit_table(const uint8_t *data, int64_t commit,
                           const int64_t *s, const int64_t *e,
                           const int32_t *pat, int64_t n, const uint8_t *tbl,
                           const int64_t *tbl_off, int32_t ntbl,
                           const uint8_t *keep_orig, int64_t *state,
                           uint8_t *out) {
  int64_t cur = state[0];
  int64_t o = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t a = s[i], b = e[i];
    if (a < cur) continue; /* earlier window's match extended past commit */
    if (cur < a) {
      memcpy(out + o, data + cur, a - cur);
      o += a - cur;
    }
    const int32_t p = pat[i];
    if (p < ntbl && !keep_orig[p]) {
      const int64_t rl = tbl_off[p + 1] - tbl_off[p];
      memcpy(out + o, tbl + tbl_off[p], rl);
      o += rl;
    } else {
      memcpy(out + o, data + a, b - a);
      o += b - a;
    }
    cur = b;
  }
  if (cur < commit) {
    memcpy(out + o, data + cur, commit - cur);
    o += commit - cur;
    cur = commit;
  }
  state[0] = cur;
  return o;
}
