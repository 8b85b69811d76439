// Banded Damerau DP with edit-type-vector channels, alone and as the
// expansion + DP + emission step of one corpus slice, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device functions
// fuzzy_aho_corasick_tpu/ops/verify_dp.py::_banded_dp_typed and
// _emit_rows_typed (and, in front of them, _expand_candidates as
// dp_pipeline.cu runs it), the typed branch of _dp_pipeline_jit, which XLA
// compiled per engine from an unrolled graph of Lmax x B x NCH vector ops.
// Plain torch versions: ops/verify_dp.py::banded_dp_typed_torch,
// emit_rows_typed, dp_pipeline_torch; wrappers verify_dp.banded_dp_typed and
// verify_dp.dp_pipeline.
//
// What it computes. Per candidate (field f, start s) the recurrences of
// banded_dp.cuh without counts and without a dead-end filter, over NCH
// channels that are edit-type vectors (insertions, deletions,
// substitutions, swaps): an edit of one type arrives in channel ch from the
// channel with one edit of that type less (the graph table), and only where
// the source's edit total and that type's count are below the caps of a
// node on the path: substitution, deletion and the emission channel's
// trailing deletion read the caps of row i-1 (row 0: the root's), insertion
// and swap those of row i. Caps compare as integers. f32 order, guards,
// strict-< merges (exact, substitution, swap, deletion, then insertions
// ascending b over the updated band b-1), ceilings and the latch at
// i == depth are banded_dp.cu's. Emission: per band and output slot, the
// strict-< minimum in channel order over the channels the pattern's limits
// class admits, the winning channel's static counts, and the f32 test
// ((pl - pen) / pl) * pw >= bound of dp_pipeline.cu.
//
// What bounds it on the H100, and the design. A candidate's state is five
// rows (i-2, i-1, i, and the emission channel of i-1 and i) of B x NCH f32
// cells: 70 cells for edits(2).substitutions(1), up to 13 x 96. That does
// not fit one thread's registers, so one WARP runs one candidate: the rows
// live in shared memory, lanes take the cells of a row (all independent but
// the insertion pass, which goes band by band with a __syncwarp between),
// and the channel graph sits in shared memory once per block. NCH, E, the
// graph and the admissibility table are run-time tables: one instance of
// each kernel serves every engine. Like the count-channel DP it is bound by
// dependent-instruction latency per candidate, not by bytes.
//
// The pipeline kernel keeps dp_pipeline.cu's items (combo-major over the
// hits h0..K-1, a hit before h0 read only as the predecessor of hit h0), its
// order (channel-major over (band, slot), then by item) and its optional
// row tags (channel * n_combo + combo), with the same two passes around
// block_offsets_kernel, but its counting unit is a warp, not a block: a warp
// expands its TY_UNIT (combo, hit) items, then runs its live candidates one
// after another in item order, so a lane that owns emission channel c counts
// that channel's rows in a register, and in the write pass that running count
// is the row's rank behind offsets[c][warp].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TY_THREADS = 128;
constexpr int TY_WARPS = TY_THREADS / 32;
// (combo, hit) items one warp of the pipeline kernel expands. Its live
// candidates run one after another, and hits of one word are neighbours in
// item order, so a warp's queue is as long as its items are many: with 32
// the fullest warps set the kernel's time. The counts are one entry per warp
// and emission channel, 16 x dp_pipeline.cu's per item: the wrapper bounds
// their bytes (verify_dp.TYPED_COUNT_BYTES) and mirrors this constant
// (verify_dp.TYPED_UNIT).
constexpr int TY_UNIT = 8;
constexpr int MAX_E = 6;
constexpr int MAX_NCH = 96;
constexpr int MAX_CHANNELS = 128;  // B * MO emission channels a call may have
constexpr int CH_PER_LANE = MAX_CHANNELS / 32;
// Columns of the graph table: source channel of the substitution, insertion,
// deletion and swap arrival (-1: none), the vector's sum, its insertions,
// deletions, substitutions and swaps, its packed counts.
constexpr int GCOLS = 10;
constexpr int G_SUB = 0, G_INS = 1, G_DEL = 2, G_SWAP = 3, G_SUM = 4, G_NI = 5, G_ND = 6,
              G_NS = 7, G_NW = 8, G_CNT = 9;

struct TypedCore {
  const void* ids;            // dense class ids, u8 or int32 [npad]
  int ids_u8;
  long long limit;            // positions >= limit are out of text
  const int32_t* path_cls;    // [F, Lmax]
  const int32_t* path_node;   // [F, Lmax]
  const int32_t* depth;       // [F]
  int Lmax;
  const float* sim;           // [C, C]
  int C;
  const float* node_ceil;     // [N]
  float max_pen, p_sub, p_ins, p_del, p_swap, floor_;
  int E;
  const int32_t* graph;       // [nch, GCOLS]
  int nch;
  const int32_t* node_caps;   // [N, 5]: edits, insertions, deletions, substitutions, swaps
  const int32_t* root_caps;   // [5]: the caps of path row 0
};

__device__ __forceinline__ int hay_at(const TypedCore& a, long long p) {
  if (p < 0 || p >= a.limit) return -1;
  return a.ids_u8 ? (int)__ldg(static_cast<const uint8_t*>(a.ids) + p)
                  : __ldg(static_cast<const int32_t*>(a.ids) + p);
}

__device__ __forceinline__ bool fin(float x) {
  return fabsf(x) < __int_as_float(0x7f800000);  // false for +-inf and NaN
}

// Shared memory of a block, in 4-byte words: the graph, then per warp five
// rows of B x nch cells and the candidate's haystack window.
__host__ __device__ inline int warp_words(int E, int nch, int Lmax) {
  return 5 * (2 * E + 1) * nch + Lmax + 2 * E + 1;
}

inline size_t smem_bytes(int E, int nch, int Lmax) {
  return sizeof(int32_t) * ((size_t)nch * GCOLS + (size_t)TY_WARPS * warp_words(E, nch, Lmax));
}

// Every thread of the block calls this before any of them leaves.
__device__ __forceinline__ void load_graph(const TypedCore& a, int32_t* g) {
  for (int t = threadIdx.x; t < a.nch * GCOLS; t += TY_THREADS) g[t] = __ldg(a.graph + t);
  __syncthreads();
}

// The DP of one candidate (field f >= 0, start s), run by the 32 lanes of a
// warp over ``mem`` (warp_words() words of shared memory). Returns the
// emission channel at row depth(f), [B][nch] in shared memory (+inf where
// dead); the caller __syncwarp()s before the memory is used again.
__device__ const float* typed_dp_warp(const TypedCore& a, const int32_t* g, int32_t* mem,
                                      int f, long long s, int lane) {
  const int E = a.E, B = 2 * E + 1, nch = a.nch, cells = B * nch;
  const float INF = __int_as_float(0x7f800000);
  float* prev2 = reinterpret_cast<float*>(mem);  // row i-2
  float* prev = prev2 + cells;                   // row i-1
  float* nw = prev + cells;                      // row i
  float* preve = nw + cells;                     // emission channel of row i-1
  float* newe = preve + cells;                   // emission channel of row i
  int32_t* win = mem + 5 * cells;                // win[o] = hay(s + o - E - 1)
  const int d = __ldg(a.depth + f);
  const int32_t* pcls = a.path_cls + (long long)f * a.Lmax;
  const int32_t* pnode = a.path_node + (long long)f * a.Lmax;
  const float max_pen = a.max_pen;

  for (int t = lane; t < d + 2 * E + 1; t += 32) win[t] = hay_at(a, s - E - 1 + t);
  for (int c = lane; c < cells; c += 32) {
    // Row 0 is the origin (band E, the zero vector); row -1 is dead.
    const float origin = c == E * nch ? 0.f : INF;
    prev2[c] = INF;
    prev[c] = origin;
    preve[c] = origin;
  }
  __syncwarp();

  for (int i = 1; i <= d; ++i) {
    const int pc = __ldg(pcls + i - 1);
    const int pc_prev = __ldg(pcls + (i >= 2 ? i - 2 : 0));
    const int pn = __ldg(pnode + i - 1);
    const float ceil_i = __ldg(a.node_ceil + pn);
    const int32_t* c1 = i == 1 ? a.root_caps : a.node_caps + 5ll * __ldg(pnode + i - 2);
    const int32_t* c0 = a.node_caps + 5ll * pn;
    const int ce_1 = __ldg(c1), cd_1 = __ldg(c1 + 2), cs_1 = __ldg(c1 + 3);
    const int ce_0 = __ldg(c0), ci_0 = __ldg(c0 + 1), cw_0 = __ldg(c0 + 4);

    // Every cell's arrivals but the insertion, and the emission channel.
    for (int c = lane; c < cells; c += 32) {
      const int b = c / nch, ch = c - b * nch;
      const int j = i + b - E;  // haystack symbols consumed at this cell
      const int hc = win[i + b], hc_jm1 = win[i - 1 + b];
      float sim = 0.f;
      if (hc >= 0) sim = __ldg(a.sim + pc * a.C + hc);
      const float spen = __fmul_rn(a.p_sub, __fsub_rn(1.f, sim));
      const int32_t* gr = g + ch * GCOLS;
      // exact: (i-1, b, ch), no edit
      const float p = prev[c];
      float bp = (j >= 1 && fin(p) && hc == pc) ? p : INF;
      int src = gr[G_SUB];
      if (src >= 0) {
        // substitution: (i-1, b, src), caps of row i-1
        const int32_t* gs = g + src * GCOLS;
        const float q = prev[b * nch + src];
        const bool ok = j >= 1 && fin(q) && hc >= 0 && hc != pc && !(sim < a.floor_) &&
                        !(spen > __fsub_rn(max_pen, q)) && gs[G_SUM] < ce_1 &&
                        gs[G_NS] < cs_1;
        const float v = __fadd_rn(q, spen);
        if (ok && v < bp) bp = v;
      }
      src = gr[G_SWAP];
      if (src >= 0) {
        // swap: (i-2, b, src), caps of row i
        const int32_t* gs = g + src * GCOLS;
        const float sw = prev2[b * nch + src];
        const bool ok = i >= 2 && j >= 2 && fin(sw) &&
                        !(a.p_swap > __fsub_rn(max_pen, sw)) && hc >= 0 && hc_jm1 >= 0 &&
                        hc == pc_prev && hc_jm1 == pc && gs[G_SUM] < ce_0 && gs[G_NW] < cw_0;
        const float v = __fadd_rn(sw, a.p_swap);
        if (ok && v < bp) bp = v;
      }
      float ep = bp;  // the consuming arrivals
      src = gr[G_DEL];
      if (src >= 0 && b + 1 < B) {
        const int32_t* gs = g + src * GCOLS;
        if (gs[G_SUM] < ce_1 && gs[G_ND] < cd_1) {
          // deletion: (i-1, b+1, src), consumes pc only, caps of row i-1
          const float dl = prev[(b + 1) * nch + src];
          const float v = __fadd_rn(dl, a.p_del);
          if (fin(dl) && !(a.p_del > __fsub_rn(max_pen, dl)) && v < bp) bp = v;
          // the emission channel's trailing deletion, from its row i-1
          const float t = preve[(b + 1) * nch + src];
          const float vt = __fadd_rn(t, a.p_del);
          if (fin(t) && !(a.p_del > __fsub_rn(max_pen, t)) && vt < ep) ep = vt;
        }
      }
      nw[c] = bp;
      newe[c] = ep > ceil_i ? INF : ep;
    }
    __syncwarp();

    // insertion: same row, (b-1, src) -> (b, ch), ascending b over the
    // updated band b-1; none from cells with zero hay consumed; caps of row i.
    for (int b = 1; b < B; ++b) {
      if (i + b - E >= 2 && win[i + b] >= 0) {
        for (int ch = lane; ch < nch; ch += 32) {
          const int src = g[ch * GCOLS + G_INS];
          if (src < 0) continue;
          const int32_t* gs = g + src * GCOLS;
          const float ip = nw[(b - 1) * nch + src];
          const bool ok = fin(ip) && !(a.p_ins > __fsub_rn(max_pen, ip)) &&
                          gs[G_SUM] < ce_0 && gs[G_NI] < ci_0;
          const float v = __fadd_rn(ip, a.p_ins);
          if (ok && v < nw[b * nch + ch]) nw[b * nch + ch] = v;
        }
      }
      __syncwarp();
    }

    // Ceiling of the continuation channel, then the rows move up.
    for (int c = lane; c < cells; c += 32)
      if (nw[c] > ceil_i) nw[c] = INF;
    __syncwarp();
    float* t = prev2;
    prev2 = prev;
    prev = nw;
    nw = t;
    t = preve;
    preve = newe;
    newe = t;
  }
  return preve;  // the emission channel of row d
}

struct TypedDpArgs {
  TypedCore core;
  const int32_t* cand_field;  // [M], -1 = dead slot
  const int32_t* cand_start;  // [M]
  long long M;
  float* pen_out;             // [B * nch, M]
};

__global__ void __launch_bounds__(TY_THREADS) banded_dp_typed_kernel(TypedDpArgs a) {
  extern __shared__ int32_t s_mem[];
  load_graph(a.core, s_mem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = (long long)blockIdx.x * TY_WARPS + warp;
  if (m >= a.M) return;
  const int cells = (2 * a.core.E + 1) * a.core.nch;
  int32_t* mem = s_mem + a.core.nch * GCOLS +
                 warp * warp_words(a.core.E, a.core.nch, a.core.Lmax);
  const int f = __ldg(a.cand_field + m);
  const float* emit = nullptr;
  if (f >= 0) emit = typed_dp_warp(a.core, s_mem, mem, f, __ldg(a.cand_start + m), lane);
  for (int c = lane; c < cells; c += 32)
    a.pen_out[(long long)c * a.M + m] = emit ? emit[c] : __int_as_float(0x7f800000);
}

struct TypedPipeArgs {
  TypedCore core;
  const long long* pos;     // [K] ascending hit positions
  const long long* words;   // [K, W2] u32 halves of the match words
  long long K;
  long long h0;             // first hit expanded; hits before it only feed the dedup
  int W2;
  const int32_t* combos;    // [5, n_combo]: word column, bit, field, start offset, b == 0
  int n_combo;
  long long start_lo, start_hi, pos_hi;
  const int32_t* node;      // [F] output node of each field
  const int32_t* out_list;  // [N, MO] patterns of each node, -1 padded
  int MO;
  const float* pat_len;     // [P]
  const float* pat_weight;  // [P]
  float bound;              // threshold less the emission slack
  const int32_t* limcls;    // [P] limits class of each pattern
  const int32_t* adm;       // [NLC, nch] whether a class admits a channel
  long long nunits;         // warps over the (combo, hit) items
  int32_t* counts;          // [NCH + 1, nunits] (count pass)
  const int32_t* offsets;   // exclusive scan of counts (write pass)
  int32_t* rows;            // [total, 5] (write pass)
  int32_t* tags;            // [total] channel * n_combo + combo, or null (write pass)
};

__global__ void __launch_bounds__(TY_THREADS)
dp_pipeline_typed_kernel(TypedPipeArgs a, bool write) {
  extern __shared__ int32_t s_mem[];
  load_graph(a.core, s_mem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long unit = (long long)blockIdx.x * TY_WARPS + warp;
  if (unit >= a.nunits) return;
  const int E = a.core.E, B = 2 * E + 1, nch = a.core.nch;
  const int nce = B * a.MO;  // emission channels
  int32_t* mem = s_mem + nch * GCOLS + warp * warp_words(E, nch, a.core.Lmax);

  // Expansion of this lane's item (dp_pipeline.cu).
  const long long gi = unit * TY_UNIT + lane;
  const long long KI = a.K - a.h0;
  bool alive = false;
  int f = 0, c = 0;
  long long s = 0;
  if (lane < TY_UNIT && gi < KI * a.n_combo) {
    c = (int)(gi / KI);
    const long long h = a.h0 + gi - (long long)c * KI;
    const int col = __ldg(a.combos + c);
    const int sh = __ldg(a.combos + a.n_combo + c);
    const long long p = __ldg(a.pos + h);
    const bool fired = ((__ldg(a.words + h * a.W2 + col) >> sh) & 1) != 0;
    bool dup = false;
    if (h > 0 && __ldg(a.pos + h - 1) + 1 == p)
      dup = ((__ldg(a.words + (h - 1) * a.W2 + col) >> sh) & 1) != 0;
    s = p + 1 - __ldg(a.combos + 3 * a.n_combo + c);
    alive = fired && p >= 0 && p < a.pos_hi && s >= a.start_lo && s < a.start_hi &&
            (__ldg(a.combos + 4 * a.n_combo + c) != 0 || !dup);
    f = __ldg(a.combos + 2 * a.n_combo + c);
  }
  unsigned live = __ballot_sync(0xFFFFFFFFu, alive);
  const int n_cand = __popc(live);

  // This lane owns emission channels lane, lane + 32, ...: the rows each
  // has emitted so far in this warp, and where the warp's rows start.
  int run[CH_PER_LANE];
  long long base[CH_PER_LANE];
#pragma unroll
  for (int it = 0; it < CH_PER_LANE; ++it) {
    run[it] = 0;
    const int ce = lane + 32 * it;
    base[it] = (write && ce < nce) ? __ldg(a.offsets + (long long)ce * a.nunits + unit) : 0;
  }

  // The warp's live candidates, in item order.
  while (live) {
    const int from = __ffs(live) - 1;
    live &= live - 1;
    const int cf = __shfl_sync(0xFFFFFFFFu, f, from);
    const long long cs = __shfl_sync(0xFFFFFFFFu, s, from);
    const int cc = __shfl_sync(0xFFFFFFFFu, c, from);
    const float* emit = typed_dp_warp(a.core, s_mem, mem, cf, cs, lane);
    const int d = __ldg(a.core.depth + cf);
    const int node = __ldg(a.node + cf);
    const int start = (int)cs;
#pragma unroll
    for (int it = 0; it < CH_PER_LANE; ++it) {
      const int ce = lane + 32 * it;
      if (ce >= nce) continue;
      const int b = ce / a.MO, o = ce - b * a.MO;
      const int pat = __ldg(a.out_list + (long long)node * a.MO + o);
      const int ends_b = start + d + (b - E);
      if (pat < 0 || ends_b > a.core.limit || ends_b < start) continue;
      // Strict <, channels ascending: the fewest edits win penalty ties.
      const int32_t* ad = a.adm + (long long)__ldg(a.limcls + pat) * nch;
      float best = __int_as_float(0x7f800000);
      int bch = 0;
      for (int ch = 0; ch < nch; ++ch) {
        const float v = emit[b * nch + ch];
        if (__ldg(ad + ch) != 0 && v < best) {
          best = v;
          bch = ch;
        }
      }
      if (!fin(best)) continue;
      const float pl = __ldg(a.pat_len + pat);
      const float sim = __fmul_rn(__fdiv_rn(__fsub_rn(pl, best), pl), __ldg(a.pat_weight + pat));
      if (!(sim >= a.bound)) continue;
      if (write) {
        int32_t* row = a.rows + (base[it] + run[it]) * 5;
        row[0] = start;
        row[1] = __float_as_int(best);
        row[2] = d + (b - E);
        row[3] = pat;
        row[4] = s_mem[bch * GCOLS + G_CNT];
        if (a.tags != nullptr) a.tags[base[it] + run[it]] = ce * a.n_combo + cc;
      }
      ++run[it];
    }
    __syncwarp();  // the rows are read before the next candidate overwrites them
  }

  if (!write) {
#pragma unroll
    for (int it = 0; it < CH_PER_LANE; ++it) {
      const int ce = lane + 32 * it;
      if (ce < nce) a.counts[(long long)ce * a.nunits + unit] = run[it];
    }
    if (lane == 0) a.counts[(long long)nce * a.nunits + unit] = n_cand;
  }
}

// Kernels whose shared memory passes 48 KiB must be allowed it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool fill_core(TypedCore& c, const void* ids, int ids_u8, long long npad, long long limit,
               const void* path_cls, const void* path_node, const void* depth, int Lmax, int F,
               const void* sim, int C, const void* node_ceil, int N, float max_pen, float p_sub,
               float p_ins, float p_del, float p_swap, float floor_, int E, const void* graph,
               int nch, const void* node_caps, const void* root_caps) {
  if (E < 1 || E > MAX_E || Lmax < 1 || F < 1 || C < 1 || N < 1 || limit < 0 || limit > npad ||
      nch < 1 || nch > MAX_NCH || graph == nullptr || node_caps == nullptr ||
      root_caps == nullptr) {
    return false;
  }
  c.ids = ids;
  c.ids_u8 = ids_u8;
  c.limit = limit;
  c.path_cls = static_cast<const int32_t*>(path_cls);
  c.path_node = static_cast<const int32_t*>(path_node);
  c.depth = static_cast<const int32_t*>(depth);
  c.Lmax = Lmax;
  c.sim = static_cast<const float*>(sim);
  c.C = C;
  c.node_ceil = static_cast<const float*>(node_ceil);
  c.max_pen = max_pen;
  c.p_sub = p_sub;
  c.p_ins = p_ins;
  c.p_del = p_del;
  c.p_swap = p_swap;
  c.floor_ = floor_;
  c.E = E;
  c.graph = static_cast<const int32_t*>(graph);
  c.nch = nch;
  c.node_caps = static_cast<const int32_t*>(node_caps);
  c.root_caps = static_cast<const int32_t*>(root_caps);
  return true;
}

}  // namespace

extern "C" {

// (combo, hit) items per counting unit of fac_dp_pipeline_typed: the callers
// size ``counts`` from it (nunits = ceil((K - h0) * n_combo / unit)).
int fac_dp_pipeline_typed_unit() { return TY_UNIT; }

// The typed DP alone. cand_field, cand_start: int32 [M]; the DP tables as
// fac_banded_dp takes them; graph: int32 [nch, 10]; node_caps: int32 [N, 5];
// root_caps: int32 [5]; pen: f32 [(2E+1) nch, M]. Returns the launch's
// cudaError_t (0 = launched).
int fac_banded_dp_typed(const void* cand_field, const void* cand_start, long long M,
                        const void* ids, int ids_u8, long long npad, long long limit,
                        const void* path_cls, const void* path_node, const void* depth,
                        int Lmax, int F, const void* sim, int C, const void* node_ceil, int N,
                        float max_pen, float p_sub, float p_ins, float p_del, float p_swap,
                        float floor_, int E, const void* graph, int nch,
                        const void* node_caps, const void* root_caps, void* pen,
                        void* stream) {
  TypedDpArgs a;
  if (M < 1 || !fill_core(a.core, ids, ids_u8, npad, limit, path_cls, path_node, depth, Lmax, F,
                          sim, C, node_ceil, N, max_pen, p_sub, p_ins, p_del, p_swap, floor_, E,
                          graph, nch, node_caps, root_caps)) {
    return (int)cudaErrorInvalidValue;
  }
  a.cand_field = static_cast<const int32_t*>(cand_field);
  a.cand_start = static_cast<const int32_t*>(cand_start);
  a.M = M;
  a.pen_out = static_cast<float*>(pen);
  const size_t shm = smem_bytes(E, nch, Lmax);
  cudaError_t rc = allow_smem(banded_dp_typed_kernel, shm);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (M + TY_WARPS - 1) / TY_WARPS;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  banded_dp_typed_kernel<<<(unsigned)blocks, TY_THREADS, shm, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Expansion, typed DP and typed emission of one slice. Arguments as
// fac_dp_pipeline takes them, without the dead-end tables; limcls: int32 [P];
// adm: int32 [nlc, nch]. write == 0: counts int32 [(2E+1) MO + 1, nunits] is
// written; write == 1: offsets (the exclusive scan of counts, int32) is read
// and rows int32 [total, 5] written, and where tags is not null the rows'
// tags int32 [total]. Returns the launch's cudaError_t.
int fac_dp_pipeline_typed(const void* pos, const void* words, long long K, long long h0, int W2,
                          const void* combos, int n_combo, long long start_lo,
                          long long start_hi, long long pos_hi,
                          const void* ids, int ids_u8, long long npad, long long limit,
                          const void* path_cls, const void* path_node, const void* depth,
                          const void* node, int Lmax, int F, const void* sim, int C,
                          const void* node_ceil, int N, const void* out_list, int MO,
                          const void* pat_len, const void* pat_weight,
                          float max_pen, float p_sub, float p_ins, float p_del,
                          float p_swap, float floor_, float bound, int E,
                          const void* graph, int nch, const void* node_caps,
                          const void* root_caps, const void* limcls, const void* adm, int nlc,
                          int write, long long nunits, void* counts, const void* offsets,
                          void* rows, void* tags, void* stream) {
  TypedPipeArgs a;
  if (K < 1 || h0 < 0 || h0 >= K || W2 < 2 || n_combo < 1 || MO < 1 || nlc < 1 ||
      limcls == nullptr ||
      adm == nullptr ||
      !fill_core(a.core, ids, ids_u8, npad, limit, path_cls, path_node, depth, Lmax, F, sim, C,
                 node_ceil, N, max_pen, p_sub, p_ins, p_del, p_swap, floor_, E, graph, nch,
                 node_caps, root_caps) ||
      (2 * E + 1) * MO > MAX_CHANNELS ||
      nunits != ((K - h0) * n_combo + TY_UNIT - 1) / TY_UNIT) {
    return (int)cudaErrorInvalidValue;
  }
  a.pos = static_cast<const long long*>(pos);
  a.words = static_cast<const long long*>(words);
  a.K = K;
  a.h0 = h0;
  a.W2 = W2;
  a.combos = static_cast<const int32_t*>(combos);
  a.n_combo = n_combo;
  a.start_lo = start_lo;
  a.start_hi = start_hi;
  a.pos_hi = pos_hi;
  a.node = static_cast<const int32_t*>(node);
  a.out_list = static_cast<const int32_t*>(out_list);
  a.MO = MO;
  a.pat_len = static_cast<const float*>(pat_len);
  a.pat_weight = static_cast<const float*>(pat_weight);
  a.bound = bound;
  a.limcls = static_cast<const int32_t*>(limcls);
  a.adm = static_cast<const int32_t*>(adm);
  a.nunits = nunits;
  a.counts = static_cast<int32_t*>(counts);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.rows = static_cast<int32_t*>(rows);
  a.tags = static_cast<int32_t*>(tags);
  const size_t shm = smem_bytes(E, nch, Lmax);
  cudaError_t rc = allow_smem(dp_pipeline_typed_kernel, shm);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (nunits + TY_WARPS - 1) / TY_WARPS;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  dp_pipeline_typed_kernel<<<(unsigned)blocks, TY_THREADS, shm,
                             static_cast<cudaStream_t>(stream)>>>(a, write != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
