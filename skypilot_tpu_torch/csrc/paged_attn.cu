// Paged decode attention for Hopper (sm_90a): K3, bf16 in, f32 accumulate.
//
// Replaces no Pallas kernel: the JAX engine (skypilot_tpu/models/decode.py)
// computes its decode and verify attention in plain jnp over gathered
// pool rows. K3 was added because that attention, ported as a gather of
// every slot's whole block table, copies, casts to f32 and f32 einsums,
// was 81-95% of every serving step's device time (PERF.md §5).
//
// What it computes, for one layer: q [b, t, hq, d] (the decode step's
// t = 1 or the verify step's t = 1 + K query rows per slot) against the
// paged bf16 pool [num_blocks, hkv, bs, d] through block_tables [b,
// max_blocks]; query row i of slot s sees key positions 0 .. lengths[s] +
// t_off + i (capped at max_blocks * bs), which is the engine's mask.
// Scores are bf16 x bf16 products summed in f32 and scaled in f32, the
// softmax is f32, P is rounded to bf16 before P V and O is summed in f32,
// then written as bf16 [b, t, hq, d]: the arithmetic of the plain version
// (ops/attention.py paged_attention_reference, the engine's gather and
// f32 einsums) up to the order of the sums.
//
// What bounds it on an H100: the K and V rows. Each visible key costs
// 2 * 2 * d bytes per KV head and 4 * d FLOPs per query row it meets, and
// a (slot, KV head) pair has at most hq / hkv * t = 20 query rows: about
// 20 FLOP per byte against the card's ~295. So the design moves only the
// bytes the mathematics needs, once:
//  * the pool is read in place through the table (no gather, no copy), and
//    only up to each slot's visible length: a CTA covers a split of
//    kSplitKeys keys of one (slot, KV head) pair, the grid is sized from
//    max_blocks (launches stay shape-static; the host never reads a
//    length) and a CTA whose split starts past its slot's last visible key
//    exits at once; rows past the last visible key are zero-filled in
//    shared memory and never read;
//  * one CTA serves every query row of its pair (the GQA group times t, at
//    most 32), so each K/V byte is read once per step;
//  * each of the 4 warps owns 16 keys of every 64-key tile: it streams its
//    own K and V rows (16-byte cp.async into an XOR-swizzled 3-stage ring,
//    so up to two of its tiles are in flight while it computes one), runs
//    S^T = K Q^T and O^T += V^T P^T on tensor cores (mma.sync m16n8k16,
//    bf16 -> f32) and keeps its own online softmax, so the main loop has
//    no CTA barrier. Keys are the M dimension of both products and query
//    rows the N dimension, so the rows pad to a multiple of 8 (the verify
//    step's 20 to 24; as M they would pad to 32) and P^T goes from the S^T
//    accumulators to B fragments in registers (movmatrix);
//  * at the end of a split the 4 warps merge by log-sum-exp in shared
//    memory; a pair whose keys fit in one split writes its output there,
//    others write (O, m, l) per split and a second small pass
//    (paged_attn_combine_kernel, one CTA per pair and query row, so no
//    thread walks rows or splits in series) merges the splits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (skypilot_tpu_torch/ops/_build.py)

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = 16;                     // keys per warp per tile
constexpr int kTileKeys = kWarps * kWarpKeys;     // 64
constexpr int kSplitKeys = 512;                   // keys per CTA (8 tiles)
constexpr int kStages = 3;                        // ring depth, per warp
constexpr int kMaxRows = 32;                      // query rows per CTA
constexpr int kHeadDim = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;  // one layer's pool, [num_blocks, hkv, bs, d]
  const __nv_bfloat16* v;
  const long long* tables;   // [b, max_blocks], row stride table_sb
  const long long* lengths;  // [b]
  __nv_bfloat16* o;
  float* o_part;   // [b * hkv, n_splits, rows, d]
  float* ml_part;  // [b * hkv, n_splits, rows, 2]: (m, l)
  int b, t, t_off, hq, hkv, grp, rows, bs, max_blocks, n_splits;
  long long q_sb, q_st, q_sh, o_sb, o_st, o_sh, table_sb;
  float scale;
};

// The keys of slot `bi` some query row sees, [0, n_keys): up to the last
// row's position, at most the table's max_blocks * bs.
__device__ __forceinline__ int visible_keys(const Params& p, int bi) {
  const long long n = p.lengths[bi] + p.t_off + p.t;
  return static_cast<int>(
      min(n, static_cast<long long>(p.max_blocks) * p.bs));
}

// ---------------------------------------------------------------------------
// PTX: cp.async, ldmatrix, movmatrix, mma.sync.

// 16 bytes global -> shared; with `ok` false the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool ok) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// The 8 x 8 bf16 matrix whose row-major fragment is `a`, transposed.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of D bf16 columns:
// chunk c ^ (r % 8), so the 8 rows one ldmatrix reads hit 8 bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// One warp's K and V rows of one tile: keys key0 .. key0 + 15.
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* sk,
                                          unsigned char* sv, const Params& p,
                                          const long long* table, int hk,
                                          int key0, int n_keys, int lane) {
  constexpr int kChunks = D / 8;
  const int c = lane % kChunks;
#pragma unroll
  for (int i = 0; i < kWarpKeys * kChunks / 32; ++i) {
    const int r = lane / kChunks + i * (32 / kChunks);
    const int key = key0 + r;
    const bool ok = key < n_keys;
    long long off = 0;
    if (ok) {
      const long long blk = table[key / p.bs];
      off = ((blk * p.hkv + hk) * p.bs + key % p.bs) * D + c * 8;
    }
    cp_async_16(sk + swz<D>(r, c), p.k + off, ok);
    cp_async_16(sv + swz<D>(r, c), p.v + off, ok);
  }
}

// ---------------------------------------------------------------------------
// The split kernel. Keys are the M dimension of both products and query
// rows the N dimension, in NT tiles of 8 rows (the GQA group times t,
// padded to 8 NT): S^T = K Q^T and O^T += V^T P^T.

template <int D, int NT>
struct Smem {
  static constexpr int kRowsQ = 8 * NT;
  static constexpr int kQ = kRowsQ * D * 2;
  static constexpr int kRows = kWarpKeys * D * 2;       // one warp's K rows
  static constexpr int kWarpRing = kStages * 2 * kRows;  // K and V
  static constexpr int kRing = kWarps * kWarpRing;
  // The merge of the warps reuses the ring: f32 [warp][row][D + 4].
  static constexpr int kMerge = kWarps * kRowsQ * (D + 4) * 4;
  static_assert(kMerge <= kRing, "merge scratch must fit in the ring");
  static constexpr int kBytes = kQ + kRing;
};

template <int D, int NT>
__global__ void __launch_bounds__(kThreads, 2)
paged_attn_kernel(const __grid_constant__ Params p) {
  using S = Smem<D, NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_m[kWarps][S::kRowsQ];
  __shared__ float s_l[kWarps][S::kRowsQ];
  unsigned char* sQ = smem;
  unsigned char* ring = smem + S::kQ;

  // Split-major order: every pair's first split comes first, the splits
  // that exit at once last.
  const int pairs = p.b * p.hkv;
  const int split = static_cast<int>(blockIdx.x) / pairs;
  const int pair = static_cast<int>(blockIdx.x) % pairs;
  const int bi = pair / p.hkv;
  const int hk = pair % p.hkv;
  const int n_keys = visible_keys(p, bi);
  const int key_start = split * kSplitKeys;
  if (key_start >= n_keys) return;
  const int n_tiles =
      (min(kSplitKeys, n_keys - key_start) + kTileKeys - 1) / kTileKeys;
  const long long* table = p.tables + bi * p.table_sb;
  const long long len = p.lengths[bi];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  unsigned char* wring = ring + warp * S::kWarpRing;

  // Q: row r = t * grp + j is query row t of head hk * grp + j; rows past
  // `rows` are zeros.
  {
    constexpr int kChunks = D / 8;
    for (int i = tid; i < S::kRowsQ * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool ok = r < p.rows;
      const __nv_bfloat16* src = p.q;
      if (ok) {
        src += bi * p.q_sb + (r / p.grp) * p.q_st +
               (hk * p.grp + r % p.grp) * p.q_sh + c * 8;
      }
      cp_async_16(sQ + swz<D>(r, c), src, ok);
    }
    cp_async_commit();
  }
  const int key_w = key_start + warp * kWarpKeys;  // + it * kTileKeys
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      unsigned char* sk = wring + s * 2 * S::kRows;
      load_rows<D>(sk, sk + S::kRows, p, table, hk, key_w + s * kTileKeys,
                   n_keys, lane);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q has landed (this thread's part) ...
  __syncthreads();               // ... and every thread's

  // This thread's query rows are nt * 8 + 2 tig + j (j = 0, 1); the last
  // key each may see (a padded row sees what the last real row sees).
  int lim[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = min(nt * 8 + 2 * tig + j, p.rows - 1);
      lim[nt][j] = static_cast<int>(
          min(len + p.t_off + r / p.grp, static_cast<long long>(n_keys - 1)));
    }
  }

  // O^T: m tiles of 16 columns of d, n tiles of 8 query rows.
  float o[D / 16][NT][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  float m_i[NT][2], l_i[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m_i[nt][0] = m_i[nt][1] = kNegInf;
    l_i[nt][0] = l_i[nt][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    {
      const int nx = it + kStages - 1;
      if (nx < n_tiles) {
        unsigned char* sk = wring + (nx % kStages) * 2 * S::kRows;
        load_rows<D>(sk, sk + S::kRows, p, table, hk, key_w + nx * kTileKeys,
                     n_keys, lane);
      }
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* sk = wring + (it % kStages) * 2 * S::kRows;
    const unsigned char* sv = sk + S::kRows;

    // S^T = K Q^T: this warp's 16 keys by the query rows. Thread holds
    // keys g and g + 8 of rows nt * 8 + 2 tig + {0, 1}.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ka[4];
      ldmatrix_x4(ka, sk + swz<D>(lane & 15, 2 * ks + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t qb[2];
        ldmatrix_x2(qb, sQ + swz<D>(nt * 8 + (lane & 7),
                                    2 * ks + ((lane >> 3) & 1)));
        mma_bf16(s[nt], ka, qb[0], qb[1]);
      }
    }

    // Scale, mask, online softmax over the keys (across the 8 lanes of a
    // tig); P^T to bf16 and transposed into P's B fragments. O^T is
    // rescaled only when some row's maximum moved.
    const int key0 = key_w + it * kTileKeys;
    uint32_t pb[NT][2];
    float corr[NT][2];
    bool moved = false;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float mx[2] = {m_i[nt][0], m_i[nt][1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + g + 8 * (e >> 1);
        const float x = s[nt][e] * p.scale;
        s[nt][e] = key > lim[nt][e & 1] ? kNegInf : x;
        mx[e & 1] = fmaxf(mx[e & 1], s[nt][e]);
      }
      float base[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 4));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 8));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 16));
        corr[nt][j] = exp2_approx((m_i[nt][j] - mx[j]) * kLog2e);
        moved |= mx[j] != m_i[nt][j];
        m_i[nt][j] = mx[j];
        l_i[nt][j] *= corr[nt][j];
        // No visible key yet in this row: its masked scores give P = 0.
        base[j] = mx[j] == kNegInf ? 0.f : mx[j];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2_approx((s[nt][e] - base[e & 1]) * kLog2e);
        s[nt][e] = pv;
        l_i[nt][e & 1] += pv;
      }
      pb[nt][0] = movmatrix_trans(pack_bf16(s[nt][0], s[nt][1]));
      pb[nt][1] = movmatrix_trans(pack_bf16(s[nt][2], s[nt][3]));
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][nt][e] *= corr[nt][e & 1];
    }

    // O^T += V^T P^T: V's rows (keys) are the k dimension.
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      uint32_t va[4];
      ldmatrix_x4_trans(va, sv + swz<D>((lane & 7) + ((lane >> 4) << 3),
                                        2 * mt + ((lane >> 3) & 1)));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(o[mt][nt], va, pb[nt][0], pb[nt][1]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
  }

  // Merge the 4 warps by log-sum-exp in shared memory (the ring is free).
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l_i[nt][j] += __shfl_xor_sync(0xffffffffu, l_i[nt][j], 4);
      l_i[nt][j] += __shfl_xor_sync(0xffffffffu, l_i[nt][j], 8);
      l_i[nt][j] += __shfl_xor_sync(0xffffffffu, l_i[nt][j], 16);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s_m[warp][nt * 8 + 2 * tig + j] = m_i[nt][j];
        s_l[warp][nt * 8 + 2 * tig + j] = l_i[nt][j];
      }
    }
  }
  __syncthreads();
  constexpr int kPitch = D + 4;
  float* merge = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = nt * 8 + 2 * tig + j;
      float mm = s_m[0][r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][r]);
      const float f = exp2_approx((m_i[nt][j] - mm) * kLog2e);
      float* dst = merge + (warp * S::kRowsQ + r) * kPitch + g;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        dst[16 * mt] = o[mt][nt][j] * f;
        dst[16 * mt + 8] = o[mt][nt][2 + j] * f;
      }
    }
  }
  __syncthreads();
  // Row statistics of the merged split: m = the warps' max, l = their
  // rescaled sum.
  if (tid < p.rows) {
    float mm = s_m[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ll += s_l[w][tid] * exp2_approx((s_m[w][tid] - mm) * kLog2e);
    }
    s_m[0][tid] = mm;
    s_l[0][tid] = ll;
  }
  __syncthreads();
  const bool alone = n_keys <= kSplitKeys;
  const long long part = static_cast<long long>(pair) * p.n_splits + split;
  for (int i = tid; i < p.rows * D; i += kThreads) {
    const int r = i / D;
    const int col = i % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      acc += merge[(w * S::kRowsQ + r) * kPitch + col];
    }
    if (alone) {
      const int t = r / p.grp;
      const int head = hk * p.grp + r % p.grp;
      p.o[bi * p.o_sb + t * p.o_st + head * p.o_sh + col] =
          __float2bfloat16_rn(acc / s_l[0][r]);
    } else {
      p.o_part[(part * p.rows + r) * D + col] = acc;
    }
  }
  if (!alone && tid < p.rows) {
    p.ml_part[(part * p.rows + tid) * 2] = s_m[0][tid];
    p.ml_part[(part * p.rows + tid) * 2 + 1] = s_l[0][tid];
  }
}

// ---------------------------------------------------------------------------
// The combine pass: one CTA of D threads per (slot, KV head, query row)
// whose keys span more than one split; thread = output column. The first
// warp weighs the splits' (m, l), then every column sums its splits.

template <int D>
__global__ void __launch_bounds__(D)
paged_attn_combine_kernel(const __grid_constant__ Params p) {
  extern __shared__ float s_w[];  // [n_splits]: each split's weight
  __shared__ float s_l;
  const int pair = static_cast<int>(blockIdx.x) / p.rows;
  const int r = static_cast<int>(blockIdx.x) % p.rows;
  const int bi = pair / p.hkv;
  const int hk = pair % p.hkv;
  const int n_act = (visible_keys(p, bi) + kSplitKeys - 1) / kSplitKeys;
  if (n_act <= 1) return;
  // (split s, row r) of this pair is at row0 + s * rows.
  const long long row0 = static_cast<long long>(pair) * p.n_splits * p.rows + r;
  const int tid = threadIdx.x;
  if (tid < 32) {
    float mm = kNegInf;
    for (int s = tid; s < n_act; s += 32) {
      mm = fmaxf(mm, p.ml_part[(row0 + s * p.rows) * 2]);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    }
    float ll = 0.f;
    for (int s = tid; s < n_act; s += 32) {
      const long long at = row0 + s * p.rows;
      const float w = exp2_approx((p.ml_part[at * 2] - mm) * kLog2e);
      s_w[s] = w;
      ll += w * p.ml_part[at * 2 + 1];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      ll += __shfl_xor_sync(0xffffffffu, ll, off);
    }
    if (tid == 0) s_l = ll;
  }
  __syncthreads();
  float acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_act; ++s) {
    acc += s_w[s] * p.o_part[(row0 + s * p.rows) * D + tid];
  }
  const int t = r / p.grp;
  const int head = hk * p.grp + r % p.grp;
  p.o[bi * p.o_sb + t * p.o_st + head * p.o_sh + tid] =
      __float2bfloat16_rn(acc / s_l);
}

template <int D, int NT>
int launch(const Params& p, int device, cudaStream_t stream) {
  // The shared-memory opt-in, once per device.
  static bool ready[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<D, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D, NT>::kBytes);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  const long long grid =
      static_cast<long long>(p.n_splits) * p.b * p.hkv;
  paged_attn_kernel<D, NT><<<static_cast<unsigned>(grid), kThreads,
                             Smem<D, NT>::kBytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;
  paged_attn_combine_kernel<D><<<static_cast<unsigned>(p.b * p.hkv * p.rows),
                                 D, p.n_splits * sizeof(float), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Keys per split of the grid; the wrapper sizes o_part and ml_part from it.
extern "C" int skytpu_paged_attn_split_keys() { return kSplitKeys; }

extern "C" int skytpu_paged_attn_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* o, void* o_part,
    void* ml_part, int b, int t, int t_off, int hq, int hkv, int d, int bs,
    int max_blocks, long long q_sb, long long q_st, long long q_sh,
    long long o_sb, long long o_st, long long o_sh, long long table_sb,
    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || t < 1 || hkv < 1 || hq % hkv || bs < 1 || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pool);
  p.v = static_cast<const __nv_bfloat16*>(v_pool);
  p.tables = static_cast<const long long*>(tables);
  p.lengths = static_cast<const long long*>(lengths);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_part = static_cast<float*>(o_part);
  p.ml_part = static_cast<float*>(ml_part);
  p.b = b; p.t = t; p.t_off = t_off; p.hq = hq; p.hkv = hkv;
  p.grp = hq / hkv;
  p.rows = p.grp * t;
  p.bs = bs;
  p.max_blocks = max_blocks;
  p.n_splits = (max_blocks * bs + kSplitKeys - 1) / kSplitKeys;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.table_sb = table_sb;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  // Every engine the port serves on the card has head_dim 128: one width
  // keeps the cold build (part of a replica's set-up) short.
  const int nt = (p.rows + 7) / 8;
  if (d == kHeadDim && p.rows <= kMaxRows) {
    if (nt == 1) rc = launch<kHeadDim, 1>(p, device, s);
    if (nt == 2) rc = launch<kHeadDim, 2>(p, device, s);
    if (nt == 3) rc = launch<kHeadDim, 3>(p, device, s);
    if (nt == 4) rc = launch<kHeadDim, 4>(p, device, s);
  }
  return rc;
}

// Error text for a code returned above (the wrapper raises with it).
extern "C" const char* skytpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
