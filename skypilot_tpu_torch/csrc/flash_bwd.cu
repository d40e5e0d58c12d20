// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the TPU kernel `_flash_bwd_kernel` / `_flash_attention_bwd_tpu`
// in skypilot_tpu/ops/attention.py (pl.pallas_call at :302). Same function,
// the flash-attention-2 backward from the forward's saved logsumexp:
//   P  = exp(S * scale - lse)          (S = Q K^T, masked scores -1e30)
//   dV = P^T dO
//   dS = P * (dO V^T - delta),  delta = rowsum(dO * O)
//   dK = dS^T Q * scale,        dQ = dS K * scale
// P and dS are rounded to bf16 before their products, as the TPU kernel
// casts them to the input dtype; every product accumulates in f32.
//
// What bounds it on an H100: at the training shape (llama-1b, 16/8 heads,
// d 128, seq 8192, causal) it does 10*hq*d FLOPs per visible (q, k) pair
// (five products) against ~2 bytes per element of q/k/v/o/dO/dq/dk/dv,
// far above the ~295 FLOP/byte ridge: tensor-core throughput bounds it.
// So every product is a wgmma (m64nNk16, bf16 operands, f32 accumulators)
// fed by TMA, and neither S, P nor dS ever leaves the SM.
//
// Design, and how it differs from the TPU kernel on purpose:
//  * Three launches on one stream, no atomics, deterministic (the train
//    resume compares losses bit for bit):
//      delta   one warp per (b, s, h) row: rowsum(dO * O) in f32;
//      dkdv    one CTA per (128 keys, batch * kv head): a producer
//              warpgroup (one warp: TMA for K and V once, then Q, dO and
//              the rows' lse and delta for every 64-row query step of
//              every query head of the GQA group, through a 2-stage ring)
//              and two consumer warpgroups of 64 keys each. S^T = K Q^T and
//              dP^T = V dO^T run with both operands in shared memory
//              (K-major); P^T and dS^T, repacked from their accumulators
//              into bf16 A fragments, feed dV += P^T dO and dK += dS^T Q
//              with dO and Q as MN-major B operands. dK and dV stay in f32
//              registers over the whole group, so the GQA sum is taken in
//              f32 inside the kernel (the TPU path repeats K/V per query
//              head and sums bf16 per-head grads);
//      dq      one CTA per (128 query rows, batch * query head), two
//              consumer warpgroups of 64 rows: Q and dO loaded once, K and
//              V in 64-key tiles through the ring; S = Q K^T and
//              dP = dO V^T from shared memory, dQ += dS K with dS from
//              registers and K as the MN-major B operand.
//    The TPU kernel computes dQ as one partial per (k-block, q-block) and
//    sums them after; the dq pass costs two more products per pair but no
//    partial buffer and no order-dependent sum.
//  * GQA without a repeat, strided [b, s, h, d] tensors through TMA maps,
//    any sq <= sk with queries at the end of the keys (q_start = sk - sq),
//    ragged edges masked (TMA reads rows past the end as zeros, and their
//    P is set to 0), causal tiles past the diagonal skipped, the CTAs with
//    the most causal work first, head_dim 64 and 128.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (skypilot_tpu_torch/ops/_build.py)

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kKeys = 128;   // keys per dkdv CTA (64 per consumer)
constexpr int kQStep = 64;   // query rows per dkdv step
constexpr int kRows = 128;   // query rows per dq CTA (64 per consumer)
constexpr int kKStep = 64;   // keys per dq step
constexpr int kStages = 2;   // ring depth of both passes
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kDeltaWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  // TMA maps of q, k, v, dO; their box rows differ between the dkdv and
  // the dq pass, so each pass gets its own Params.
  CUtensorMap tq, tk, tv, tdo;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;   // [b, hq, sq]
  float* delta;       // [b, hq, sq], written by the delta pass
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, sq, sk, hq, hkv, tiles;
  // Element strides of [b, s, h, d] tensors (d stride is 1).
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in f32: one warp per (b, s, h) row.
template <int D>
__global__ void __launch_bounds__(kDeltaWarps * 32)
flash_bwd_delta_kernel(const __grid_constant__ Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaWarps +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.b) * p.sq * p.hq) return;
  const int h = static_cast<int>(row % p.hq);
  const int s = static_cast<int>((row / p.hq) % p.sq);
  const int bi = static_cast<int>(row / (static_cast<long long>(p.hq) * p.sq));
  const __nv_bfloat16* o = p.o + bi * p.o_sb + s * p.o_ss + h * p.o_sh;
  const __nv_bfloat16* g = p.dout + bi * p.do_sb + s * p.do_ss + h * p.do_sh;
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 2; c < D; c += 64) {
    const float2 of = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 gf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(g + c));
    acc += of.x * gf.x + of.y * gf.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    p.delta[(static_cast<long long>(bi) * p.hq + h) * p.sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// dK and dV for 128 keys of one (batch, kv head), summed over the group.
template <int D>
struct DkdvSmem {
  static constexpr int kKV = kKeys * D * 2;   // the K tile, the V tile
  static constexpr int kStep = kQStep * D * 2;  // a Q step, a dO step
  static constexpr int kStats = kQStep * 4;     // lse or delta of a step
  static constexpr int kBars = 8 * (1 + 2 * kStages);
  static constexpr int kBytes =
      2 * kKV + kStages * (2 * kStep + 2 * kStats) + kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ Params p) {
  using L = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + L::kKV;
  unsigned char* sQ = sV + L::kKV;                 // [kStages] steps
  unsigned char* sdO = sQ + kStages * L::kStep;    // [kStages] steps
  float* sLse = reinterpret_cast<float*>(sdO + kStages * L::kStep);
  float* sDelta = sLse + kStages * kQStep;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDelta + kStages * kQStep);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // Key tiles in order: the first keys, seen by the most causal queries,
  // start first.
  const int bh_count = p.b * p.hkv;
  const int k0 = static_cast<int>(blockIdx.x) / bh_count * kKeys;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int bi = bh / p.hkv;
  const int hk = bh % p.hkv;
  const int grp = p.hq / p.hkv;
  const int q_start = p.sk - p.sq;
  // Query steps that can see this tile's first key: all, or (causal)
  // those at or past it. Every key is seen by the last query, so there
  // is at least one step.
  int q_begin = 0;
  if (p.causal) q_begin = max(0, k0 - q_start) / kQStep * kQStep;
  const int q_steps = (p.sq - q_begin + kQStep - 1) / kQStep;
  const int steps = grp * q_steps;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: warp 0 fills the ring.
    reg_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&p.tq);
        tma_prefetch_map(&p.tdo);
        mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
        tma_load_tile<D>(sK, &p.tk, kv_full, kKeys, hk, k0, bi);
        tma_load_tile<D>(sV, &p.tv, kv_full, kKeys, hk, k0, bi);
      }
      for (int i = 0; i < steps; ++i) {
        const int h = hk * grp + i / q_steps;
        const int q0 = q_begin + (i % q_steps) * kQStep;
        const int stage = i % kStages;
        mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);
        // lse (pre-scaled to log2 units) and delta of the step's rows;
        // rows past sq read as 0 (their P is masked to 0).
        const long long stat = (static_cast<long long>(bi) * p.hq + h) * p.sq;
        for (int r = lane; r < kQStep; r += 32) {
          const int qi = q0 + r;
          sLse[stage * kQStep + r] = qi < p.sq ? p.lse[stat + qi] * kLog2e
                                               : 0.f;
          sDelta[stage * kQStep + r] = qi < p.sq ? p.delta[stat + qi] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * L::kStep);
          tma_load_tile<D>(sQ + stage * L::kStep, &p.tq, &full[stage],
                           kQStep, h, q0, bi);
          tma_load_tile<D>(sdO + stage * L::kStep, &p.tdo, &full[stage],
                           kQStep, h, q0, bi);
        } else {
          mbar_arrive(&full[stage]);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each.
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;
    const int tig = tid % 4;
    const int key_a = k0 + cw * 64 + warp * 16 + g;  // this thread's keys
    const int key_b = key_a + 8;
    const float sl2 = p.scale * kLog2e;

    float dk[D / 2];
    float dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[kQStep / 2];   // S^T, then P^T: 64 keys x 64 queries
    float dpt[kQStep / 2];  // dP^T, then dS^T
    uint32_t pa[kQStep / 16][4];
    uint32_t dsa[kQStep / 16][4];

    mbar_wait(kv_full, 0);
    for (int i = 0; i < steps; ++i) {
      const int q0 = q_begin + (i % q_steps) * kQStep;
      const int stage = i % kStages;
      const unsigned char* q_tile = sQ + stage * L::kStep;
      const unsigned char* do_tile = sdO + stage * L::kStep;
      const float* lse = sLse + stage * kQStep;
      const float* delta = sDelta + stage * kQStep;
      mbar_wait(&full[stage], (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(st, desc_k_major(sK, kKeys, cw * 64, kk),
                 desc_k_major(q_tile, kQStep, 0, kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(dpt, desc_k_major(sV, kKeys, cw * 64, kk),
                 desc_k_major(do_tile, kQStep, 0, kk), kk > 0);
      }
      wgmma_commit();
      // Masks only where the block crosses the diagonal or an edge.
      const bool need_mask = q0 + kQStep > p.sq || k0 + kKeys > p.sk ||
                             (p.causal && k0 + kKeys - 1 > q_start + q0);
      wgmma_wait<1>();
      fence_regs(st);
      // P^T = exp(S^T * scale - lse), rounded to bf16.
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + tig * 2 + (e & 1);
          float pr = exp2_approx(fmaf(st[4 * j + e], sl2, -lse[col]));
          if (need_mask) {
            const int qi = q0 + col;
            const int key = (e < 2) ? key_a : key_b;
            if (qi >= p.sq || key >= p.sk ||
                (p.causal && key > q_start + qi)) {
              pr = 0.f;
            }
          }
          st[4 * j + e] = round_bf16(pr);
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T * (dP^T - delta).
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + tig * 2 + (e & 1);
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - delta[col]);
        }
      }
      acc_to_a<kQStep>(pa, st);
      acc_to_a<kQStep>(dsa, dpt);
      // dV += P^T dO and dK += dS^T Q over this step's 64 queries.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) {
        wgmma_rs(dv, pa[kk], desc_mn_major(do_tile, kQStep, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) {
        wgmma_rs(dk, dsa[kk], desc_mn_major(q_tile, kQStep, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(dsa);
      if (tid == 0) mbar_arrive(&empty[stage]);
    }

    __nv_bfloat16* dk_base = p.dk + bi * p.dk_sb + hk * p.dk_sh;
    __nv_bfloat16* dv_base = p.dv + bi * p.dv_sb + hk * p.dv_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (key_a < p.sk) {
        *reinterpret_cast<uint32_t*>(dk_base + key_a * p.dk_ss + col) =
            pack_bf16(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv_base + key_a * p.dv_ss + col) =
            pack_bf16(dv[4 * j], dv[4 * j + 1]);
      }
      if (key_b < p.sk) {
        *reinterpret_cast<uint32_t*>(dk_base + key_b * p.dk_ss + col) =
            pack_bf16(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
        *reinterpret_cast<uint32_t*>(dv_base + key_b * p.dv_ss + col) =
            pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ for 128 query rows of one (batch, query head).
template <int D>
struct DqSmem {
  static constexpr int kQ = kRows * D * 2;    // the Q tile, the dO tile
  static constexpr int kKV = kKStep * D * 2;  // a K step, a V step
  static constexpr int kBars = 8 * (1 + 2 * kStages);
  static constexpr int kBytes = 2 * kQ + 2 * kStages * kKV + kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sdO = sQ + L::kQ;
  unsigned char* sK = sdO + L::kQ;              // [kStages] steps
  unsigned char* sV = sK + kStages * L::kKV;    // [kStages] steps
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sV + kStages * L::kKV);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  // Heaviest causal query tiles first, as in the forward kernel.
  const int bh_count = p.b * p.hq;
  const int m_block = p.tiles - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int bi = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = m_block * kRows;
  const int q_start = p.sk - p.sq;
  int n_end = p.sk;
  if (p.causal) n_end = min(p.sk, q_start + min(q0 + kRows, p.sq));
  const int n_steps = (n_end + kKStep - 1) / kKStep;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy.
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&p.tk);
      tma_prefetch_map(&p.tv);
      mbar_arrive_expect_tx(qdo_full, 2 * L::kQ);
      tma_load_tile<D>(sQ, &p.tq, qdo_full, kRows, h, q0, bi);
      tma_load_tile<D>(sdO, &p.tdo, qdo_full, kRows, h, q0, bi);
      for (int i = 0; i < n_steps; ++i) {
        const int stage = i % kStages;
        mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * L::kKV);
        tma_load_tile<D>(sK + stage * L::kKV, &p.tk, &full[stage], kKStep,
                         hk, i * kKStep, bi);
        tma_load_tile<D>(sV + stage * L::kKV, &p.tv, &full[stage], kKStep,
                         hk, i * kKStep, bi);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each.
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;
    const int tig = tid % 4;
    const int row_a = q0 + cw * 64 + warp * 16 + g;  // this thread's rows
    const int row_b = row_a + 8;
    const float sl2 = p.scale * kLog2e;
    // lse in log2 units and delta of the two rows; rows past sq read
    // zeros through TMA, give dS = 0 and are never stored.
    const long long stat = static_cast<long long>(bh) * p.sq;
    const float lse_a = row_a < p.sq ? p.lse[stat + row_a] * kLog2e : 0.f;
    const float lse_b = row_b < p.sq ? p.lse[stat + row_b] * kLog2e : 0.f;
    const float dl_a = row_a < p.sq ? p.delta[stat + row_a] : 0.f;
    const float dl_b = row_b < p.sq ? p.delta[stat + row_b] : 0.f;
    // Steps below n_plain need no mask.
    int n_plain = p.sk / kKStep;
    if (p.causal) n_plain = min(n_plain, (q_start + q0 + 1) / kKStep);

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float s[kKStep / 2];   // S, then P: 64 rows x 64 keys
    float dp[kKStep / 2];  // dP, then dS
    uint32_t dsa[kKStep / 16][4];

    mbar_wait(qdo_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % kStages;
      const unsigned char* k_tile = sK + stage * L::kKV;
      const unsigned char* v_tile = sV + stage * L::kKV;
      mbar_wait(&full[stage], (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(s, desc_k_major(sQ, kRows, cw * 64, kk),
                 desc_k_major(k_tile, kKStep, 0, kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(dp, desc_k_major(sdO, kRows, cw * 64, kk),
                 desc_k_major(v_tile, kKStep, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P = exp(S * scale - lse), rounded to bf16.
#pragma unroll
      for (int j = 0; j < kKStep / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2_approx(
              fmaf(s[4 * j + e], sl2, -((e < 2) ? lse_a : lse_b)));
          if (i >= n_plain) {
            const int key = i * kKStep + j * 8 + tig * 2 + (e & 1);
            const int row = (e < 2) ? row_a : row_b;
            if (key >= p.sk || (p.causal && key > q_start + row)) pr = 0.f;
          }
          s[4 * j + e] = round_bf16(pr);
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kKStep / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = s[4 * j + e] *
                          (dp[4 * j + e] - ((e < 2) ? dl_a : dl_b));
        }
      }
      acc_to_a<kKStep>(dsa, dp);
      // dQ += dS K over this step's 64 keys.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKStep / 16; ++kk) {
        wgmma_rs(dq, dsa[kk], desc_mn_major(k_tile, kKStep, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsa);
      if (tid == 0) mbar_arrive(&empty[stage]);
    }

    __nv_bfloat16* dq_base = p.dq + bi * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (row_a < p.sq) {
        *reinterpret_cast<uint32_t*>(dq_base + row_a * p.dq_ss + col) =
            pack_bf16(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
      }
      if (row_b < p.sq) {
        *reinterpret_cast<uint32_t*>(dq_base + row_b * p.dq_ss + col) =
            pack_bf16(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
      }
    }
  }
}

// Host: the three launches. `strides` holds the (batch, seq, head)
// element strides of q, k, v, o, dO, dq, dk, dv in that order.
template <int D>
int launch(Params& p, const void* q, const void* k, const void* v,
           const long long* st, int device, cudaStream_t stream) {
  const long long* qs = st;
  const long long* ks = st + 3;
  const long long* vs = st + 6;
  const long long* dos = st + 12;
  Params pq = p;  // the dq pass: boxes of kRows query rows, kKStep keys
  int err = make_tma_map(&p.tq, q, p.b, p.sq, p.hq, D, qs[0], qs[1], qs[2],
                         kQStep);
  if (err == 0) {
    err = make_tma_map(&p.tdo, p.dout, p.b, p.sq, p.hq, D, dos[0], dos[1],
                       dos[2], kQStep);
  }
  if (err == 0) {
    err = make_tma_map(&p.tk, k, p.b, p.sk, p.hkv, D, ks[0], ks[1], ks[2],
                       kKeys);
  }
  if (err == 0) {
    err = make_tma_map(&p.tv, v, p.b, p.sk, p.hkv, D, vs[0], vs[1], vs[2],
                       kKeys);
  }
  if (err == 0) {
    err = make_tma_map(&pq.tq, q, p.b, p.sq, p.hq, D, qs[0], qs[1], qs[2],
                       kRows);
  }
  if (err == 0) {
    err = make_tma_map(&pq.tdo, p.dout, p.b, p.sq, p.hq, D, dos[0], dos[1],
                       dos[2], kRows);
  }
  if (err == 0) {
    err = make_tma_map(&pq.tk, k, p.b, p.sk, p.hkv, D, ks[0], ks[1], ks[2],
                       kKStep);
  }
  if (err == 0) {
    err = make_tma_map(&pq.tv, v, p.b, p.sk, p.hkv, D, vs[0], vs[1], vs[2],
                       kKStep);
  }
  if (err != 0) return err;
  // The shared-memory opt-in, once per device.
  static bool ready[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DkdvSmem<D>::kBytes);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqSmem<D>::kBytes);
    }
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }

  const long long rows = static_cast<long long>(p.b) * p.sq * p.hq;
  flash_bwd_delta_kernel<D>
      <<<static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
         kDeltaWarps * 32, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const long long kv_grid =
      static_cast<long long>((p.sk + kKeys - 1) / kKeys) * p.b * p.hkv;
  flash_bwd_dkdv_kernel<D><<<static_cast<unsigned>(kv_grid), kThreads,
                             DkdvSmem<D>::kBytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  pq.tiles = (p.sq + kRows - 1) / kRows;
  const long long q_grid = static_cast<long long>(pq.tiles) * p.b * p.hq;
  flash_bwd_dq_kernel<D><<<static_cast<unsigned>(q_grid), kThreads,
                           DqSmem<D>::kBytes, stream>>>(pq);
  return cudaGetLastError();
}

}  // namespace

extern "C" int skytpu_flash_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int hq, int hkv, int d,
    const long long* strides, float scale, int causal, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.b = b; p.sq = sq; p.sk = sk; p.hq = hq; p.hkv = hkv;
  p.tiles = 0;
  // strides: (batch, seq, head) element strides of q, k, v, o, dO, dq, dk,
  // dv in that order; the TMA maps take those of q, k, v and dO.
  long long* dst[5][3] = {
      {&p.o_sb, &p.o_ss, &p.o_sh},    {&p.do_sb, &p.do_ss, &p.do_sh},
      {&p.dq_sb, &p.dq_ss, &p.dq_sh}, {&p.dk_sb, &p.dk_ss, &p.dk_sh},
      {&p.dv_sb, &p.dv_ss, &p.dv_sh}};
  for (int t = 0; t < 5; ++t) {
    for (int i = 0; i < 3; ++i) *dst[t][i] = strides[(t + 3) * 3 + i];
  }
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, q, k, v, strides, device, s);
  if (d == 128) return launch<128>(p, q, k, v, strides, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Error text for a code returned above (the wrapper raises with it).
extern "C" const char* skytpu_cuda_error_string(int code) {
  if (code >= kTmaErrorBase) {
    return "cuTensorMapEncodeTiled refused a TMA map of an operand "
           "(CUresult = code - 100000)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
