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
// So every product runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators) and neither S, P nor dS ever leaves the SM.
//
// Design, and how it differs from the TPU kernel on purpose:
//  * Three launches on one stream, no atomics, deterministic:
//      delta   one warp per (b, s, h) row: rowsum(dO * O) in f32;
//      dkdv    one CTA per (64-key tile, batch * kv-head): walks every
//              query head of the GQA group and every query tile that can
//              see its keys, keeping dK and dV in f32 registers, so the
//              group sum happens in f32 inside the kernel (the TPU path
//              repeats K/V per query head and sums bf16 per-head grads);
//      dq      one CTA per (64-query tile, batch * query-head): walks the
//              key tiles its rows can see, recomputing S, P and dP.
//    The TPU kernel computes dQ as one partial per (k-block, q-block) and
//    sums them after; the dq pass costs two more products per pair but no
//    partial buffer and no order-dependent sum.
//  * Transposed operands without transposes: dkdv computes S^T = K Q^T
//    and dP^T = V dO^T directly (keys as rows), so P^T and dS^T come out
//    of the accumulators in the A-operand layout of dV += P^T dO and
//    dK += dS^T Q, as P does for P V in the forward kernel.
//  * GQA without a repeat, strided [b, s, h, d] tensors from the wrapper,
//    any sq <= sk with queries at the end of the keys (q_start = sk - sq),
//    ragged edges masked, causal tiles past the diagonal skipped,
//    head_dim 64 and 128.
//  * Plain 16-byte loads into padded shared tiles; cp.async/TMA pipelining,
//    ldmatrix and wgmma are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (skypilot_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKV = 64;   // keys per dkdv CTA (16 per warp)
constexpr int kStepQ = 32;    // query rows per dkdv inner step
constexpr int kTileQ = 64;    // query rows per dq CTA (16 per warp)
constexpr int kStepK = 32;    // keys per dq inner step
constexpr int kPad = 8;       // bf16 elements of row padding in smem
constexpr float kNegInf = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;   // [b, hq, sq]
  float* delta;       // [b, hq, sq], written by the delta pass
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, sq, sk, hq, hkv;
  // Element strides of [b, s, h, d] tensors (d stride is 1).
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from different rows packed into one 32-bit register
// (lo = first row, hi = second row).
__device__ __forceinline__ uint32_t pack_rows(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  uint16_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint16_t b = *reinterpret_cast<const uint16_t*>(hi);
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}

// D = A * B + D for one m16n8k16 tile; A row-major 16x16, B 16x8 (k x n).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows x 16 columns starting at column c0) of a padded
// shared tile whose fragment rows start at `r0`.
template <int D>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* r0,
                                       int c0) {
  const int tig = threadIdx.x % 4;
  const __nv_bfloat16* r1 = r0 + 8 * (D + kPad);
  a[0] = ld_u32(r0 + c0 + tig * 2);
  a[1] = ld_u32(r1 + c0 + tig * 2);
  a[2] = ld_u32(r0 + c0 + tig * 2 + 8);
  a[3] = ld_u32(r1 + c0 + tig * 2 + 8);
}

// Copy rows [row0, row0 + ROWS) of one head of a [b, s, h, d] tensor into
// a padded shared tile, zero-filling rows at or past `rows`.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<long long>(row0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(smem + r * (D + kPad) + c * 8) = val;
  }
}

// A operand of one 16-deep k-step built from two neighbouring 8-column
// accumulator tiles (the C layout of tiles 2kk and 2kk+1 is the A layout
// of k-step kk), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo,
                                         const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in f32: one warp per (b, s, h) row.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
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
// dK and dV for 64 keys of one (batch, kv-head), summed over the group.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTileKV * (D + kPad);
  __nv_bfloat16* sQ = sV + kTileKV * (D + kPad);
  __nv_bfloat16* sdO = sQ + kStepQ * (D + kPad);
  float* sLse = reinterpret_cast<float*>(sdO + kStepQ * (D + kPad));
  float* sDelta = sLse + kStepQ;

  const int k0 = blockIdx.x * kTileKV;
  const int bi = blockIdx.y / p.hkv;
  const int hk = blockIdx.y % p.hkv;
  const int grp = p.hq / p.hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int q_start = p.sk - p.sq;

  load_tile<D, kTileKV>(sK, p.k + bi * p.k_sb + hk * p.k_sh, p.k_ss, k0,
                        p.sk);
  load_tile<D, kTileKV>(sV, p.v + bi * p.v_sb + hk * p.v_sh, p.v_ss, k0,
                        p.sk);

  float acc_dk[D / 8][4];
  float acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }
  // This thread's two key rows (accumulator rows g and g + 8).
  const int key_a = k0 + warp * 16 + g;
  const int key_b = key_a + 8;
  const __nv_bfloat16* k_rows = sK + (warp * 16 + g) * (D + kPad);
  const __nv_bfloat16* v_rows = sV + (warp * 16 + g) * (D + kPad);

  // Query rows that can see this tile's first key: all, or (causal)
  // those at or past it.
  int qt_begin = 0;
  if (p.causal) qt_begin = max(0, k0 - q_start) / kStepQ * kStepQ;

  for (int hh = 0; hh < grp; ++hh) {
    const int h = hk * grp + hh;
    const __nv_bfloat16* q_base = p.q + bi * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* do_base = p.dout + bi * p.do_sb + h * p.do_sh;
    const float* lse_row = p.lse + (static_cast<long long>(bi) * p.hq + h) *
                                       p.sq;
    const float* delta_row = p.delta +
                             (static_cast<long long>(bi) * p.hq + h) * p.sq;
    for (int q0 = qt_begin; q0 < p.sq; q0 += kStepQ) {
      __syncthreads();  // previous step fully consumed (and sK/sV loaded)
      load_tile<D, kStepQ>(sQ, q_base, p.q_ss, q0, p.sq);
      load_tile<D, kStepQ>(sdO, do_base, p.do_ss, q0, p.sq);
      if (threadIdx.x < kStepQ) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < p.sq ? lse_row[qi] : 0.f;
        sDelta[threadIdx.x] = qi < p.sq ? delta_row[qi] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries per warp.
      float s[kStepQ / 8][4];
      float dp[kStepQ / 8][4];
#pragma unroll
      for (int j = 0; j < kStepQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<D>(ka, k_rows, kk * 16);
        load_a<D>(va, v_rows, kk * 16);
#pragma unroll
        for (int j = 0; j < kStepQ / 8; ++j) {
          const __nv_bfloat16* qrow = sQ + (j * 8 + g) * (D + kPad) +
                                      kk * 16 + tig * 2;
          const __nv_bfloat16* dorow = sdO + (j * 8 + g) * (D + kPad) +
                                       kk * 16 + tig * 2;
          mma_bf16(s[j], ka, ld_u32(qrow), ld_u32(qrow + 8));
          mma_bf16(dp[j], va, ld_u32(dorow), ld_u32(dorow + 8));
        }
      }

      // P^T = exp(S^T * scale - lse), rounded to bf16; dS^T likewise.
#pragma unroll
      for (int j = 0; j < kStepQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + tig * 2 + (e & 1);
          const int qi = q0 + col;
          const int key = (e < 2) ? key_a : key_b;
          const bool masked = qi >= p.sq || key >= p.sk ||
                              (p.causal && key > q_start + qi);
          const float pr =
              masked ? 0.f : round_bf16(__expf(s[j][e] * p.scale -
                                               sLse[col]));
          s[j][e] = pr;
          dp[j][e] = pr * (dp[j][e] - sDelta[col]);
        }
      }

      // dV += P^T dO and dK += dS^T Q over this step's 32 queries.
#pragma unroll
      for (int kk = 0; kk < kStepQ / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
        const int r0 = kk * 16 + tig * 2;
        const __nv_bfloat16* do0 = sdO + r0 * (D + kPad);
        const __nv_bfloat16* q0r = sQ + r0 * (D + kPad);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int c = j * 8 + g;
          mma_bf16(acc_dv[j], pa,
                   pack_rows(do0 + c, do0 + (D + kPad) + c),
                   pack_rows(do0 + 8 * (D + kPad) + c,
                             do0 + 9 * (D + kPad) + c));
          mma_bf16(acc_dk[j], dsa,
                   pack_rows(q0r + c, q0r + (D + kPad) + c),
                   pack_rows(q0r + 8 * (D + kPad) + c,
                             q0r + 9 * (D + kPad) + c));
        }
      }
    }
  }

  __nv_bfloat16* dk_base = p.dk + bi * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dv_base = p.dv + bi * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (key_a < p.sk) {
      *reinterpret_cast<uint32_t*>(dk_base + key_a * p.dk_ss + col) =
          pack_bf16(acc_dk[j][0] * p.scale, acc_dk[j][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_base + key_a * p.dv_ss + col) =
          pack_bf16(acc_dv[j][0], acc_dv[j][1]);
    }
    if (key_b < p.sk) {
      *reinterpret_cast<uint32_t*>(dk_base + key_b * p.dk_ss + col) =
          pack_bf16(acc_dk[j][2] * p.scale, acc_dk[j][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_base + key_b * p.dv_ss + col) =
          pack_bf16(acc_dv[j][2], acc_dv[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ for 64 query rows of one (batch, query-head).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTileQ * (D + kPad);
  __nv_bfloat16* sK = sdO + kTileQ * (D + kPad);
  __nv_bfloat16* sV = sK + kStepK * (D + kPad);

  const int q0 = blockIdx.x * kTileQ;
  const int bh = blockIdx.y;
  const int bi = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int q_start = p.sk - p.sq;

  load_tile<D, kTileQ>(sQ, p.q + bi * p.q_sb + h * p.q_sh, p.q_ss, q0,
                       p.sq);
  load_tile<D, kTileQ>(sdO, p.dout + bi * p.do_sb + h * p.do_sh, p.do_ss,
                       q0, p.sq);
  __syncthreads();

  // Q and dO fragments for this warp's 16 rows, all of d, in registers.
  uint32_t qa[D / 16][4];
  uint32_t da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<D>(qa[kk], sQ + (warp * 16 + g) * (D + kPad), kk * 16);
    load_a<D>(da[kk], sdO + (warp * 16 + g) * (D + kPad), kk * 16);
  }
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const long long stat = static_cast<long long>(bh) * p.sq;
  const float lse_a = row_a < p.sq ? p.lse[stat + row_a] : 0.f;
  const float lse_b = row_b < p.sq ? p.lse[stat + row_b] : 0.f;
  const float dl_a = row_a < p.sq ? p.delta[stat + row_a] : 0.f;
  const float dl_b = row_b < p.sq ? p.delta[stat + row_b] : 0.f;

  float acc_dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[j][e] = 0.f;
  }

  int n_end = p.sk;
  if (p.causal) {
    const int last_q = min(q0 + kTileQ, p.sq) - 1;
    n_end = min(p.sk, q_start + last_q + 1);
  }
  const __nv_bfloat16* k_base = p.k + bi * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v_base = p.v + bi * p.v_sb + hk * p.v_sh;

  for (int k0 = 0; k0 < n_end; k0 += kStepK) {
    __syncthreads();  // previous tile fully consumed
    load_tile<D, kStepK>(sK, k_base, p.k_ss, k0, p.sk);
    load_tile<D, kStepK>(sV, v_base, p.v_ss, k0, p.sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 32 keys per warp.
    float s[kStepK / 8][4];
    float dp[kStepK / 8][4];
#pragma unroll
    for (int j = 0; j < kStepK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const __nv_bfloat16* krow = sK + (j * 8 + g) * (D + kPad) + tig * 2;
      const __nv_bfloat16* vrow = sV + (j * 8 + g) * (D + kPad) + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[j], qa[kk], ld_u32(krow + kk * 16),
                 ld_u32(krow + kk * 16 + 8));
        mma_bf16(dp[j], da[kk], ld_u32(vrow + kk * 16),
                 ld_u32(vrow + kk * 16 + 8));
      }
    }

#pragma unroll
    for (int j = 0; j < kStepK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tig * 2 + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        const bool masked = row >= p.sq || key >= p.sk ||
                            (p.causal && key > q_start + row);
        const float pr = masked ? 0.f
                                : round_bf16(__expf(s[j][e] * p.scale -
                                                    ((e < 2) ? lse_a
                                                             : lse_b)));
        dp[j][e] = pr * (dp[j][e] - ((e < 2) ? dl_a : dl_b));
      }
    }

    // dQ += dS K over this tile's 32 keys.
#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk) {
      uint32_t dsa[4];
      acc_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
      const __nv_bfloat16* k0r = sK + (kk * 16 + tig * 2) * (D + kPad);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + g;
        mma_bf16(acc_dq[j], dsa, pack_rows(k0r + c, k0r + (D + kPad) + c),
                 pack_rows(k0r + 8 * (D + kPad) + c,
                           k0r + 9 * (D + kPad) + c));
      }
    }
  }

  __nv_bfloat16* dq_base = p.dq + bi * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (row_a < p.sq) {
      *reinterpret_cast<uint32_t*>(dq_base + row_a * p.dq_ss + col) =
          pack_bf16(acc_dq[j][0] * p.scale, acc_dq[j][1] * p.scale);
    }
    if (row_b < p.sq) {
      *reinterpret_cast<uint32_t*>(dq_base + row_b * p.dq_ss + col) =
          pack_bf16(acc_dq[j][2] * p.scale, acc_dq[j][3] * p.scale);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.b) * p.sq * p.hq;
  flash_bwd_delta_kernel<D>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_kv = (2 * kTileKV + 2 * kStepQ) * (D + kPad) *
                          static_cast<int>(sizeof(__nv_bfloat16)) +
                      2 * kStepQ * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  dim3 grid_kv((p.sk + kTileKV - 1) / kTileKV, p.b * p.hkv);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = (2 * kTileQ + 2 * kStepK) * (D + kPad) *
                     static_cast<int>(sizeof(__nv_bfloat16));
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  dim3 grid_q((p.sq + kTileQ - 1) / kTileQ, p.b * p.hq);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(p);
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
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.b = b; p.sq = sq; p.sk = sk; p.hq = hq; p.hkv = hkv;
  // strides: (batch, seq, head) element strides of q, k, v, o, dO, dq, dk,
  // dv in that order.
  long long* dst[8][3] = {
      {&p.q_sb, &p.q_ss, &p.q_sh},    {&p.k_sb, &p.k_ss, &p.k_sh},
      {&p.v_sb, &p.v_ss, &p.v_sh},    {&p.o_sb, &p.o_ss, &p.o_sh},
      {&p.do_sb, &p.do_ss, &p.do_sh}, {&p.dq_sb, &p.dq_ss, &p.dq_sh},
      {&p.dk_sb, &p.dk_ss, &p.dk_sh}, {&p.dv_sb, &p.dv_ss, &p.dv_sh}};
  for (int t = 0; t < 8; ++t) {
    for (int i = 0; i < 3; ++i) *dst[t][i] = strides[t * 3 + i];
  }
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return static_cast<int>(launch<64>(p, s));
  if (d == 128) return static_cast<int>(launch<128>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Error text for a code returned above (the wrapper raises with it).
extern "C" const char* skytpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
