// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the TPU kernel `_flash_fwd_kernel` / `_flash_attention_fwd_tpu`
// in skypilot_tpu/ops/attention.py (pl.pallas_call at :254). Same function:
// softmax(Q K^T * scale) V with an online softmax (running max m and sum l
// in f32), queries at the END of the key sequence (q_start = sk - sq),
// masked scores -1e30 (not -inf), l clamped to 1e-30, P rounded to bf16
// before P V (the TPU kernel casts P to the input dtype), and the per-row
// natural-log logsumexp m + log(l) emitted in f32 for the backward pass.
//
// What bounds it on an H100: causal attention at llama widths (d 128, a
// few thousand tokens) does 4*hq*d FLOPs per visible (q, k) pair against
// 2 bytes per element of q/k/v/o, far above the card's ~295 FLOP/byte
// ridge: tensor-core throughput bounds it. The design feeds the tensor
// cores at their Hopper rate:
//  * one CTA per (128 query rows, batch * query head): a producer
//    warpgroup (one thread issues TMA, setmaxnreg down to 24 registers)
//    and two consumer warpgroups of 64 query rows each (up to 240);
//  * Q is loaded once; K and V tiles of 128 keys flow through a 2-stage
//    ring of 128-byte-swizzled shared tiles filled by TMA and handed over
//    with mbarriers (full: TMA landed; empty: both consumers are done);
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major); O += P V takes P from registers (the S accumulator repacked
//    to bf16 A fragments, no trip through shared memory) and V as an
//    MN-major B operand;
//  * the next tile's S product is issued before this tile's P V product,
//    and the softmax of the next tile runs while P V is in flight;
//  * softmax in f32 registers with exp2 and a log2(e)-prescaled scale;
//    masks only on tiles that cross the diagonal or a ragged edge (keys at
//    or past sk read as zeros through TMA and are masked explicitly);
//  * the CTAs with the most causal work (the last query tiles) start
//    first, so the launch does not end on a tail of long CTAs.
//
// Differences from the TPU kernel, on purpose:
//  * GQA without a repeat: query head h reads KV head h / (hq / hkv).
//  * Strided [b, s, h, d] inputs through TMA maps: no transposes.
//  * Any sq <= sk: ragged tile edges are masked (rows past sq are never
//    stored, keys past sk score -1e30), head_dim 64 or 128.
//  * Key tiles are visited last to first, so the masked tiles come first;
//    a row whose tile is wholly masked gets P = 0 there.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (skypilot_tpu_torch/ops/_build.py)

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;  // query rows per CTA (64 per consumer)
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap tq, tk, tv;  // boxes of kBlockM (q) and kBlockN (k, v) rows
  __nv_bfloat16* o;
  float* lse;
  int b, sq, sk, hq, hkv, m_blocks;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

template <int D>
struct Smem {
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kKV = kBlockN * D * 2;
  static constexpr int kBars = 8 * (1 + 4 * kStages);
  // 1024 bytes of slack for the 1024-byte alignment of the tiles.
  static constexpr int kBytes = kQ + 2 * kStages * kKV + kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + Smem<D>::kQ;
  unsigned char* sV = sK + kStages * Smem<D>::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * Smem<D>::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // Heaviest causal query tiles first: block i takes query tile
  // m_blocks - 1 - i / (b * hq).
  const int bh_count = p.b * p.hq;
  const int m_block = p.m_blocks - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int bi = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = m_block * kBlockM;
  const int q_start = p.sk - p.sq;
  // Key tiles that can contribute: all, or (causal) up to the last row's
  // position.
  int n_end = p.sk;
  if (p.causal) n_end = min(p.sk, q_start + min(q0 + kBlockM, p.sq));
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers);
      mbar_init(&v_empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy.
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&p.tq);
      tma_prefetch_map(&p.tk);
      tma_prefetch_map(&p.tv);
      mbar_arrive_expect_tx(q_full, Smem<D>::kQ);
      tma_load_tile<D>(sQ, &p.tq, q_full, kBlockM, h, q0, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int t = n_tiles - 1 - i;
        const int stage = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(&k_empty[stage], parity);
        mbar_arrive_expect_tx(&k_full[stage], Smem<D>::kKV);
        tma_load_tile<D>(sK + stage * Smem<D>::kKV, &p.tk, &k_full[stage],
                         kBlockN, hk, t * kBlockN, bi);
        mbar_wait(&v_empty[stage], parity);
        mbar_arrive_expect_tx(&v_full[stage], Smem<D>::kKV);
        tma_load_tile<D>(sV + stage * Smem<D>::kKV, &p.tv, &v_full[stage],
                         kBlockN, hk, t * kBlockN, bi);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each.
    reg_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    const int row_a = q0 + cw * 64 + warp * 16 + g;  // this thread's rows
    const int row_b = row_a + 8;
    const int qpos_a = q_start + row_a;  // their key-space positions
    const int qpos_b = q_start + row_b;
    const float sl2 = p.scale * kLog2e;
    // Tiles below n_plain need no mask: every key is before sk and (causal)
    // at or before the first row's position.
    int n_plain = p.sk / kBlockN;
    if (p.causal) n_plain = min(n_plain, (q_start + q0 + 1) / kBlockN);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_i[2] = {kNegInf, kNegInf};
    float l_i[2] = {0.f, 0.f};  // this thread's partial row sums
    float s[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];

    // S = Q K^T for the tile in `stage`.
    auto issue_qk = [&](int stage) {
      const unsigned char* k_tile = sK + stage * Smem<D>::kKV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(s, desc_k_major(sQ, kBlockM, cw * 64, kk),
                 desc_k_major(k_tile, kBlockN, 0, kk), kk > 0);
      }
    };
    // O += P V for the tile in `stage`.
    auto issue_pv = [&](int stage) {
      const unsigned char* v_tile = sV + stage * Smem<D>::kKV;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs(o, pa[kk], desc_mn_major(v_tile, kBlockN, kk), 1);
      }
    };
    // Mask, new row maxima, P = exp(S * scale - m) in place, this tile's
    // partial row sums; returns the factors that rescale the old O and l.
    auto softmax = [&](int t, float (&corr)[2], float (&rs)[2]) {
      if (t >= n_plain) {
        const int k0 = t * kBlockN;
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + tig * 2 + (e & 1);
            const int qpos = (e < 2) ? qpos_a : qpos_b;
            if (key >= p.sk || (p.causal && key > qpos)) s[4 * j + e] = kNegInf;
          }
        }
      }
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2_approx((m_i[r] - mx[r]) * sl2);
        m_i[r] = mx[r];
        // A row with no visible key so far: its masked scores give P = 0.
        base[r] = (mx[r] == kNegInf) ? 0.f : mx[r] * sl2;
        rs[r] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = exp2_approx(fmaf(s[4 * j + e], sl2, -base[e >> 1]));
          s[4 * j + e] = pv;
          rs[e >> 1] += pv;
        }
      }
    };

    mbar_wait(q_full, 0);
    // First tile (the last key tile): S, softmax, P.
    {
      mbar_wait(&k_full[0], 0);
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (tid == 0) mbar_arrive(&k_empty[0]);
      float corr[2], rs[2];
      softmax(n_tiles - 1, corr, rs);
      l_i[0] = rs[0];
      l_i[1] = rs[1];
      acc_to_a<kBlockN>(pa, s);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int prev = (i - 1) % kStages;
      mbar_wait(&k_full[stage], (i / kStages) & 1);
      wgmma_fence();
      issue_qk(stage);  // S of tile i ...
      wgmma_commit();
      mbar_wait(&v_full[prev], ((i - 1) / kStages) & 1);
      issue_pv(prev);  // ... while P V of tile i - 1 is in flight
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      if (tid == 0) mbar_arrive(&k_empty[stage]);
      float corr[2], rs[2];
      softmax(n_tiles - 1 - i, corr, rs);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (tid == 0) mbar_arrive(&v_empty[prev]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      l_i[0] = l_i[0] * corr[0] + rs[0];
      l_i[1] = l_i[1] * corr[1] + rs[1];
      acc_to_a<kBlockN>(pa, s);
    }
    {
      const int last = n_tiles - 1;
      mbar_wait(&v_full[last % kStages], (last / kStages) & 1);
      wgmma_fence();
      issue_pv(last % kStages);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    // Epilogue: full row sums across the 4 threads of each row, O / l in
    // bf16, lse = m * scale + log(l).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
      l_i[r] = fmaxf(l_i[r], 1e-30f);
    }
    const float inv_a = 1.f / l_i[0];
    const float inv_b = 1.f / l_i[1];
    __nv_bfloat16* o_base = p.o + bi * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (row_a < p.sq) {
        *reinterpret_cast<uint32_t*>(o_base + row_a * p.o_ss + col) =
            pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      }
      if (row_b < p.sq) {
        *reinterpret_cast<uint32_t*>(o_base + row_b * p.o_ss + col) =
            pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
      }
    }
    if (tig == 0) {
      float* lse_row = p.lse + static_cast<long long>(bh) * p.sq;
      if (row_a < p.sq) lse_row[row_a] = m_i[0] * p.scale + logf(l_i[0]);
      if (row_b < p.sq) lse_row[row_b] = m_i[1] * p.scale + logf(l_i[1]);
    }
  }
}

template <int D>
int launch(Params& p, const void* q, const void* k, const void* v,
           const long long* qs, const long long* ks, const long long* vs,
           int device, cudaStream_t stream) {
  int err = make_tma_map(&p.tq, q, p.b, p.sq, p.hq, D, qs[0], qs[1], qs[2],
                         kBlockM);
  if (err == 0) {
    err = make_tma_map(&p.tk, k, p.b, p.sk, p.hkv, D, ks[0], ks[1], ks[2],
                       kBlockN);
  }
  if (err == 0) {
    err = make_tma_map(&p.tv, v, p.b, p.sk, p.hkv, D, vs[0], vs[1], vs[2],
                       kBlockN);
  }
  if (err != 0) return err;
  // The shared-memory opt-in, once per device.
  static bool ready[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::kBytes);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  p.m_blocks = (p.sq + kBlockM - 1) / kBlockM;
  const long long grid = static_cast<long long>(p.m_blocks) * p.b * p.hq;
  flash_fwd_kernel<D><<<static_cast<unsigned>(grid), kThreads,
                        Smem<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int skytpu_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int b, int sq, int sk, int hq, int hkv, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.b = b; p.sq = sq; p.sk = sk; p.hq = hq; p.hkv = hkv;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, q, k, v, qs, ks, vs, device, s);
  if (d == 128) return launch<128>(p, q, k, v, qs, ks, vs, device, s);
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
