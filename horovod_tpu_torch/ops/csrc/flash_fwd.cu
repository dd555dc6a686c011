// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (horovod_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (horovod_tpu/ops/flash_attention.py:98-166, launched by `_fwd_impl` at
// :285-328).  It computes the same contract, not a copy of the Pallas grid:
//   o[b, t, h, :] = softmax(scale * q k^T + mask) v   in q's dtype,
//   lse[b*H + h, t] = logsumexp of the masked, scaled row (f32),
// with the masks the TPU kernel applies (the ragged tk edge, causal, the
// sliding window), whole k-tiles above the causal diagonal or below the
// window band skipped, GQA read through kv head h / rep without a
// materialised repeat, p rounded to v's dtype before the p.v product,
// NEG_INF = -1e30 instead of -inf, and lse = 0 (o = 0) for a row that no
// key may attend.
//
// Two designs, by dtype.
//
// bfloat16 (flash_fwd_wgmma_kernel): the products on the tensor cores.
// One CTA of three warpgroups per (batch*head, 128-row q tile), heaviest
// tiles first.  Warpgroup 0 is the producer: after `setmaxnreg` gives its
// registers away (24 a thread), one thread loads the q tile once and
// streams 128-row k and v tiles through a 2-stage ring in shared memory
// with TMA (128-byte swizzle, two 64-column boxes per row at D = 128; rows
// past Tk arrive as zeros), each stage guarded by a full and an empty
// mbarrier.  Warpgroups 1 and 2 are consumers (240 registers a thread),
// each owning 64 q rows: S = Q K^T is a wgmma m64n128k16 chain with both
// operands K-major in shared memory; the online softmax runs on the f32
// accumulator fragment (the four lanes of a row reduce by two shuffles,
// exp2 with scale * log2(e) folded in, lse written in natural log); p is
// rounded to bf16 once, straight into the register A fragment of
// O += P V, whose B operand (v, [k rows, D]) is MN-major.  The mask is
// two compares an entry against the key range each row may attend (the
// ragged Tk edge, the causal diagonal, the window), and a masked entry is
// set to exactly 0 (never exp(NEG_INF - NEG_INF) = 1).
//
// float32 (flash_fwd_kernel): the first design, kept because a TF32 wgmma
// would not hold the 1e-4 the float32 tests ask.  One CTA of 256 threads
// per (batch*head, 64-row q tile), q/k/v staged in shared memory as f32,
// each thread 4 x 4 of the score tile, both products plain f32 FMAs.
//
// Bound on an H100 SXM.  Serving shape (B=8, T=512, 32 q / 8 kv heads,
// D=128, bf16, causal): 84 MB read and written, 25 us at 3.35 TB/s, against
// 17 GFLOP (17 us at 989 TFLOP/s): bound by memory.  Training shape (B=2,
// T=4096): 275 GFLOP of causally needed work, 0.278 ms: bound by
// operations.  chip_smoke.py recomputes both from the shapes it runs.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the bf16 kernel reports
// 168 registers (the launch allocation of a 384-thread block; consumers
// raise theirs to 240 with setmaxnreg), 24 B of spill stores at D = 128
// and none at D = 64;
// 164,904 B of shared memory at D = 128 (82,984 at D = 64), one block per
// SM.  The f32 kernel: 124 registers at D = 128, 92 at D = 64, no spills.
//
// What the bf16 design leaves on the table: no overlap inside a consumer
// of the softmax with the next tile's products (each tile waits for its
// S before the softmax and for P V before the next S), no ping-pong
// scheduling of the two consumers, o written straight from registers
// rather than through shared memory and TMA, and no persistent scheduler
// over the causal triangle's uneven tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, K, Tq, Tk;
  // Element strides of the batch, head and row dims; the head dim (D) is
  // contiguous.
  int q_sb, q_sh, q_st;
  int k_sb, k_sh, k_st;
  int v_sb, v_sh, v_st;
  int o_sb, o_sh, o_st;
  float scale;
  int causal;
  int window;   // 0 = none
  int n_qt;     // q tiles per (batch, head)
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int DS = D + 1;   // padded row stride of the q/k/v tiles
  constexpr int PS = BK + 1;  // padded row stride of the p tile
  constexpr int DC = D / 16;  // output columns per thread
  float* sQ = smem;
  float* sK = sQ + BQ * DS;
  float* sV = sK + BK * DS;
  float* sP = sV + BK * DS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group
  const int ty = tid >> 4;   // owns rows ty*4 .. ty*4+3 of the tile
  const int qt = blockIdx.x % p.n_qt;
  const int bh = blockIdx.x / p.n_qt;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.K);   // GQA: rep consecutive q heads share kh
  const int q0 = qt * BQ;

  const T* Q = static_cast<const T*>(p.q) + (int64_t)b * p.q_sb +
               (int64_t)h * p.q_sh;
  const T* Kp = static_cast<const T*>(p.k) + (int64_t)b * p.k_sb +
                (int64_t)kh * p.k_sh;
  const T* Vp = static_cast<const T*>(p.v) + (int64_t)b * p.v_sb +
                (int64_t)kh * p.v_sh;
  T* O = static_cast<T*>(p.o) + (int64_t)b * p.o_sb + (int64_t)h * p.o_sh;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int t = q0 + r;
    sQ[r * DS + c] = t < p.Tq ? to_f(Q[(int64_t)t * p.q_st + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // The k range any row of this tile may attend: the causal diagonal ends
  // it, the window band starts it.  Whole tiles outside it are skipped.
  const int q_last = min(q0 + BQ, p.Tq) - 1;
  int k_hi = p.Tk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.causal && p.window > 0) k_lo = max(0, q0 - p.window + 1);

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's k/v/p are no longer read
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const int t = k0 + r;
      const bool in = t < p.Tk;
      sK[r * DS + c] = in ? to_f(Kp[(int64_t)t * p.k_st + c]) : 0.f;
      sV[r * DS + c] = in ? to_f(Vp[(int64_t)t * p.v_st + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < p.Tk;
        if (p.causal) {
          ok = ok && row >= col;
          if (p.window > 0) ok = ok && row - col < p.window;
        }
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Masked entries contribute exactly 0, so a row no key may attend
        // keeps l = 0 and ends with o = 0, lse = 0.
        const float pv = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        rs += pv;
        // p is rounded to v's dtype for the second product, as the TPU
        // kernel does; l sums the unrounded p.
        sP[(ty * 4 + i) * PS + tx + 16 * j] = to_f(from_f<T>(pv));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[j * DS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Tq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      O[(int64_t)row * p.o_st + tx + 16 * c] = from_f<T>(acc[i][c] / safe_l);
    if (tx == 0)
      p.lse[(int64_t)bh * p.Tq + row] =
          l[i] == 0.f ? 0.f : m[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) *
      sizeof(float);
  // Above 48 KB a block's shared memory must be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.H * p.n_qt;
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16: wgmma + TMA ring
constexpr int WG = 128;          // threads of a warpgroup
constexpr int WS_THREADS = 384;  // one producer + two consumer warpgroups
constexpr int TQ = 128;          // q rows per block, 64 per consumer
constexpr int TK = 128;          // k rows per ring stage
constexpr int STAGES = 2;

struct WgParams {
  void* o;
  float* lse;
  int B, H, K, Tq, Tk;
  int o_sb, o_sh, o_st;
  float scale;
  int causal;
  int window;   // 0 = none
  int n_qt;     // 128-row q tiles per (batch, head)
};

template <int D>
struct FwdSmem {
  static constexpr uint32_t HALF_Q = TQ * 128;     // one 64-column half
  static constexpr uint32_t HALF_K = TK * 128;
  static constexpr uint32_t Q_BYTES = D / 64 * HALF_Q;
  static constexpr uint32_t KV_BYTES = D / 64 * HALF_K;   // k or v
  static constexpr size_t BYTES =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + (2 * STAGES + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           WgParams p) {
  using namespace hopper;
  using S = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1k(smem_raw);
  uint8_t* sKV = sQ + S::Q_BYTES;   // stage s: k, then v
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + STAGES * 2 * S::KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int BH = p.B * p.H;
  const int qt = p.n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int bh = blockIdx.x % BH;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.K);   // GQA: rep consecutive q heads share kh
  const int q0 = qt * TQ;

  // The k range any row of this tile may attend, as in the f32 kernel.
  const int q_last = min(q0 + TQ, p.Tq) - 1;
  int k_hi = p.Tk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.causal && p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int kt0 = k_lo / TK;
  const int n_kt = k_hi > kt0 * TK ? (k_hi - kt0 * TK + TK - 1) / TK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {
    // Producer: one thread keeps the ring of k/v tiles full.
    producer_regs();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qbar, S::Q_BYTES);
      for (int c = 0; c < D / 64; ++c)
        tma_load(sQ + c * S::HALF_Q, &tq, qbar, 64 * c, q0, h, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        uint8_t* sk = sKV + s * 2 * S::KV_BYTES;
        mbar_arrive_tx(&full[s], 2 * S::KV_BYTES);
        const int k0 = (kt0 + i) * TK;
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sk + c * S::HALF_K, &tk, &full[s], 64 * c, k0, kh, b);
          tma_load(sk + S::KV_BYTES + c * S::HALF_K, &tv, &full[s], 64 * c,
                   k0, kh, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows q0 + 64 c .. + 63.
    consumer_regs();
    const int c = threadIdx.x / WG - 1;
    const int warp = (threadIdx.x % WG) / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * c + 16 * warp + lane / 4;   // and row0 + 8
    const int col_l = 2 * (lane % 4);
    const float scale_log2 = p.scale * LOG2E;
    const uint8_t* qa = sQ + c * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // Running max (log2 units) and this thread's share of the row sums.
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt0 + i) * TK;
      const uint8_t* sk = sKV + s * 2 * S::KV_BYTES;
      const uint8_t* sv = sk + S::KV_BYTES;
      mbar_wait(&full[s], (i / STAGES) & 1);

      // S = Q K^T: 64 x 128, both operands K-major.
      float sc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<128>(sc,
                      make_desc(qa + (kk / 4) * S::HALF_Q + (kk % 4) * 32, 16),
                      make_desc(sk + (kk / 4) * S::HALF_K + (kk % 4) * 32, 16),
                      kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // The mask is two compares an entry against the keys (relative to
      // k0) that row row0 + 8 hh may attend, [lo[hh], hi[hh]): the ragged
      // Tk edge, the causal diagonal and the window.  A masked entry is
      // NEG_INF here and contributes exactly 0 below (never
      // exp2(NEG_INF - NEG_INF) = 1).  One path for every tile: an
      // unmasked copy for interior tiles measured slower.
      int lo[2], hi[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        lo[hh] = (p.causal && p.window > 0 ? row - p.window + 1 : 0) - k0;
        hi[hh] = (p.causal ? min(p.Tk, row + 1) : p.Tk) - k0;
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            x *= scale_log2;
            const int kc = 8 * j + col_l + e;
            if (kc < lo[hh] || kc >= hi[hh]) x = NEG_INF;
            mx[hh] = fmaxf(mx[hh], x);
          }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // The four lanes that share a row.
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        alpha[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            x = x == NEG_INF ? 0.f : exp2f(x - m[hh]);
            l[hh] += x;   // l sums the unrounded p
          }
      // p rounded to bf16 once, straight into the A fragment of P V.
      uint32_t pa[32];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[4 * kk + r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // O += P V: V is [k rows, D], MN-major.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<D>(o, &pa[4 * kk], make_desc(sv + kk * 2048, S::HALF_K));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) +
                       (int64_t)b * p.o_sb + (int64_t)h * p.o_sh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= p.Tq) continue;
      // A row no key may attend keeps l = 0: o = 0 and lse = 0.
      const float inv = l[hh] == 0.f ? 1.f : 1.f / l[hh];
      __nv_bfloat16* orow = O + (int64_t)row * p.o_st + col_l;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                  o[4 * j + 2 * hh + 1] * inv);
      if (lane % 4 == 0)
        p.lse[(int64_t)bh * p.Tq + row] =
            l[hh] == 0.f ? 0.f : m[hh] * LN2 + logf(l[hh]);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!hopper::make_map(&mq, p.q, p.B, p.Tq, p.H, D, p.q_sb, p.q_sh, p.q_st,
                        TQ) ||
      !hopper::make_map(&mk, p.k, p.B, p.Tk, p.K, D, p.k_sb, p.k_sh, p.k_st,
                        TK) ||
      !hopper::make_map(&mv, p.v, p.B, p.Tk, p.K, D, p.v_sb, p.v_sh, p.v_st,
                        TK))
    return cudaErrorInvalidValue;
  WgParams w;
  w.o = p.o; w.lse = p.lse;
  w.B = p.B; w.H = p.H; w.K = p.K; w.Tq = p.Tq; w.Tk = p.Tk;
  w.o_sb = p.o_sb; w.o_sh = p.o_sh; w.o_st = p.o_st;
  w.scale = p.scale; w.causal = p.causal; w.window = p.window;
  w.n_qt = (p.Tq + TQ - 1) / TQ;
  const size_t smem = FwdSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.H * w.n_qt;
  flash_fwd_wgmma_kernel<D><<<grid, WS_THREADS, smem, stream>>>(mq, mk, mv, w);
  return cudaGetLastError();
}

// ------------------------------------------------------ layout bring-up
// One warpgroup multiplies a bf16 A [64, KD] by B and writes f32 C [64, N]:
//   MODE 0: B is [N, KD] (K-major, as k in q k^T), C = A B^T, both
//           operands from shared memory;
//   MODE 1: B is [KD, N] (MN-major, as v in p v), C = A B, A from
//           registers in the fragment layout the flash kernels build.
// It checks the descriptors, swizzle and fragment layouts on their own.
template <int MODE, int N, int KD>
__global__ void __launch_bounds__(WG)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const __nv_bfloat16* a, float* out) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = align_1k(smem_raw);
  uint8_t* sB = sA + 64 * KD * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + N * KD * 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col_l = 2 * (lane % 4);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if constexpr (MODE == 0) {
      mbar_arrive_tx(bar, 64 * KD * 2 + N * KD * 2);
      for (int c = 0; c < KD / 64; ++c) {
        tma_load(sA + c * 64 * 128, &ta, bar, 64 * c, 0, 0, 0);
        tma_load(sB + c * N * 128, &tb, bar, 64 * c, 0, 0, 0);
      }
    } else {
      mbar_arrive_tx(bar, N * KD * 2);
      for (int c = 0; c < N / 64; ++c)
        tma_load(sB + c * KD * 128, &tb, bar, 64 * c, 0, 0, 0);
    }
  }
  uint32_t af[KD / 4];
  if constexpr (MODE == 1) {
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      const __nv_bfloat16* ar = a + row0 * KD + 16 * kk + col_l;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat16* x = ar + (r & 1) * 8 * KD + (r >> 1) * 8;
        af[4 * kk + r] = pack_bf16(__bfloat162float(x[0]),
                                   __bfloat162float(x[1]));
      }
    }
  }
  mbar_wait(bar, 0);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    if constexpr (MODE == 0)
      wgmma_ss<N>(d, make_desc(sA + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16),
                  make_desc(sB + (kk / 4) * N * 128 + (kk % 4) * 32, 16), 1);
    else
      wgmma_rs<N>(d, &af[4 * kk], make_desc(sB + kk * 2048, KD * 128));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(row0 + 8 * hh) * N + 8 * j + col_l + e] = d[4 * j + 2 * hh + e];
}

template <int MODE, int N, int KD>
cudaError_t launch_probe(const void* a, const void* b, void* out,
                         cudaStream_t stream) {
  CUtensorMap ma, mb;
  const int b_rows = MODE == 0 ? N : KD, b_cols = MODE == 0 ? KD : N;
  if (!hopper::make_map(&ma, a, 1, 64, 1, KD, 64 * KD, KD, KD, 64) ||
      !hopper::make_map(&mb, b, 1, b_rows, 1, b_cols, b_rows * b_cols, b_cols,
                        b_cols, b_rows))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + 64 * KD * 2 + N * KD * 2 + 8;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel<MODE, N, KD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wgmma_probe_kernel<MODE, N, KD><<<1, WG, smem, stream>>>(
      ma, mb, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int K, int Tq,
                             int Tk, int head_dim, int q_sb, int q_sh,
                             int q_st, int k_sb, int k_sh, int k_st, int v_sb,
                             int v_sh, int v_st, int o_sb, int o_sh, int o_st,
                             float scale, int causal, int window, int dtype,
                             void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.K = K; p.Tq = Tq; p.Tk = Tk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.scale = scale; p.causal = causal; p.window = window;
  p.n_qt = (Tq + BQ - 1) / BQ;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch<float, 64>(p, st);
  if (dtype == 0 && head_dim == 128) return (int)launch<float, 128>(p, st);
  if (dtype == 1 && head_dim == 64) return (int)launch_wgmma<64>(p, st);
  if (dtype == 1 && head_dim == 128) return (int)launch_wgmma<128>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The layout bring-up product (see wgmma_probe_kernel): mode 0 or 1, n and
// kd 64 or 128, bf16 a and b contiguous, out f32 [64, n].
extern "C" int hvd_wgmma_probe(const void* a, const void* b, void* out,
                               int mode, int n, int kd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = mode * 100 + (n / 64) * 10 + kd / 64;
  switch (key) {
    case 11: return (int)launch_probe<0, 64, 64>(a, b, out, st);
    case 12: return (int)launch_probe<0, 64, 128>(a, b, out, st);
    case 21: return (int)launch_probe<0, 128, 64>(a, b, out, st);
    case 22: return (int)launch_probe<0, 128, 128>(a, b, out, st);
    case 111: return (int)launch_probe<1, 64, 64>(a, b, out, st);
    case 112: return (int)launch_probe<1, 64, 128>(a, b, out, st);
    case 121: return (int)launch_probe<1, 128, 64>(a, b, out, st);
    case 122: return (int)launch_probe<1, 128, 128>(a, b, out, st);
  }
  return (int)cudaErrorInvalidValue;
}
