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
// Design.  One CTA of 256 threads per (batch*head, 64-row q tile); a loop
// over the 64-row k tiles inside the block takes the place of the TPU
// grid's sequential "arbitrary" axis.  The q, k and v tiles are staged in
// shared memory as f32 (rows padded by one word against bank conflicts),
// each thread owns 4 rows x 4 columns of the score tile and 4 rows x D/16
// columns of the output, and the online-softmax state m, l and acc stays in
// f32 registers.  Row reductions are shuffles among the 16 lanes that share
// a row.  Both products are plain f32 FMAs: exact for bf16 inputs (their
// products fit an f32 mantissa) and for f32 inputs alike.
//
// Bound on an H100 SXM at the serving shape (B=8, T=512, 32 q / 8 kv heads,
// D=128, bf16, causal): q, k, v read once and o, lse written once are about
// 84 MB, i.e. 25 us at 3.35 TB/s; the causal half of the two products is
// about 17 GFLOP, 17 us at 989 TFLOP/s on the tensor cores.  So the kernel
// is bound by memory, near 25 us (chip_smoke.py recomputes both figures
// from the shapes it runs).
//
// What this simple design leaves on the table: it uses no tensor cores
// (FMAs on shared-memory operands run far below the card's bf16 rate), no
// TMA or cp.async overlap of the next tile's load with this tile's math, no
// warp specialisation, and one q tile per CTA with no persistent schedule
// over the causal triangle's uneven tiles.  wgmma with a TMA-fed ring of k/v
// tiles is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}
