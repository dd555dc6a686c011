// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bound through a plain C interface and loaded with ctypes
// (horovod_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (horovod_tpu/ops/flash_attention.py:170-273, launched by the two
// pallas_calls of `_bwd_impl` at :454 and :481).  Same contract, not a copy
// of the Pallas grids.  Given q, do [B, Tq, H, D], k, v [B, Tk, K, D] and
// the f32 rows lse, delta [B*H, Tq] (lse may be a global logsumexp supplied
// from outside, as ring attention does):
//   p  = exp(scale * q k^T - lse)                  (0 where masked)
//   ds = p * (do v^T - delta) * scale, rounded to the operand dtype
//   dq = ds k,  dk = ds^T q,  dv = round(p)^T do     (f32 sums, then cast)
// with dk and dv summed over the rep = H / K q heads that share a kv head.
// The masks are the TPU kernels' own (ragged tq/tk edges, causal, the
// sliding window); whole tiles outside the causal/window band are skipped,
// as the `live` tests of :182-185 and :235-238 skip them.  A masked entry
// contributes exactly 0 (it is never exponentiated), so an empty row with
// lse = 0 gives dq = 0 and adds nothing to dk, dv.
//
// Design.  Both kernels run 256 threads on 64 x 64 tiles staged in shared
// memory as f32 (rows padded by one word against bank conflicts); each
// thread owns 4 rows x 4 columns of the score tile and 4 rows x D/16
// columns of its accumulators, and every product is a plain f32 FMA (exact
// for bf16 operands, whose products fit an f32 mantissa).
//   dq:   one CTA per (batch*head, 64-row q tile).  q, do, lse and delta stay
//         resident; a loop over the live k tiles recomputes s and dp, writes
//         ds to shared memory and accumulates dq in registers.
//   dk/dv: one CTA per (batch*kv head, 64-row k tile).  k and v stay
//         resident; a loop over the rep q heads x live q tiles, inside the
//         block, accumulates dk and dv in registers.  GQA therefore needs no
//         atomics, and the result is bitwise reproducible.
// Blocks are numbered heaviest first: under a causal mask the last q tiles
// (dq) and the first k tiles (dk/dv) meet the most live tiles.
//
// Bound on an H100 SXM at the training shape (B=2, T=4096, 32 q / 8 kv
// heads, D=128, bf16, causal; 8.39 M live (row, key) pairs per head): dq
// does 3 products, 6*D*pairs*B*H = 412 GFLOP, 0.417 ms at 989 TFLOP/s,
// against 237 MB of q, k, v, do, lse, delta read and dq written (71 us at
// 3.35 TB/s); dk/dv does 4 products, 550 GFLOP, 0.556 ms, against 203 MB.
// Both are bound by operations (chip_smoke.py recomputes the figures from
// the shapes it runs).
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): dq uses 128 registers at
// D=128 with 8 bytes of spill, 126 at D=64; dk/dv uses 182 registers at
// D=128 and 128 at D=64, no spills; the same for f32 and bf16.  Shared
// memory per block at D=128 is 149,248 B (dq) and 165,888 B (dk/dv), so one
// 256-thread block runs per SM.
//
// What this simple design leaves on the table: no tensor cores (wgmma on
// bf16 tiles would run the five products at up to 15x the f32 FMA rate), no
// TMA or cp.async overlap of the next tile's load with this tile's math, one
// block per SM with nothing to hide latency, and no persistent schedule over
// the causal triangle's uneven tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

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

// x rounded to T and widened back: the operand-dtype rounding of p and ds.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B*H, Tq]
  const float* delta;   // [B*H, Tq]
  void* o0;             // dq, or dk
  void* o1;             // unused, or dv
  int B, H, K, Tq, Tk;
  // Element strides of the batch, head and row dims; the head dim (D) is
  // contiguous.
  int q_sb, q_sh, q_st;
  int k_sb, k_sh, k_st;
  int v_sb, v_sh, v_st;
  int d_sb, d_sh, d_st;
  int o0_sb, o0_sh, o0_st;
  int o1_sb, o1_sh, o1_st;
  float scale;
  int causal;
  int window;   // 0 = none
  int n_qt;     // q tiles per (batch, head)
  int n_kt;     // k tiles per (batch, kv head)
};

// May query row `row` attend key `col`?  The mask of `_dq_kernel` and
// `_dkv_kernel`, ragged edges included.
__device__ __forceinline__ bool allowed(const Params& p, int row, int col) {
  bool ok = row < p.Tq && col < p.Tk;
  if (p.causal) {
    ok = ok && row >= col;
    if (p.window > 0) ok = ok && row - col < p.window;
  }
  return ok;
}

// Stage rows [t0, t0 + 64) of one head into a padded f32 tile, zeros past
// the ragged edge.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int t0,
                                          int t_len, int st, int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int t = t0 + r;
    dst[r * (D + 1) + c] = t < t_len ? to_f(src[(int64_t)t * st + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int DS = D + 1;   // padded row stride of the q/do/k/v tiles
  constexpr int PS = BK + 1;  // padded row stride of the ds tile
  constexpr int DC = D / 16;  // dq columns per thread
  float* sQ = smem;
  float* sDO = sQ + BQ * DS;
  float* sK = sDO + BQ * DS;
  float* sV = sK + BK * DS;
  float* sDS = sV + BK * DS;
  float* sL = sDS + BQ * PS;
  float* sDel = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group
  const int ty = tid >> 4;   // owns rows ty*4 .. ty*4+3 of the tile
  const int BH = p.B * p.H;
  const int qt = p.n_qt - 1 - (int)(blockIdx.x / BH);
  const int bh = blockIdx.x % BH;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.K);   // GQA: rep consecutive q heads share kh
  const int q0 = qt * BQ;

  const T* Q = static_cast<const T*>(p.q) + (int64_t)b * p.q_sb +
               (int64_t)h * p.q_sh;
  const T* DO = static_cast<const T*>(p.dout) + (int64_t)b * p.d_sb +
                (int64_t)h * p.d_sh;
  const T* Kp = static_cast<const T*>(p.k) + (int64_t)b * p.k_sb +
                (int64_t)kh * p.k_sh;
  const T* Vp = static_cast<const T*>(p.v) + (int64_t)b * p.v_sb +
                (int64_t)kh * p.v_sh;
  T* DQ = static_cast<T*>(p.o0) + (int64_t)b * p.o0_sb +
          (int64_t)h * p.o0_sh;

  load_tile<T, D>(sQ, Q, q0, p.Tq, p.q_st, tid);
  load_tile<T, D>(sDO, DO, q0, p.Tq, p.d_st, tid);
  for (int r = tid; r < BQ; r += THREADS) {
    const int t = q0 + r;
    sL[r] = t < p.Tq ? p.lse[(int64_t)bh * p.Tq + t] : 0.f;
    sDel[r] = t < p.Tq ? p.delta[(int64_t)bh * p.Tq + t] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // The k range any row of this tile may attend: the causal diagonal ends
  // it, the window band starts it.  Whole tiles outside it are skipped.
  const int q_last = min(q0 + BQ, p.Tq) - 1;
  int k_hi = p.Tk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.causal && p.window > 0) k_lo = max(0, q0 - p.window + 1);

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's k/v/ds are no longer read
    load_tile<T, D>(sK, Kp, k0, p.Tk, p.k_st, tid);
    load_tile<T, D>(sV, Vp, k0, p.Tk, p.v_st, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * DS + d];
        ov[i] = sDO[(ty * 4 + i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * DS + d];
        vv[j] = sV[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const float lse_r = sL[ty * 4 + i];
      const float del_r = sDel[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (allowed(p, row, col)) {
          const float pv = expf(s[i][j] * p.scale - lse_r);
          ds = pv * (dp[i][j] - del_r) * p.scale;
        }
        // ds is rounded to k's dtype for the ds.k product (:211).
        sDS[(ty * 4 + i) * PS + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = sK[j * DS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      DQ[(int64_t)row * p.o0_st + tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int DS = D + 1;   // padded row stride of the k/v/q/do tiles
  constexpr int PS = BQ + 1;  // padded row stride of the p and ds tiles
  constexpr int DC = D / 16;  // dk/dv columns per thread
  float* sK = smem;
  float* sV = sK + BK * DS;
  float* sQ = sV + BK * DS;
  float* sDO = sQ + BQ * DS;
  float* sP = sDO + BQ * DS;    // [k row][q row], transposed scores
  float* sDS = sP + BK * PS;
  float* sL = sDS + BK * PS;
  float* sDel = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // q-column group of the transposed tile
  const int ty = tid >> 4;   // owns k rows ty*4 .. ty*4+3 of the tile
  const int BKH = p.B * p.K;
  const int kt = blockIdx.x / BKH;
  const int bk = blockIdx.x % BKH;
  const int b = bk / p.K;
  const int kh = bk % p.K;
  const int rep = p.H / p.K;
  const int k0 = kt * BK;

  const T* Kp = static_cast<const T*>(p.k) + (int64_t)b * p.k_sb +
                (int64_t)kh * p.k_sh;
  const T* Vp = static_cast<const T*>(p.v) + (int64_t)b * p.v_sb +
                (int64_t)kh * p.v_sh;
  T* DK = static_cast<T*>(p.o0) + (int64_t)b * p.o0_sb +
          (int64_t)kh * p.o0_sh;
  T* DV = static_cast<T*>(p.o1) + (int64_t)b * p.o1_sb +
          (int64_t)kh * p.o1_sh;

  load_tile<T, D>(sK, Kp, k0, p.Tk, p.k_st, tid);
  load_tile<T, D>(sV, Vp, k0, p.Tk, p.v_st, tid);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // The q rows that may attend a key of this tile: the causal diagonal
  // starts them, the window band ends them.  Whole tiles outside are
  // skipped.
  int q_lo = 0, q_hi = p.Tq;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0)
      q_hi = min(q_hi, min(k0 + BK, p.Tk) - 1 + p.window);
  }

  for (int r = 0; r < rep; ++r) {
    const int h = kh * rep + r;
    const int bh = b * p.H + h;
    const T* Q = static_cast<const T*>(p.q) + (int64_t)b * p.q_sb +
                 (int64_t)h * p.q_sh;
    const T* DO = static_cast<const T*>(p.dout) + (int64_t)b * p.d_sb +
                  (int64_t)h * p.d_sh;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile's q/do/p/ds are no longer read
      load_tile<T, D>(sQ, Q, q0, p.Tq, p.q_st, tid);
      load_tile<T, D>(sDO, DO, q0, p.Tq, p.d_st, tid);
      for (int i = tid; i < BQ; i += THREADS) {
        const int t = q0 + i;
        sL[i] = t < p.Tq ? p.lse[(int64_t)bh * p.Tq + t] : 0.f;
        sDel[i] = t < p.Tq ? p.delta[(int64_t)bh * p.Tq + t] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];   // transposed: [k row][q row]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * DS + d];
          vv[i] = sV[(ty * 4 + i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tx + 16 * j) * DS + d];
          ov[j] = sDO[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
            dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + 16 * j;
          float pv = 0.f, ds = 0.f;
          if (allowed(p, row, col)) {
            pv = expf(s[i][j] * p.scale - sL[tx + 16 * j]);
            ds = pv * (dp[i][j] - sDel[tx + 16 * j]) * p.scale;
          }
          // p is rounded to do's dtype for p^T.do (:261), ds to q's dtype
          // for ds^T.q (:265).
          sP[(ty * 4 + i) * PS + tx + 16 * j] = round_to<T>(pv);
          sDS[(ty * 4 + i) * PS + tx + 16 * j] = round_to<T>(ds);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * PS + j];
          dsv[i] = sDS[(ty * 4 + i) * PS + j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float oo = sDO[j * DS + tx + 16 * c];
          const float qq = sQ[j * DS + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], oo, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qq, dk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      DK[(int64_t)row * p.o0_st + tx + 16 * c] = from_f<T>(dk[i][c]);
      DV[(int64_t)row * p.o1_st + tx + 16 * c] = from_f<T>(dv[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) +
               2 * BQ) * sizeof(float);
  // Above 48 KB a block's shared memory must be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.H * p.n_qt;
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) +
               2 * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.K * p.n_kt;
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

bool fill(Params& p, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, int B, int H,
          int K, int Tq, int Tk, const int* strides, float scale, int causal,
          int window) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K || Tq <= 0 || Tk <= 0)
    return false;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B; p.H = H; p.K = K; p.Tq = Tq; p.Tk = Tk;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.d_sb = strides[9]; p.d_sh = strides[10]; p.d_st = strides[11];
  p.scale = scale; p.causal = causal; p.window = window;
  p.n_qt = (Tq + BQ - 1) / BQ;
  p.n_kt = (Tk + BK - 1) / BK;
  return true;
}

}  // namespace

// The inputs' element strides come as one array of 12 ints: (batch, head,
// row) for q, k, v and do in that order.  dtype: 0 = float32,
// 1 = bfloat16.  head_dim: 64 or 128.  Each returns the cudaError_t of its
// launch (0 on success).
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int K, int Tq, int Tk, int head_dim,
                                const int* in_strides, int dq_sb, int dq_sh,
                                int dq_st, float scale, int causal,
                                int window, int dtype, void* stream) {
  Params p;
  if (!fill(p, q, k, v, dout, lse, delta, B, H, K, Tq, Tk, in_strides, scale,
            causal, window))
    return (int)cudaErrorInvalidValue;
  p.o0 = dq; p.o1 = nullptr;
  p.o0_sb = dq_sb; p.o0_sh = dq_sh; p.o0_st = dq_st;
  p.o1_sb = p.o1_sh = p.o1_st = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch_dq<float, 64>(p, st);
  if (dtype == 0 && head_dim == 128) return (int)launch_dq<float, 128>(p, st);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_dq<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_dq<__nv_bfloat16, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int K, int Tq, int Tk, int head_dim,
                                 const int* in_strides, int dk_sb, int dk_sh,
                                 int dk_st, int dv_sb, int dv_sh, int dv_st,
                                 float scale, int causal, int window,
                                 int dtype, void* stream) {
  Params p;
  if (!fill(p, q, k, v, dout, lse, delta, B, H, K, Tq, Tk, in_strides, scale,
            causal, window))
    return (int)cudaErrorInvalidValue;
  p.o0 = dk; p.o1 = dv;
  p.o0_sb = dk_sb; p.o0_sh = dk_sh; p.o0_st = dk_st;
  p.o1_sb = dv_sb; p.o1_sh = dv_sh; p.o1_st = dv_st;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch_dkv<float, 64>(p, st);
  if (dtype == 0 && head_dim == 128)
    return (int)launch_dkv<float, 128>(p, st);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_dkv<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_dkv<__nv_bfloat16, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}
