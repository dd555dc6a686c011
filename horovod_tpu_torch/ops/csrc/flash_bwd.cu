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
// Designs.
//   float32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): the first design,
//   kept because a TF32 wgmma would not hold the 1e-4 the float32 tests
//   ask.  256 threads on 64 x 64 tiles staged in shared memory (rows
//   padded by one word against bank conflicts); each thread owns 4 rows x
//   4 columns of the score tile and 4 rows x D/16 columns of its
//   accumulators, and every product is a plain f32 FMA.
//     dq:   one CTA per (batch*head, 64-row q tile).  q, do, lse and delta
//           stay resident; a loop over the live k tiles recomputes s and dp,
//           writes ds to shared memory and accumulates dq in registers.
//     dk/dv: one CTA per (batch*kv head, 64-row k tile), k and v resident,
//           a loop over the rep q heads x live q tiles inside the block.
//   bfloat16: the products on the tensor cores, in warp-specialised CTAs of
//   three warpgroups.  The producer warpgroup (24 registers a thread after
//   setmaxnreg) loads the block's resident tiles once with TMA and streams
//   the others through a 2-stage ring (128-byte swizzle; rows past the
//   ragged edge arrive as zeros), each stage guarded by a full and an
//   empty mbarrier.  Each consumer warpgroup (240 registers) owns 64 rows
//   and their accumulators; per ring stage it runs the two score products
//   (wgmma m64n64k16, both operands K-major, in two commit groups so that
//   p is computed while the second runs), forms p and ds on the f32
//   accumulator fragment, rounds them to bf16 once, straight into the
//   register A fragment of the gradient products, whose B operand is
//   MN-major.  The mask is two compares an entry against the range the
//   entry's row may attend (ragged edges, causal diagonal, window), and a
//   masked entry is never exponentiated.
//     dq (flash_bwd_dq_wgmma_kernel): one CTA per (batch*head, 128-row q
//           tile), q and do resident, 64-row k/v tiles through the ring
//           (only the live ones, k_lo to k_hi).  Per stage S = Q K^T and
//           dP = dO V^T, then dQ += bf16(dS) K (m64nDk16, K as the
//           MN-major B, as v in the forward's P V).  A thread's two rows
//           are fixed for the block, so their lse (times log2 e), delta
//           and key range live in registers.  Each dq row is summed
//           inside one CTA: no atomics, as FA3's dq-by-atomics inside the
//           dk/dv kernel would need.
//     dk/dv (flash_bwd_dkv_wgmma_kernel): one CTA per (batch*kv head,
//           128-row k tile), k and v resident, 64-row q/do tiles through
//           the ring over the rep q heads x live q tiles, the producer's
//           second warp staging each tile's lse and delta rows beside them.
//           Per stage S^T = K Q^T and dP^T = V dO^T, then dV += bf16(P^T) dO
//           and dK += bf16(dS^T) Q.  The mask includes q < Tq, since q rows
//           past Tq arrive as zeros with lse = delta = 0.
// Either way the rep q heads of a kv head are summed inside one block:
// GQA needs no atomics, and every result is bitwise reproducible.
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
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the bf16 kernels report
// 168 registers (the launch allocation of 384 threads; consumers raise
// theirs to 240).  dq has no spills at D=64 or 128: its consumers hold dq
// (D/2 registers), S and dP (32 each) and the dS fragment (16).  dk/dv
// spills 288 B at D=128 (none at D=64): two 64-register accumulators, the
// 32-register S^T and dP^T and two A fragments come close to 240 at their
// peak.  A 128-row k tile in dq spilled 516 B at D=128 and measured
// slower; a 3-stage ring gained nothing (PERF.md).  The f32 kernels: dq
// 128 registers at D=128 with 8 B of spill, 126 at D=64; dk/dv 182 and
// 128, no spills.  Shared memory per
// block at D=128: 132,136 B (bf16 dq), 133,160 B (bf16 dk/dv), 149,248 B
// (f32 dq), 165,888 B (f32 dk/dv); one block per SM.
//
// What is left on the table: no persistent scheduler over the causal
// triangle's uneven tiles (the heaviest-first order only softens the
// tail); no overlap inside a consumer of one stage's products with the
// next stage's (each stage waits for dQ += dS K, or for dV and dK, before
// the next S); m64n64 score products, below the tensor cores' best shape;
// dq reads each kv head's k/v once for each of its rep q heads and q
// tiles, and dk/dv each q head's q/do once for each k tile; dk/dv spills.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

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

// Stage rows [t0, t0 + 64) of one head into a padded tile, zeros past the
// ragged edge.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int t0, int t_len, int st,
                                          int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int t = t0 + r;
    dst[r * (D + 1) + c] = t < t_len ? src[(int64_t)t * st + c] : 0.f;
  }
}

template <int D>
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

  const float* Q = static_cast<const float*>(p.q) + (int64_t)b * p.q_sb +
                   (int64_t)h * p.q_sh;
  const float* DO = static_cast<const float*>(p.dout) +
                    (int64_t)b * p.d_sb + (int64_t)h * p.d_sh;
  const float* Kp = static_cast<const float*>(p.k) + (int64_t)b * p.k_sb +
                    (int64_t)kh * p.k_sh;
  const float* Vp = static_cast<const float*>(p.v) + (int64_t)b * p.v_sb +
                    (int64_t)kh * p.v_sh;
  float* DQ = static_cast<float*>(p.o0) + (int64_t)b * p.o0_sb +
              (int64_t)h * p.o0_sh;

  load_tile<D>(sQ, Q, q0, p.Tq, p.q_st, tid);
  load_tile<D>(sDO, DO, q0, p.Tq, p.d_st, tid);
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
    load_tile<D>(sK, Kp, k0, p.Tk, p.k_st, tid);
    load_tile<D>(sV, Vp, k0, p.Tk, p.v_st, tid);
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
        sDS[(ty * 4 + i) * PS + tx + 16 * j] = ds;
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
      DQ[(int64_t)row * p.o0_st + tx + 16 * c] = acc[i][c];
  }
}

template <int D>
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

  const float* Kp = static_cast<const float*>(p.k) + (int64_t)b * p.k_sb +
                    (int64_t)kh * p.k_sh;
  const float* Vp = static_cast<const float*>(p.v) + (int64_t)b * p.v_sb +
                    (int64_t)kh * p.v_sh;
  float* DK = static_cast<float*>(p.o0) + (int64_t)b * p.o0_sb +
              (int64_t)kh * p.o0_sh;
  float* DV = static_cast<float*>(p.o1) + (int64_t)b * p.o1_sb +
              (int64_t)kh * p.o1_sh;

  load_tile<D>(sK, Kp, k0, p.Tk, p.k_st, tid);
  load_tile<D>(sV, Vp, k0, p.Tk, p.v_st, tid);

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
    const float* Q = static_cast<const float*>(p.q) +
                     (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
    const float* DO = static_cast<const float*>(p.dout) +
                      (int64_t)b * p.d_sb + (int64_t)h * p.d_sh;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile's q/do/p/ds are no longer read
      load_tile<D>(sQ, Q, q0, p.Tq, p.q_st, tid);
      load_tile<D>(sDO, DO, q0, p.Tq, p.d_st, tid);
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
          sP[(ty * 4 + i) * PS + tx + 16 * j] = pv;
          sDS[(ty * 4 + i) * PS + tx + 16 * j] = ds;
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
      DK[(int64_t)row * p.o0_st + tx + 16 * c] = dk[i][c];
      DV[(int64_t)row * p.o1_st + tx + 16 * c] = dv[i][c];
    }
  }
}

template <int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) +
               2 * BQ) * sizeof(float);
  // Above 48 KB a block's shared memory must be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.H * p.n_qt;
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) +
               2 * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.K * p.n_kt;
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 dk/dv: wgmma + TMA ring
constexpr int WG = 128;          // threads of a warpgroup
constexpr int WS_THREADS = 384;  // one producer + two consumer warpgroups
constexpr int TK = 128;          // k rows per block, 64 per consumer
constexpr int TQ = 64;           // q rows per ring stage
constexpr int STAGES = 2;

template <int D>
struct DkvSmem {
  static constexpr uint32_t HALF_K = TK * 128;     // one 64-column half
  static constexpr uint32_t HALF_Q = TQ * 128;
  static constexpr uint32_t KV_BYTES = D / 64 * HALF_K;   // k or v
  static constexpr uint32_t QT_BYTES = D / 64 * HALF_Q;   // q or do
  static constexpr uint32_t TILES = 2 * KV_BYTES + STAGES * 2 * QT_BYTES;
  static constexpr size_t BYTES =
      1024 + TILES + STAGES * 2 * TQ * 4 + (2 * STAGES + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               Params p) {
  using namespace hopper;
  using S = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_1k(smem_raw);
  uint8_t* sV = sK + S::KV_BYTES;
  uint8_t* ring = sV + S::KV_BYTES;   // stage s: q, then do
  float* sL = reinterpret_cast<float*>(sK + S::TILES);   // [STAGES][TQ]
  float* sDel = sL + STAGES * TQ;                        // [STAGES][TQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(sDel + STAGES * TQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int BKH = p.B * p.K;
  const int kt = blockIdx.x / BKH;   // the first k tiles meet the most q tiles
  const int bk = blockIdx.x % BKH;
  const int b = bk / p.K;
  const int kh = bk % p.K;
  const int rep = p.H / p.K;
  const int k0 = kt * TK;

  // The q rows that may attend a key of this tile, as in the f32 kernel;
  // the loop runs over the rep q heads x these q tiles.
  int q_lo = 0, q_hi = p.Tq;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(q_hi, min(k0 + TK, p.Tk) - 1 + p.window);
  }
  const int qt0 = q_lo / TQ;
  const int nq = q_hi > qt0 * TQ ? (q_hi - qt0 * TQ + TQ - 1) / TQ : 0;
  const int n = rep * nq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA thread + the lse/delta warp
      mbar_init(&empty[s], 2 * WG);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {
    // Producer: thread 0 loads k and v once, then keeps the ring of q/do
    // tiles full; warp 1 stages each tile's lse (log2 units) and delta.
    producer_regs();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_arrive_tx(kvbar, 2 * S::KV_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sK + c * S::HALF_K, &tk, kvbar, 64 * c, k0, kh, b);
        tma_load(sV + c * S::HALF_K, &tv, kvbar, 64 * c, k0, kh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int h = kh * rep + i / nq;
        const int q0 = (qt0 + i % nq) * TQ;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        uint8_t* sq = ring + s * 2 * S::QT_BYTES;
        mbar_arrive_tx(&full[s], 2 * S::QT_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sq + c * S::HALF_Q, &tq, &full[s], 64 * c, q0, h, b);
          tma_load(sq + S::QT_BYTES + c * S::HALF_Q, &tdo, &full[s], 64 * c,
                   q0, h, b);
        }
      }
    } else if (warp == 1) {
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int64_t bh = (int64_t)b * p.H + kh * rep + i / nq;
        const int q0 = (qt0 + i % nq) * TQ;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        for (int r = lane; r < TQ; r += 32) {
          const int t = q0 + r;
          sL[s * TQ + r] = t < p.Tq ? p.lse[bh * p.Tq + t] * LOG2E : 0.f;
          sDel[s * TQ + r] = t < p.Tq ? p.delta[bh * p.Tq + t] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // Consumers: warpgroup c owns k rows k0 + 64 c .. + 63 and their dk, dv.
    consumer_regs();
    const int c = threadIdx.x / WG - 1;
    const int warp = (threadIdx.x % WG) / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = k0 + 64 * c + 16 * warp + lane / 4;   // and row0 + 8
    const int col_l = 2 * (lane % 4);
    const float scale_log2 = p.scale * LOG2E;
    const uint32_t ka = smem_u32(sK) + c * 64 * 128;
    const uint32_t va = smem_u32(sV) + c * 64 * 128;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt0 + i % nq) * TQ;
      const uint32_t sq = smem_u32(ring) + s * 2 * S::QT_BYTES;
      const uint32_t sdo = sq + S::QT_BYTES;
      mbar_wait(&full[s], (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T (64 k rows x 64 q rows, K-major), in
      // two groups: p^T is computed while dP^T is still on the tensor cores.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(st,
                     make_desc(ka + (kk / 4) * S::HALF_K + (kk % 4) * 32, 16),
                     make_desc(sq + (kk / 4) * S::HALF_Q + (kk % 4) * 32, 16),
                     kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(dpt,
                     make_desc(va + (kk / 4) * S::HALF_K + (kk % 4) * 32, 16),
                     make_desc(sdo + (kk / 4) * S::HALF_Q + (kk % 4) * 32, 16),
                     kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale.  The
      // mask is two compares an entry against the q columns (relative to
      // q0) that k row row0 + 8 hh may attend, [lo[hh], hi[hh]): the ragged
      // edges, the causal diagonal and the window.  A masked entry is never
      // exponentiated (a q row past Tq reads as zeros with lse = delta = 0,
      // and would give p = 1 if it were).  One path for every tile: a
      // second, unmasked copy of this code costs the consumers registers.
      const float* lrow = sL + s * TQ;
      const float* drow = sDel + s * TQ;
      int lo[2], hi[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kr = row0 + 8 * hh;
        lo[hh] = (p.causal ? kr : 0) - q0;
        int end = p.Tq;
        if (p.causal && p.window > 0) end = min(end, kr + p.window);
        hi[hh] = kr < p.Tk ? end - q0 : lo[hh];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * j + col_l + e;
          const float lse2 = lrow[qc];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int idx = 4 * j + 2 * hh + e;
            const bool ok = qc >= lo[hh] && qc < hi[hh];
            st[idx] = ok ? exp2f(st[idx] * scale_log2 - lse2) : 0.f;
          }
        }
      wgmma_wait_all();
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float del = drow[8 * j + col_l + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int idx = 4 * j + 2 * hh + e;
            dpt[idx] = st[idx] * (dpt[idx] - del) * p.scale;
          }
        }
      // dV += P^T dO and dK += dS^T Q, with p rounded to do's dtype and ds
      // to q's (bf16) straight into the A fragments; dO and Q are [q rows,
      // D], MN-major.
      uint32_t af[16], bf[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          af[4 * kk + r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          bf[4 * kk + r] =
              pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        wgmma_rs<D>(dv, &af[4 * kk], make_desc(sdo + kk * 2048, S::HALF_Q));
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        wgmma_rs<D>(dk, &bf[4 * kk], make_desc(sq + kk * 2048, S::HALF_Q));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* DK = static_cast<__nv_bfloat16*>(p.o0) +
                        (int64_t)b * p.o0_sb + (int64_t)kh * p.o0_sh;
    __nv_bfloat16* DV = static_cast<__nv_bfloat16*>(p.o1) +
                        (int64_t)b * p.o1_sb + (int64_t)kh * p.o1_sh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= p.Tk) continue;
      __nv_bfloat16* krow = DK + (int64_t)row * p.o0_st + col_l;
      __nv_bfloat16* vrow = DV + (int64_t)row * p.o1_st + col_l;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------- bf16 dq: wgmma + TMA ring
constexpr int DQ_TQ = 128;              // q rows per block, 64 per consumer
constexpr int DQ_TK = 64;               // k rows per ring stage
constexpr int DQ_STAGES = 2;

template <int D>
struct DqSmem {
  static constexpr uint32_t HALF_Q = DQ_TQ * 128;    // one 64-column half
  static constexpr uint32_t HALF_K = DQ_TK * 128;
  static constexpr uint32_t Q_BYTES = D / 64 * HALF_Q;    // q or do
  static constexpr uint32_t KV_BYTES = D / 64 * HALF_K;   // k or v
  static constexpr uint32_t TILES = 2 * Q_BYTES + DQ_STAGES * 2 * KV_BYTES;
  static constexpr size_t BYTES = 1024 + TILES + (2 * DQ_STAGES + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              Params p) {
  using namespace hopper;
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1k(smem_raw);
  uint8_t* sDO = sQ + S::Q_BYTES;
  uint8_t* ring = sDO + S::Q_BYTES;   // stage s: k, then v
  uint64_t* full = reinterpret_cast<uint64_t*>(sQ + S::TILES);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* qbar = empty + DQ_STAGES;

  const int BH = p.B * p.H;
  const int qt = p.n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int bh = blockIdx.x % BH;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.K);   // GQA: rep consecutive q heads share kh
  const int q0 = qt * DQ_TQ;

  // The k range any row of this tile may attend, as in the f32 kernel.
  const int q_last = min(q0 + DQ_TQ, p.Tq) - 1;
  int k_hi = p.Tk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.causal && p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int kt0 = k_lo / DQ_TK;
  const int n = k_hi > kt0 * DQ_TK ? (k_hi - kt0 * DQ_TK + DQ_TK - 1) / DQ_TK
                                   : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {
    // Producer: one thread loads q and do once, then keeps the ring of k/v
    // tiles full.
    producer_regs();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qbar, 2 * S::Q_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sQ + c * S::HALF_Q, &tq, qbar, 64 * c, q0, h, b);
        tma_load(sDO + c * S::HALF_Q, &tdo, qbar, 64 * c, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % DQ_STAGES;
        const int k0 = (kt0 + i) * DQ_TK;
        mbar_wait(&empty[s], ((i / DQ_STAGES) & 1) ^ 1);
        uint8_t* sk = ring + s * 2 * S::KV_BYTES;
        mbar_arrive_tx(&full[s], 2 * S::KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sk + c * S::HALF_K, &tk, &full[s], 64 * c, k0, kh, b);
          tma_load(sk + S::KV_BYTES + c * S::HALF_K, &tv, &full[s], 64 * c,
                   k0, kh, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows q0 + 64 c .. + 63 and their dq.
    consumer_regs();
    const int c = threadIdx.x / WG - 1;
    const int warp = (threadIdx.x % WG) / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * c + 16 * warp + lane / 4;   // and row0 + 8
    const int col_l = 2 * (lane % 4);
    const float scale_log2 = p.scale * LOG2E;
    const uint32_t qa = smem_u32(sQ) + c * 64 * 128;
    const uint32_t da = smem_u32(sDO) + c * 64 * 128;

    // A thread's rows are fixed for the whole block, so their lse (log2
    // units), delta and key range [lo, hi) live in registers: the ragged
    // Tk edge, the causal diagonal and the window.  A row past Tq attends
    // nothing (hi = lo) and is not written.
    float lse2[2], del[2];
    int lo[2], hi[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      const bool in = row < p.Tq;
      lse2[hh] = in ? p.lse[(int64_t)bh * p.Tq + row] * LOG2E : 0.f;
      del[hh] = in ? p.delta[(int64_t)bh * p.Tq + row] : 0.f;
      lo[hh] = p.causal && p.window > 0 ? row - p.window + 1 : 0;
      hi[hh] = !in ? lo[hh] : p.causal ? min(p.Tk, row + 1) : p.Tk;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % DQ_STAGES;
      const int k0 = (kt0 + i) * DQ_TK;
      const uint32_t sk = smem_u32(ring) + s * 2 * S::KV_BYTES;
      const uint32_t sv = sk + S::KV_BYTES;
      mbar_wait(&full[s], (i / DQ_STAGES) & 1);

      // S = Q K^T and dP = dO V^T (64 q rows x DQ_TK keys, K-major), in
      // two groups: p is computed while dP is still on the tensor cores.
      float st[DQ_TK / 2], dp[DQ_TK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<DQ_TK>(st,
                        make_desc(qa + (kk / 4) * S::HALF_Q + (kk % 4) * 32, 16),
                        make_desc(sk + (kk / 4) * S::HALF_K + (kk % 4) * 32, 16),
                        kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<DQ_TK>(dp,
                        make_desc(da + (kk / 4) * S::HALF_Q + (kk % 4) * 32, 16),
                        make_desc(sv + (kk / 4) * S::HALF_K + (kk % 4) * 32, 16),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // p = exp(s scale - lse), 0 where masked: a masked entry is never
      // exponentiated (keys past Tk arrive as zeros, and an empty row has
      // lse = 0).  One path for every tile, as in dk/dv.
#pragma unroll
      for (int j = 0; j < DQ_TK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * hh + e;
            const int kc = k0 + 8 * j + col_l + e;
            const bool ok = kc >= lo[hh] && kc < hi[hh];
            st[idx] = ok ? exp2f(st[idx] * scale_log2 - lse2[hh]) : 0.f;
          }
      wgmma_wait_all();
      fence_regs(dp);
      // ds = p (dp - delta) scale, rounded to bf16 once (:211), straight
      // into the A fragment of dQ += dS K.
      uint32_t af[DQ_TK / 4];
#pragma unroll
      for (int kk = 0; kk < DQ_TK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = 8 * kk + 2 * r, hh = r & 1;
          af[4 * kk + r] =
              pack_bf16(st[idx] * (dp[idx] - del[hh]) * p.scale,
                        st[idx + 1] * (dp[idx + 1] - del[hh]) * p.scale);
        }
      // K is [DQ_TK keys, D], MN-major, as v in the forward's P V.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_TK / 16; ++kk)
        wgmma_rs<D>(dq, &af[4 * kk], make_desc(sk + kk * 2048, S::HALF_K));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* DQ = static_cast<__nv_bfloat16*>(p.o0) +
                        (int64_t)b * p.o0_sb + (int64_t)h * p.o0_sh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= p.Tq) continue;
      __nv_bfloat16* qrow = DQ + (int64_t)row * p.o0_st + col_l;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) =
            __floats2bfloat162_rn(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_map(&mq, p.q, p.B, p.Tq, p.H, D, p.q_sb, p.q_sh, p.q_st,
                        DQ_TQ) ||
      !hopper::make_map(&mdo, p.dout, p.B, p.Tq, p.H, D, p.d_sb, p.d_sh,
                        p.d_st, DQ_TQ) ||
      !hopper::make_map(&mk, p.k, p.B, p.Tk, p.K, D, p.k_sb, p.k_sh, p.k_st,
                        DQ_TK) ||
      !hopper::make_map(&mv, p.v, p.B, p.Tk, p.K, D, p.v_sb, p.v_sh, p.v_st,
                        DQ_TK))
    return cudaErrorInvalidValue;
  Params w = p;
  w.n_qt = (p.Tq + DQ_TQ - 1) / DQ_TQ;
  const size_t smem = DqSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.H * w.n_qt;
  flash_bwd_dq_wgmma_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, w);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_map(&mq, p.q, p.B, p.Tq, p.H, D, p.q_sb, p.q_sh, p.q_st,
                        TQ) ||
      !hopper::make_map(&mdo, p.dout, p.B, p.Tq, p.H, D, p.d_sb, p.d_sh,
                        p.d_st, TQ) ||
      !hopper::make_map(&mk, p.k, p.B, p.Tk, p.K, D, p.k_sb, p.k_sh, p.k_st,
                        TK) ||
      !hopper::make_map(&mv, p.v, p.B, p.Tk, p.K, D, p.v_sb, p.v_sh, p.v_st,
                        TK))
    return cudaErrorInvalidValue;
  const size_t smem = DkvSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.B * p.K * ((p.Tk + TK - 1) / TK);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, p);
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
  if (dtype == 0 && head_dim == 64) return (int)launch_dq<64>(p, st);
  if (dtype == 0 && head_dim == 128) return (int)launch_dq<128>(p, st);
  if (dtype == 1 && head_dim == 64) return (int)launch_dq_wgmma<64>(p, st);
  if (dtype == 1 && head_dim == 128) return (int)launch_dq_wgmma<128>(p, st);
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
  if (dtype == 0 && head_dim == 64) return (int)launch_dkv<64>(p, st);
  if (dtype == 0 && head_dim == 128) return (int)launch_dkv<128>(p, st);
  if (dtype == 1 && head_dim == 64) return (int)launch_dkv_wgmma<64>(p, st);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_dkv_wgmma<128>(p, st);
  return (int)cudaErrorInvalidValue;
}
