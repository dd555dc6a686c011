// Adasum's two passes over a working segment, for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (horovod_tpu_torch/ops/_build.py).
//
// No Pallas counterpart.  The JAX package's Adasum is jnp code inside the
// jitted collective program (horovod_tpu/parallel/adasum.py _vhd,
// :224-238, and adasum_combine, :41-53), which XLA fuses around its
// collective-permutes.  Here NCCL moves the halves, so the arithmetic of
// each halving round is two kernels on float32 segments:
//
//   hvd_adasum_dots:    (k.r, k.k, r.r) of two segments of n floats, into
//                       three floats on the card (never read back: the
//                       triple is exchanged with the partner by NCCL and
//                       summed there, so no round waits on the host);
//   hvd_adasum_combine: ca = 1 - ab / (2 aa + eps), cb = 1 - ab / (2 bb +
//                       eps) from the summed triple (ab, aa, bb), then
//                       out = ck * kept + cr * received, with (ck, cr) =
//                       (ca, cb) on the rank that keeps the low half and
//                       (cb, ca) on the other.
//
// The dots are deterministic: a fixed grid for a given n and alignment,
// float32 accumulation in each thread, warp shuffles and one shared-memory
// step in a fixed order, then a second kernel that adds the blocks'
// partials in block order.  No float atomics, so a second call gives the
// same bits, which the ranks rely on: both partners must reach the same
// coefficients.  The dots of a pair of segments do not depend on which of
// the two is passed first (each product is commutative and the order of
// the sum is fixed by the index), so the low rank's dots(a, b) and the high
// rank's are the same function.
//
// The combine rounds every product and the sum separately (__fmul_rn,
// __fadd_rn: no FMA contraction), and the coefficients with one IEEE
// division each, in the order the plain version in ops/adasum.py computes
// them: its result is bitwise the plain version's for the same triple.  It
// may write in place over the kept segment.
//
// Bound on an H100 SXM: bytes, at 3.35 TB/s.  The dots read 8n bytes and
// write 12; the combine reads 8n bytes and writes 4n.  Each round of the
// vector-halving-doubling runs both once on its (halved) segment, so a
// whole reduction reads and writes about 3 times the float32 vector.
//
// Design: one grid-stride loop with 16-byte loads when every pointer is
// 16-byte aligned (the segments of a padded vector that halves evenly
// usually are), scalar loads otherwise; 256 threads a block, at most 1024
// blocks, enough for every SM to hold eight blocks with one 16-byte load a
// thread in flight, which covers HBM's latency at its rate.  What it
// leaves: the two passes read the segment twice (the dots cannot be fused
// into the combine, which needs the partner's dots first), and the
// float32 working copy of a bf16 gradient doubles the bytes on the wire
// and in memory, as the JAX reference's float32 _vhd does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // the wrapper's scratch: 3 * kMaxBlocks

__device__ __forceinline__ void block_sum3(float& x, float& y, float& z) {
  __shared__ float s[3][32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, o);
    y += __shfl_down_sync(0xffffffffu, y, o);
    z += __shfl_down_sync(0xffffffffu, z, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s[0][warp] = x;
    s[1][warp] = y;
    s[2][warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    x = lane < nw ? s[0][lane] : 0.f;
    y = lane < nw ? s[1][lane] : 0.f;
    z = lane < nw ? s[2][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, o);
      y += __shfl_down_sync(0xffffffffu, y, o);
      z += __shfl_down_sync(0xffffffffu, z, o);
    }
  }
}

__device__ __forceinline__ void acc3(float x, float y, float& ab, float& aa,
                                     float& bb) {
  ab = fmaf(x, y, ab);
  aa = fmaf(x, x, aa);
  bb = fmaf(y, y, bb);
}

// Stage 1: block b's partial (a.b, a.a, b.b) into part[3 b .. 3 b + 2].
__global__ void __launch_bounds__(kThreads)
dots_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    long long n, int vec, float* __restrict__ part) {
  float ab = 0.f, aa = 0.f, bb = 0.f;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (long long i = tid; i < n4; i += stride) {
      const float4 x = __ldg(a4 + i), y = __ldg(b4 + i);
      acc3(x.x, y.x, ab, aa, bb);
      acc3(x.y, y.y, ab, aa, bb);
      acc3(x.z, y.z, ab, aa, bb);
      acc3(x.w, y.w, ab, aa, bb);
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride) {
    acc3(__ldg(a + i), __ldg(b + i), ab, aa, bb);
  }
  block_sum3(ab, aa, bb);
  if (threadIdx.x == 0) {
    part[3 * blockIdx.x + 0] = ab;
    part[3 * blockIdx.x + 1] = aa;
    part[3 * blockIdx.x + 2] = bb;
  }
}

// Stage 2: the blocks' partials summed in block order (each thread a fixed
// stride of them, then the fixed tree of block_sum3).
__global__ void __launch_bounds__(kThreads)
dots_final_kernel(const float* __restrict__ part, int nblocks,
                  float* __restrict__ out) {
  float ab = 0.f, aa = 0.f, bb = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += blockDim.x) {
    ab += part[3 * i + 0];
    aa += part[3 * i + 1];
    bb += part[3 * i + 2];
  }
  block_sum3(ab, aa, bb);
  if (threadIdx.x == 0) {
    out[0] = ab;
    out[1] = aa;
    out[2] = bb;
  }
}

__device__ __forceinline__ float mix(float ck, float k, float cr, float r) {
  return __fadd_rn(__fmul_rn(ck, k), __fmul_rn(cr, r));
}

// out = ck * kept + cr * received; out may be kept itself.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* kept, const float* received,
               const float* __restrict__ triple, int is_low, float eps,
               float* out, long long n, int vec) {
  const float ab = triple[0], aa = triple[1], bb = triple[2];
  const float ca =
      __fsub_rn(1.0f, __fdiv_rn(ab, __fadd_rn(__fmul_rn(2.0f, aa), eps)));
  const float cb =
      __fsub_rn(1.0f, __fdiv_rn(ab, __fadd_rn(__fmul_rn(2.0f, bb), eps)));
  const float ck = is_low ? ca : cb, cr = is_low ? cb : ca;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* k4 = reinterpret_cast<const float4*>(kept);
    const float4* r4 = reinterpret_cast<const float4*>(received);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const float4 x = k4[i], y = r4[i];
      float4 o;
      o.x = mix(ck, x.x, cr, y.x);
      o.y = mix(ck, x.y, cr, y.y);
      o.z = mix(ck, x.z, cr, y.z);
      o.w = mix(ck, x.w, cr, y.w);
      o4[i] = o;
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride) {
    out[i] = mix(ck, kept[i], cr, received[i]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// (a.b, a.a, b.b) of two float32 vectors of n elements into out[0..2] on
// the card; scratch holds 3 * 1024 floats.  Returns the launch's CUDA error.
extern "C" int hvd_adasum_dots(const void* a, const void* b, long long n,
                               void* scratch, void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(a) && aligned16(b);
  int nblocks = 0;
  if (n > 0) {
    nblocks = blocks_for(vec ? (n >> 2) + (n & 3) : n);
    dots_partial_kernel<<<nblocks, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), n, vec,
        static_cast<float*>(scratch));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dots_final_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(scratch), nblocks, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// out = ck * kept + cr * received over n float32 elements, the
// coefficients from the summed triple (ab, aa, bb) on the card.
extern "C" int hvd_adasum_combine(const void* kept, const void* received,
                                  const void* triple, int is_low, double eps,
                                  void* out, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(kept) && aligned16(received) && aligned16(out);
  combine_kernel<<<blocks_for(vec ? (n >> 2) + (n & 3) : n), kThreads, 0,
                   st>>>(
      static_cast<const float*>(kept), static_cast<const float*>(received),
      static_cast<const float*>(triple), is_low, static_cast<float>(eps),
      static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}
