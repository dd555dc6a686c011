// Multi-tensor pack and unpack around one fused collective, for Hopper
// (sm_90a), bound through a plain C interface and loaded with ctypes
// (horovod_tpu_torch/ops/_build.py).
//
// No Pallas counterpart.  The JAX package never needed these kernels: its
// fused collective is one jitted XLA program (horovod_tpu/ops/engine.py
// _build_fused_reduce, :1955-2026: flatten -> concat per dtype -> prescale
// -> wire cast -> reduce -> cast back -> postscale -> split), and XLA fused
// the work on either side of the reduction into that program.  Here NCCL
// runs the reduction, so the work on either side is two kernels, one
// launch each per (fused batch, dtype group):
//
//   hvd_fusion_pack:    buf[off_i + j] = W(round_T(x_i[j] * round_T(pre)))
//   hvd_fusion_unpack:  out_i[j] = round_T(T(avg_W(buf[off_i + j]))
//                                          * round_T(post))
//
// T is the tensors' dtype (float32, bfloat16, float16, int32, int64) and W
// the buffer's (T, or bfloat16/float16 as the wire dtype of a float group).
// avg is the identity, a division by n in W (Average), or floor division
// for integers.  Integers scale in float32 and are cast back, truncating.
// Each rounding is where the JAX program rounds (collectives.py:61-68,
// engine.py:1989-2010), so bf16-in/bf16-out and integer results are
// bitwise those of the plain PyTorch versions in ops/fusion.py: a bf16 or
// fp16 product of two values of its own type is exact in float32 and is
// rounded once; a division is an IEEE float32 division rounded once to W.
//
// Design: simple first.  A grid-stride loop over the batch's elements; the
// element's tensor is found by binary search over the batch's 64-bit
// offsets (a table on the device: N tensor pointers, then N + 1 offsets),
// searched again only when the loop crosses into another tensor.
// Offsets and counts are 64-bit: a training gradient set at Llama-3-8B
// width is 2.27 GB, past 2^31 bytes.  Scalar loads and stores, one element
// an iteration; any alignment of the tensors' bases is taken.
//
// Bound on an H100 SXM: bytes, read once and written once, at 3.35 TB/s.
// For the training configuration's 39 bf16 gradients (1.135 G elements)
// with a bf16 buffer, 2.27 GB in and 2.27 GB out: 1.36 ms each kernel.
// chip_smoke.py recomputes it from the shapes it runs.
//
// What the simple design leaves on the table: 16-byte vectorised accesses
// (a warp moves 64 B a bf16 load here), a persistent launch that walks the
// tensors in order instead of searching, and fusing pack into the producer
// of the last gradient or unpack into the optimizer's update.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI32 = 3, kI64 = 4 };
enum Avg : int { kNone = 0, kDivide = 1, kFloorDivide = 2 };

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// float -> T, round to nearest even.
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
struct IsInt { static constexpr bool value = false; };
template <>
struct IsInt<int32_t> { static constexpr bool value = true; };
template <>
struct IsInt<long long> { static constexpr bool value = true; };

template <typename T>
__device__ __forceinline__ T floor_div(T a, T n) {
  T q = a / n;
  return (a % n != 0 && ((a < 0) != (n < 0))) ? q - 1 : q;
}

// W(round_T(x * f)), f already rounded to T on the host.
template <typename T, typename W>
__device__ __forceinline__ W pack_one(T x, int scale, float f) {
  if constexpr (IsInt<T>::value) {
    return scale ? static_cast<T>(static_cast<float>(x) * f) : x;
  } else {
    float v = to_float(x);
    if (scale) v = to_float(from_float<T>(v * f));
    return from_float<W>(v);
  }
}

// round_T(T(avg_W(b)) * f), f already rounded to T on the host.
template <typename W, typename T>
__device__ __forceinline__ T unpack_one(W b, int avg, int n, int scale,
                                        float f) {
  if constexpr (IsInt<T>::value) {
    T v = avg == kFloorDivide ? floor_div<T>(b, static_cast<T>(n)) : b;
    return scale ? static_cast<T>(static_cast<float>(v) * f) : v;
  } else {
    float v = to_float(b);
    if (avg == kDivide) v = to_float(from_float<W>(v / static_cast<float>(n)));
    T t = from_float<T>(v);
    if (scale) t = from_float<T>(to_float(t) * f);
    return t;
  }
}

// The last tensor i in [0, n) with offs[i] <= g (empty tensors share their
// neighbour's offset and are passed over).
__device__ __forceinline__ int find_tensor(const long long* offs, int n,
                                           long long g) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offs[mid] <= g) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const long long* __restrict__ table, int n, long long total,
            W* __restrict__ buf, int scale, float f) {
  const long long* offs = table + n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long lo = 0, hi = 0;
  const T* src = nullptr;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < total; g += stride) {
    if (g < lo || g >= hi) {
      const int i = find_tensor(offs, n, g);
      lo = offs[i];
      hi = offs[i + 1];
      src = reinterpret_cast<const T*>(table[i]);
    }
    buf[g] = pack_one<T, W>(src[g - lo], scale, f);
  }
}

template <typename W, typename T>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const long long* __restrict__ table, int n, long long total,
              const W* __restrict__ buf, int avg, int divisor, int scale,
              float f) {
  const long long* offs = table + n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long lo = 0, hi = 0;
  T* dst = nullptr;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < total; g += stride) {
    if (g < lo || g >= hi) {
      const int i = find_tensor(offs, n, g);
      lo = offs[i];
      hi = offs[i + 1];
      dst = reinterpret_cast<T*>(table[i]);
    }
    dst[g - lo] = unpack_one<W, T>(buf[g], avg, divisor, scale, f);
  }
}

// Enough blocks to fill the card (8 of 256 threads an SM), fewer for a
// small batch; at least one, so that an all-empty batch still launches.
int grid_for(long long total) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long want = (total + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename T, typename W>
cudaError_t launch_pack(const long long* table, int n, long long total,
                        void* buf, int scale, float f, cudaStream_t st) {
  pack_kernel<T, W><<<grid_for(total), kThreads, 0, st>>>(
      table, n, total, static_cast<W*>(buf), scale, f);
  return cudaGetLastError();
}

template <typename W, typename T>
cudaError_t launch_unpack(const long long* table, int n, long long total,
                          const void* buf, int avg, int divisor, int scale,
                          float f, cudaStream_t st) {
  unpack_kernel<W, T><<<grid_for(total), kThreads, 0, st>>>(
      table, n, total, static_cast<const W*>(buf), avg, divisor, scale, f);
  return cudaGetLastError();
}

}  // namespace

// table: device int64 [2n + 1] = n source pointers, then n + 1 element
// offsets into buf (offs[0] = 0, offs[n] = total).  dtypes by Dtype code.
extern "C" int hvd_fusion_pack(const void* table, int n, long long total,
                               void* buf, int src_dtype, int buf_dtype,
                               int scale, float factor, void* stream) {
  if (n <= 0 || total < 0) return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_dtype * 10 + buf_dtype) {
    case kF32 * 10 + kF32:
      return (int)launch_pack<float, float>(t, n, total, buf, scale, factor, st);
    case kF32 * 10 + kBF16:
      return (int)launch_pack<float, __nv_bfloat16>(t, n, total, buf, scale,
                                                    factor, st);
    case kF32 * 10 + kF16:
      return (int)launch_pack<float, __half>(t, n, total, buf, scale, factor,
                                             st);
    case kBF16 * 10 + kBF16:
      return (int)launch_pack<__nv_bfloat16, __nv_bfloat16>(
          t, n, total, buf, scale, factor, st);
    case kBF16 * 10 + kF16:
      return (int)launch_pack<__nv_bfloat16, __half>(t, n, total, buf, scale,
                                                     factor, st);
    case kF16 * 10 + kF16:
      return (int)launch_pack<__half, __half>(t, n, total, buf, scale, factor,
                                              st);
    case kF16 * 10 + kBF16:
      return (int)launch_pack<__half, __nv_bfloat16>(t, n, total, buf, scale,
                                                     factor, st);
    case kI32 * 10 + kI32:
      return (int)launch_pack<int32_t, int32_t>(t, n, total, buf, scale,
                                                factor, st);
    case kI64 * 10 + kI64:
      return (int)launch_pack<long long, long long>(t, n, total, buf, scale,
                                                    factor, st);
  }
  return (int)cudaErrorInvalidValue;
}

// table: device int64 [2n + 1] = n output pointers, then n + 1 offsets.
// avg: 0 none, 1 divide by divisor in the buffer's dtype, 2 floor divide.
extern "C" int hvd_fusion_unpack(const void* table, int n, long long total,
                                 const void* buf, int buf_dtype, int out_dtype,
                                 int avg, int divisor, int scale, float factor,
                                 void* stream) {
  if (n <= 0 || total < 0 || divisor <= 0) return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (buf_dtype * 10 + out_dtype) {
    case kF32 * 10 + kF32:
      return (int)launch_unpack<float, float>(t, n, total, buf, avg, divisor,
                                              scale, factor, st);
    case kBF16 * 10 + kF32:
      return (int)launch_unpack<__nv_bfloat16, float>(
          t, n, total, buf, avg, divisor, scale, factor, st);
    case kF16 * 10 + kF32:
      return (int)launch_unpack<__half, float>(t, n, total, buf, avg, divisor,
                                               scale, factor, st);
    case kBF16 * 10 + kBF16:
      return (int)launch_unpack<__nv_bfloat16, __nv_bfloat16>(
          t, n, total, buf, avg, divisor, scale, factor, st);
    case kF16 * 10 + kBF16:
      return (int)launch_unpack<__half, __nv_bfloat16>(
          t, n, total, buf, avg, divisor, scale, factor, st);
    case kF16 * 10 + kF16:
      return (int)launch_unpack<__half, __half>(t, n, total, buf, avg, divisor,
                                                scale, factor, st);
    case kBF16 * 10 + kF16:
      return (int)launch_unpack<__nv_bfloat16, __half>(
          t, n, total, buf, avg, divisor, scale, factor, st);
    case kI32 * 10 + kI32:
      return (int)launch_unpack<int32_t, int32_t>(t, n, total, buf, avg,
                                                  divisor, scale, factor, st);
    case kI64 * 10 + kI64:
      return (int)launch_unpack<long long, long long>(
          t, n, total, buf, avg, divisor, scale, factor, st);
  }
  return (int)cudaErrorInvalidValue;
}
