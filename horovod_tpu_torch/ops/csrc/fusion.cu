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
// T is the tensors' dtype (float32, float64, bfloat16, float16, int8, uint8,
// int32, int64; bool and int16 as sources of a widening) and W the buffer's
// (T, bfloat16/float16 as the wire dtype of a float group, or int32 where
// the reduction counts bool or multiplies small integers wider and where
// int16 travels, NCCL having no int16).  avg is the identity, a division
// by n in W (Average), or floor division for integers, after the cast to
// an integer T (an int32 sum narrowed to int16 wraps first, as the JAX
// program's int16 sum does); an integer W into a float32 T divides in
// float32 after the cast (a reducescatter's Average), an int32 W of int16
// sums after narrowing to int16 (kNarrowDivide: the int16 sum's wrap).
// Integers scale in float32 and are cast back, truncating; float64
// computes in double.  Each rounding is where the JAX program rounds
// (collectives.py:61-68, engine.py:1989-2010), so
// bf16-in/bf16-out and integer results are bitwise those of the plain
// PyTorch versions in ops/fusion.py: a bf16 or fp16 product of two values of
// its own type is exact in float32 and is rounded once; a division is an
// IEEE division in W's precision rounded once to W; a double goes to bf16 or
// fp16 through float, as PyTorch converts it.  A group with no arithmetic
// (every broadcast, and an allreduce's pack without factors or wire cast)
// takes hvd_fusion_copy instead: bytes, for any dtype.
//
// Bound on an H100 SXM: bytes, read once and written once, at 3.35 TB/s.
// For the training configuration's 39 bf16 gradients (1.135 G elements)
// with a bf16 buffer, 2.27 GB in and 2.27 GB out: 1.36 ms each kernel.
// chip_smoke.py recomputes it from the shapes it runs.
//
// Why the first design (one scalar element per thread per iteration, a
// grid-stride loop with a binary search on each tensor change) reached half
// of that: by Little's law the bytes in flight must cover the rate times the
// latency.  8 blocks of 256 threads an SM, each with one 2-byte load
// outstanding, keep ~4 KB of reads in flight per SM, ~540 KB on the card;
// at a loaded HBM latency near 0.7 us that caps reads near 0.8 TB/s, which
// is what it measured (0.81 TB/s of reads, 1.63 TB/s with the writes).
//
// Design now: bytes in flight, and no per-element bookkeeping.
//
// - The walk (hvd_fusion_pack, hvd_fusion_unpack, and hvd_fusion_copy when
//   some tensor is not 16-byte aligned).  Block b (256 threads, 128
//   registers a thread, 2 an SM) takes the buffer's chunk b of 128 KB of
//   loads, finds its first tensor with one binary search and walks the
//   following ones in order: no per-element search or range check.
//   Inside one tensor's part of a chunk: a scalar head up to the
//   destination's first 16-byte boundary, a body of 16-byte vector stores,
//   and a scalar tail.  The body's loads are 16-byte aligned too: where
//   the source sits at another 16-byte phase than the destination (dense
//   packing puts a tensor after an odd-sized one at any phase), each
//   vector loads one more aligned chunk and the bytes are funnel-shifted
//   into place.  A thread has up to 8 independent 16-byte loads in flight
//   (fewer where a vector is wider: a float32 source cast to bf16, a
//   funnel shift, int8 arithmetic), 64 KB an SM, 16 times the first
//   design's.
// - The bulk copies (hvd_fusion_copy when every tensor and its place in the
//   buffer start on a 16-byte boundary, as the allocator's tensors with
//   even byte sizes do: every broadcast of parameters, the gradients' pack
//   without factors).  Block b, one warp, moves the buffer's 32 KB chunk b
//   global -> shared -> global with cp.async.bulk, issued by one thread:
//   no registers held and no per-element work at all.
//
// A block a chunk, not a persistent grid: blocks that each walk chunks b,
// b + G, b + 2 G, ... measured slower on the card, in both designs.
//
// chip_smoke.py E1 times both beside a one-tensor copy_ of the same bytes
// (the card's own device-to-device copy).  What they still leave: a pass
// each over the gradients and the updated parameters, which fusing pack
// into the gradient's producer, or unpack into the optimizer's update,
// would remove.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

enum Dtype : int {
  kF32 = 0, kBF16 = 1, kF16 = 2, kI32 = 3, kI64 = 4, kF64 = 5, kI8 = 6,
  kU8 = 7, kBool = 8, kI16 = 9
};
enum Avg : int {
  kNone = 0, kDivide = 1, kFloorDivide = 2, kNarrowDivide = 3
};

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;          // register budget: 128 a thread

// The precision a dtype computes in: double for float64, float otherwise.
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }

// float or double -> T, rounding to nearest even (a double reaches bf16 or
// fp16 through float, as PyTorch converts).
template <typename T, typename A>
__device__ __forceinline__ T from_acc(A x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(static_cast<float>(x));
  } else if constexpr (std::is_same_v<T, __half>) {
    return __float2half_rn(static_cast<float>(x));
  } else {
    return static_cast<T>(x);
  }
}

template <typename T>
__device__ __forceinline__ T floor_div(T a, T n) {
  const T q = a / n;
  if constexpr (std::is_signed_v<T>) {
    return (a % n != 0 && ((a < 0) != (n < 0))) ? q - 1 : q;
  } else {
    return q;
  }
}

// buf = W(round_T(x * f)), f already rounded to T on the host.
template <typename T, typename W>
struct PackOp {
  using Src = T;
  using Dst = W;
  static constexpr bool kIdentity = false;
  int scale;
  typename Acc<T>::type f;
  __device__ __forceinline__ W operator()(T x) const {
    if constexpr (std::is_integral_v<T>) {
      return scale ? static_cast<T>(static_cast<float>(x) * f) : x;
    } else {
      auto v = to_acc(x);
      if (scale) v = to_acc(from_acc<T>(v * f));
      return from_acc<W>(v);
    }
  }
};

// out = round_T(T(avg_W(b)) * f), f already rounded to T on the host.
template <typename W, typename T>
struct UnpackOp {
  using Src = W;
  using Dst = T;
  static constexpr bool kIdentity = false;
  int avg, n, scale;
  typename Acc<T>::type f;
  __device__ __forceinline__ T operator()(W b) const {
    if constexpr (std::is_integral_v<T>) {
      const T c = static_cast<T>(b);
      const T v = avg == kFloorDivide ? floor_div<T>(c, static_cast<T>(n)) : c;
      return scale ? static_cast<T>(static_cast<float>(v) * f) : v;
    } else if constexpr (std::is_integral_v<W>) {
      float v = static_cast<float>(b);
      bool divide = avg == kDivide;
      if constexpr (std::is_same_v<W, int32_t>) {
        // kNarrowDivide: an int32 sum of int16 values wraps to int16 first.
        if (avg == kNarrowDivide) {
          v = static_cast<float>(static_cast<int16_t>(b));
          divide = true;
        }
      }
      if (divide) v = v / static_cast<float>(n);
      T t = from_acc<T>(v);
      if (scale) t = from_acc<T>(to_acc(t) * f);
      return t;
    } else {
      using AW = typename Acc<W>::type;
      AW v = to_acc(b);
      if (avg == kDivide) v = to_acc(from_acc<W>(v / static_cast<AW>(n)));
      T t = from_acc<T>(v);
      if (scale) t = from_acc<T>(to_acc(t) * f);
      return t;
    }
  }
};

// The byte path: no arithmetic, any dtype.
struct CopyOp {
  using Src = uint8_t;
  using Dst = uint8_t;
  static constexpr bool kIdentity = true;
  __device__ __forceinline__ uint8_t operator()(uint8_t x) const { return x; }
};

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

// f(j, a, b) for each tensor j's part [a, b) of the buffer range [lo, hi),
// lo < total: one binary search for the first, then forward.
template <class F>
__device__ __forceinline__ void for_segments(const long long* offs, int n,
                                             long long lo, long long hi,
                                             F f) {
  for (int j = find_tensor(offs, n, lo); j < n && offs[j] < hi; ++j) {
    const long long a = lo > offs[j] ? lo : offs[j];
    const long long b = hi < offs[j + 1] ? hi : offs[j + 1];
    if (a < b) f(j, a, b);
  }
}

// The 16 K bytes that start 4 Q + r / 8 bytes (1..15) into the K + 1
// aligned chunks c, as 4 K words: word m is bytes [4 (m + Q) + r / 8, ...).
template <int K, int Q>
__device__ __forceinline__ void realign(const uint4 (&c)[K + 1], int r,
                                        uint32_t (&w)[4 * K]) {
  uint32_t x[4 * (K + 1)];
#pragma unroll
  for (int k = 0; k <= K; ++k) {
    x[4 * k] = c[k].x;
    x[4 * k + 1] = c[k].y;
    x[4 * k + 2] = c[k].z;
    x[4 * k + 3] = c[k].w;
  }
#pragma unroll
  for (int m = 0; m < 4 * K; ++m) {
    w[m] = __funnelshift_r(x[m + Q], x[m + Q + 1], r);
  }
}

// V elements a vector: 16 bytes of the narrower side; the wider side of a
// cast takes KS (source) or KD (destination) chunks of 16 bytes.  A block
// takes a chunk of kChunk elements of the buffer: 128 KB of loads.
template <class Op>
struct Vec {
  using S = typename Op::Src;
  using D = typename Op::Dst;
  static constexpr int V = 16 / (sizeof(S) < sizeof(D) ? sizeof(S)
                                                       : sizeof(D));
  static constexpr int KS = V * sizeof(S) / 16;
  static constexpr int KD = V * sizeof(D) / 16;
  static constexpr int kChunk = 32 / KS * kThreads * V;   // elements
};

// nvec vectors from src to dst (16-byte aligned).  Q < 0: src is 16-byte
// aligned too; else it lies `shift` = 4 Q + 0..3 bytes past a 16-byte
// boundary, and each vector loads one more aligned chunk and shifts.
template <class Op, int Q>
__device__ __forceinline__ void body(const char* src, char* dst, int nvec,
                                     int shift, const Op& op) {
  using VT = Vec<Op>;
  using S = typename VT::S;
  using D = typename VT::D;
  constexpr int V = VT::V, KS = VT::KS, KD = VT::KD;
  // NL aligned 16-byte loads a vector, and U vectors a thread in flight:
  // 8, fewer where a vector takes more than one load or store (at most 32
  // registers of loads a round) or 16 conversions, so nothing spills.
  constexpr int NL = KS + (Q >= 0 ? 1 : 0);
  constexpr int W = (NL > KD ? NL : KD) * (Op::kIdentity || V < 16 ? 1 : 2);
  constexpr int U = W == 1 ? 8 : W == 2 ? 4 : W <= 4 ? 2 : 1;
  const uint4* s4 = reinterpret_cast<const uint4*>(src - shift);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const int r = (shift & 3) * 8;
  for (int v0 = threadIdx.x; v0 < nvec; v0 += U * kThreads) {
    uint4 c[U][NL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nvec) {
#pragma unroll
        for (int k = 0; k < NL; ++k) c[u][k] = s4[v * KS + k];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * kThreads;
      if (v >= nvec) continue;
      uint32_t w[4 * KS];
      if constexpr (Q >= 0) {
        realign<KS, Q>(c[u], r, w);
      } else {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          w[4 * k] = c[u][k].x;
          w[4 * k + 1] = c[u][k].y;
          w[4 * k + 2] = c[u][k].z;
          w[4 * k + 3] = c[u][k].w;
        }
      }
      uint4 o[KD];
      if constexpr (Op::kIdentity) {
        memcpy(o, w, sizeof(o));
      } else {
        S se[V];
        D de[V];
        memcpy(se, w, sizeof(se));
#pragma unroll
        for (int e = 0; e < V; ++e) de[e] = op(se[e]);
        memcpy(o, de, sizeof(o));
      }
#pragma unroll
      for (int k = 0; k < KD; ++k) d4[v * KD + k] = o[k];
    }
  }
}

// One tensor's part of a chunk: len elements from src to dst.
template <class Op>
__device__ __forceinline__ void segment(const typename Op::Src* src,
                                        typename Op::Dst* dst, int len,
                                        const Op& op) {
  using D = typename Op::Dst;
  constexpr int V = Vec<Op>::V;
  const int tid = threadIdx.x;
  // Scalar head, up to the destination's first 16-byte boundary.
  int h = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) &
                            15) / sizeof(D));
  if (h > len) h = len;
  if (tid < h) dst[tid] = op(src[tid]);
  src += h;
  dst += h;
  len -= h;
  const int nvec = len / V;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  switch (shift == 0 ? -1 : shift >> 2) {
    case -1: body<Op, -1>(s, d, nvec, 0, op); break;
    case 0: body<Op, 0>(s, d, nvec, shift, op); break;
    case 1: body<Op, 1>(s, d, nvec, shift, op); break;
    case 2: body<Op, 2>(s, d, nvec, shift, op); break;
    default: body<Op, 3>(s, d, nvec, shift, op); break;
  }
  // Scalar tail.
  const int done = nvec * V;
  if (tid < len - done) dst[done + tid] = op(src[done + tid]);
}

// The buffer in chunks of kChunk elements, block b the chunk b.  kPack:
// the tensors are the sources and the buffer the destination; else the
// reverse.  table: n pointers, then n + 1 offsets into the buffer.
template <class Op, bool kPack>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
walk_kernel(const long long* __restrict__ table, int n, long long total,
            void* buf, Op op) {
  using S = typename Op::Src;
  using D = typename Op::Dst;
  constexpr int kChunk = Vec<Op>::kChunk;
  const long long* offs = table + n;
  const long long lo = static_cast<long long>(blockIdx.x) * kChunk;
  if (lo >= total) return;   // an all-empty batch still launches one block
  const long long hi = lo + kChunk < total ? lo + kChunk : total;
  for_segments(offs, n, lo, hi, [&](int j, long long a, long long b) {
    void* t = reinterpret_cast<void*>(table[j]);
    const int len = static_cast<int>(b - a);
    if constexpr (kPack) {
      segment(static_cast<const S*>(t) + (a - offs[j]),
              static_cast<D*>(buf) + a, len, op);
    } else {
      segment(static_cast<const S*>(buf) + a,
              static_cast<D*>(t) + (a - offs[j]), len, op);
    }
  });
}

// ---------------------------------------------------------- bulk copies
// Hopper's bulk asynchronous copies (the TMA engine without a tensor map):
// global -> shared completes on an mbarrier, shared -> global in groups.
__device__ __forceinline__ void bulk_load(void* smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(smem)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* smem,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(hopper::smem_u32(smem)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order what the mbarrier made visible before the next asynchronous copy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kBulkBytes = 32768;   // a block's chunk of the buffer

// The byte path when every tensor, and its place in the buffer, starts on
// a 16-byte boundary (the host checks): block b, one warp, copies the
// buffer's chunk b, its tensors' parts loaded into shared memory by bulk
// copies that complete on one mbarrier, then stored back by bulk copies,
// all issued by one thread: no registers held, no per-element work, and
// the blocks an SM holds (32 KB of shared memory each) keep ~200 KB of
// loads in flight.  table and offs are in BYTES.  The last total % 16
// bytes, the end of the last tensor, are copied by the first block's
// lanes.
template <bool kPack>
__global__ void __launch_bounds__(32)
bulk_kernel(const long long* __restrict__ table, int n, long long total,
            char* buf) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ uint64_t full;
  const long long* offs = table + n;
  const long long body = total & ~15LL;
  const long long lo = static_cast<long long>(blockIdx.x) * kBulkBytes;
  if (threadIdx.x == 0 && lo < body) {
    const long long hi = lo + kBulkBytes < body ? lo + kBulkBytes : body;
    hopper::mbar_init(&full, 1);
    hopper::mbar_fence_init();
    hopper::mbar_arrive_tx(&full, static_cast<uint32_t>(hi - lo));
    for_segments(offs, n, lo, hi, [&](int j, long long a, long long b) {
      const char* src = kPack
          ? reinterpret_cast<const char*>(table[j]) + (a - offs[j])
          : buf + a;
      bulk_load(stage + (a - lo), src, static_cast<uint32_t>(b - a), &full);
    });
    hopper::mbar_wait(&full, 0);
    fence_proxy_async();
    for_segments(offs, n, lo, hi, [&](int j, long long a, long long b) {
      char* dst = kPack ? buf + a
                        : reinterpret_cast<char*>(table[j]) + (a - offs[j]);
      bulk_store(dst, stage + (a - lo), static_cast<uint32_t>(b - a));
    });
    bulk_commit();
    bulk_wait_all();
  }
  if (blockIdx.x == 0 && threadIdx.x < total - body) {
    const long long g = body + threadIdx.x;
    char* t = reinterpret_cast<char*>(table[n - 1]) + (g - offs[n - 1]);
    if constexpr (kPack) buf[g] = *t; else *t = buf[g];
  }
}

// A block a chunk, at least one (an all-empty batch still launches).
template <class Op, bool kPack>
cudaError_t launch(const long long* table, int n, long long total, void* buf,
                   const Op& op, cudaStream_t st) {
  long long blocks = (total + Vec<Op>::kChunk - 1) / Vec<Op>::kChunk;
  if (blocks < 1) blocks = 1;
  walk_kernel<Op, kPack><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      table, n, total, buf, op);
  return cudaGetLastError();
}

// A block a 32 KB chunk (within the default 48 KB of shared memory), at
// least one (for the tail).
template <bool kPack>
cudaError_t launch_bulk(const long long* table, int n, long long total,
                        void* buf, cudaStream_t st) {
  long long blocks = ((total & ~15LL) + kBulkBytes - 1) / kBulkBytes;
  if (blocks < 1) blocks = 1;
  bulk_kernel<kPack><<<static_cast<unsigned>(blocks), 32, kBulkBytes, st>>>(
      table, n, total, static_cast<char*>(buf));
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_pack(const long long* table, int n, long long total,
                        void* buf, int scale, double f, cudaStream_t st) {
  PackOp<T, W> op{scale, static_cast<typename Acc<T>::type>(f)};
  return launch<PackOp<T, W>, true>(table, n, total, buf, op, st);
}

template <typename W, typename T>
cudaError_t launch_unpack(const long long* table, int n, long long total,
                          void* buf, int avg, int divisor, int scale,
                          double f, cudaStream_t st) {
  UnpackOp<W, T> op{avg, divisor, scale,
                    static_cast<typename Acc<T>::type>(f)};
  return launch<UnpackOp<W, T>, false>(table, n, total, buf, op, st);
}

}  // namespace

#define HVD_PAIR(a, b) ((a) * 16 + (b))

// table: device int64 [2n + 1] = n source pointers, then n + 1 element
// offsets into buf (offs[0] = 0, offs[n] = total).  dtypes by Dtype code.
extern "C" int hvd_fusion_pack(const void* table, int n, long long total,
                               void* buf, int src_dtype, int buf_dtype,
                               int scale, double factor, void* stream) {
  if (n <= 0 || total < 0) return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_PACK(a, b, T, W) \
  case HVD_PAIR(a, b):       \
    return (int)launch_pack<T, W>(t, n, total, buf, scale, factor, st);
  switch (HVD_PAIR(src_dtype, buf_dtype)) {
    HVD_PACK(kF32, kF32, float, float)
    HVD_PACK(kF32, kBF16, float, __nv_bfloat16)
    HVD_PACK(kF32, kF16, float, __half)
    HVD_PACK(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
    HVD_PACK(kBF16, kF16, __nv_bfloat16, __half)
    HVD_PACK(kF16, kF16, __half, __half)
    HVD_PACK(kF16, kBF16, __half, __nv_bfloat16)
    HVD_PACK(kF64, kF64, double, double)
    HVD_PACK(kF64, kBF16, double, __nv_bfloat16)
    HVD_PACK(kF64, kF16, double, __half)
    HVD_PACK(kI8, kI8, int8_t, int8_t)
    HVD_PACK(kU8, kU8, uint8_t, uint8_t)
    HVD_PACK(kI32, kI32, int32_t, int32_t)
    HVD_PACK(kI64, kI64, long long, long long)
    HVD_PACK(kBool, kI32, bool, int32_t)
    HVD_PACK(kI8, kI32, int8_t, int32_t)
    HVD_PACK(kU8, kI32, uint8_t, int32_t)
    HVD_PACK(kI16, kI32, int16_t, int32_t)
  }
#undef HVD_PACK
  return (int)cudaErrorInvalidValue;
}

// table: device int64 [2n + 1] = n output pointers, then n + 1 offsets.
// avg: 0 none, 1 divide by divisor in the buffer's dtype, 2 floor divide,
// 3 narrow an int32 buffer to int16, then divide in float32.
extern "C" int hvd_fusion_unpack(const void* table, int n, long long total,
                                 void* buf, int buf_dtype, int out_dtype,
                                 int avg, int divisor, int scale,
                                 double factor, void* stream) {
  if (n <= 0 || total < 0 || divisor <= 0) return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_UNPACK(a, b, W, T)                                             \
  case HVD_PAIR(a, b):                                                     \
    return (int)launch_unpack<W, T>(t, n, total, buf, avg, divisor, scale, \
                                    factor, st);
  switch (HVD_PAIR(buf_dtype, out_dtype)) {
    HVD_UNPACK(kF32, kF32, float, float)
    HVD_UNPACK(kBF16, kF32, __nv_bfloat16, float)
    HVD_UNPACK(kF16, kF32, __half, float)
    HVD_UNPACK(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16)
    HVD_UNPACK(kF16, kBF16, __half, __nv_bfloat16)
    HVD_UNPACK(kF16, kF16, __half, __half)
    HVD_UNPACK(kBF16, kF16, __nv_bfloat16, __half)
    HVD_UNPACK(kF64, kF64, double, double)
    HVD_UNPACK(kBF16, kF64, __nv_bfloat16, double)
    HVD_UNPACK(kF16, kF64, __half, double)
    HVD_UNPACK(kI8, kI8, int8_t, int8_t)
    HVD_UNPACK(kU8, kU8, uint8_t, uint8_t)
    HVD_UNPACK(kI32, kI32, int32_t, int32_t)
    HVD_UNPACK(kI64, kI64, long long, long long)
    HVD_UNPACK(kI32, kI16, int32_t, int16_t)
    HVD_UNPACK(kI8, kF32, int8_t, float)
    HVD_UNPACK(kU8, kF32, uint8_t, float)
    HVD_UNPACK(kI32, kF32, int32_t, float)
    HVD_UNPACK(kI64, kF32, long long, float)
  }
#undef HVD_UNPACK
  return (int)cudaErrorInvalidValue;
}

// The byte path of both: table = n tensor pointers, then n + 1 BYTE
// offsets into buf (offs[n] = total bytes).  to_buffer: 1 pack, 0 unpack.
// aligned: buf, every non-empty tensor and offs[0..n-1] are multiples of
// 16 bytes, so the bulk copies carry it.
extern "C" int hvd_fusion_copy(const void* table, int n, long long total,
                               void* buf, int to_buffer, int aligned,
                               void* stream) {
  if (n <= 0 || total < 0) return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned) {
    return (int)(to_buffer ? launch_bulk<true>(t, n, total, buf, st)
                           : launch_bulk<false>(t, n, total, buf, st));
  }
  return (int)(to_buffer ? launch<CopyOp, true>(t, n, total, buf, CopyOp{}, st)
                         : launch<CopyOp, false>(t, n, total, buf, CopyOp{},
                                                 st));
}
