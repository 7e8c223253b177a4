// Fused categorical sampling for the serving engine's decode tail (kernel A).
//
// Replaces the TPU kernel eventstreamgpt_tpu/ops/fused_sampling.py::
// fused_categorical (_sample_2d / _sample_kernel). Per row of a (rows, V)
// plane of logits z (fp32 or bf16, rows `z_stride` elements apart):
//
//   z'    = keep ? f32(z) : fp32 min                      (optional keep mask)
//   score = f32(round_to_T(f32(g) + z'))                  (noise first; RNE for bf16)
//   out   = the lowest index with score == max(score), V if the row holds a
//           NaN score, and `fill` for an inactive row      (optional active mask)
//
// The noise g comes from one of two places, the kernel's template argument:
//
// * from memory (esgpt_fused_categorical): the counterpart of JAX's
//   _sample_2d, held against it by the CPU tests through the plain version;
// * drawn in registers (esgpt_fused_categorical_stream) from the port's
//   counter hash, bit for bit what generation/sampling.py::RowStreams.uniform
//   and distributions.py::gumbel compute with ATen ops, cast to T:
//     row_key = mix32(mix32(mix32(seed) ^ counter) ^ draw_salt)
//     bits    = mix32(row_key + e * 0x9E3779B9)            (mod 2^32)
//     u       = ((bits >> 8) + 0.5) * 2^-24                 (fp32, each step rounded)
//     g       = -logf(-logf(u))
//   with e the element's flat index within its stream row's trailing shape.
//   The JAX package draws its noise outside its Pallas call because a kernel
//   cannot reproduce threefry; the port's generator is a 32-bit hash, so on
//   the card the noise is made where it is used, and a sampled categorical
//   head is one launch where the ATen ops took about a hundred. The source
//   is compiled without fast math (ops/build.py) and calls logf, libdevice's
//   log that ATen's own log kernel calls, not the approximate __logf.
//
// Bound: at the serving shape (32 rows of the 40-way event_type head, fp32
// logits in a 4,057-column plane) the function reads 5 KB of logits and
// 0.5 KB of seeds and counters and writes 128 bytes: a few nanoseconds at
// 3.35 TB/s (H100 SXM). A launch costs microseconds, so the design is about
// being one launch with nothing around it: no noise in memory, keep and
// active read as the 1-byte bools PyTorch stores (no conversion launch),
// strided rows read in place (no copy). One warp a row, four rows a block:
// each lane walks its columns, draws the noise and the score in registers
// and keeps a running (max, first index) pair and a NaN flag; five shuffle
// steps combine the pairs. Any V >= 1 and any number of rows. Measured 2.8
// us with the noise drawn inside, against 1.7-1.9 us for an empty kernel
// timed the same way (H100 80GB HBM3, 700 W; chip_smoke.py phase 3).
//
// esgpt_gumbel_noise writes the noise alone through the same device
// function (for the tests); esgpt_launch_floor launches an empty kernel,
// the floor beside which the launch-sized kernels' times are read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp a row
constexpr int kNoiseThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kTwoPowMinus24 = 5.9604644775390625e-8f;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// A stream row's key: the low 32 bits of its seed and counter, then the draw's salt.
__device__ __forceinline__ uint32_t row_key(int64_t seed, int64_t counter, uint32_t salt) {
  return mix32(mix32(mix32(static_cast<uint32_t>(seed)) ^ static_cast<uint32_t>(counter)) ^ salt);
}

// The Gumbel noise of element e of a stream row, in fp32, rounded step by
// step as ATen rounds `gumbel(stream)` (the _rn intrinsics are never
// contracted into an FMA).
__device__ __forceinline__ float gumbel_f32(uint32_t key, uint32_t e) {
  const uint32_t bits = mix32(key + e * kGolden);
  const float u = __fmul_rn(__fadd_rn(static_cast<float>(bits >> 8), 0.5f), kTwoPowMinus24);
  return -logf(-logf(u));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// An fp32 value rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Where the noise comes from: the (rows, V) plane `g`, or the stream row
// `row / inner` (seeds, counters, salt) at element (row % inner) * V + c.
struct Noise {
  const void* g;
  const int64_t* seeds;
  const int64_t* counters;
  uint32_t salt;
  int64_t inner;
};

template <typename T, bool kStream>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    sample_rows(const T* __restrict__ z, int64_t z_stride, Noise noise, const uint8_t* __restrict__ keep,
                const uint8_t* __restrict__ active, int32_t* __restrict__ out, int64_t rows, int V, int fill) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: a row is a warp's
  if (active != nullptr && active[row] == 0) {
    if (lane == 0) out[row] = fill;
    return;
  }
  const T* zr = z + row * z_stride;
  const uint8_t* kr = keep == nullptr ? nullptr : keep + row * V;
  uint32_t key = 0, base = 0;
  const T* gr = nullptr;
  if constexpr (kStream) {
    const int64_t s = row / noise.inner;
    key = row_key(noise.seeds[s], noise.counters[s], noise.salt);
    base = static_cast<uint32_t>((row - s * noise.inner) * V);  // mod 2^32, as the hash takes it
  } else {
    gr = static_cast<const T*>(noise.g) + row * V;
  }
  float best = -INFINITY;
  int idx = INT_MAX;  // no column seen yet
  bool nan = false;
  for (int c = lane; c < V; c += 32) {
    const float zc = (kr == nullptr || kr[c] != 0) ? to_f(zr[c]) : -FLT_MAX;
    float gc;
    if constexpr (kStream) {
      gc = round_to<T>(gumbel_f32(key, base + static_cast<uint32_t>(c)));
    } else {
      gc = to_f(gr[c]);
    }
    const float s = round_to<T>(__fadd_rn(gc, zc));
    if (s != s) {
      nan = true;
    } else if (s > best || idx == INT_MAX) {  // columns ascend: the first of a lane's maxima
      best = s;
      idx = c;
    }
  }
  nan = __any_sync(kAll, nan);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kAll, best, o);
    const int oi = __shfl_xor_sync(kAll, idx, o);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0) out[row] = nan ? V : idx;
}

// The noise alone, one element a thread, through gumbel_f32: (rows, V) of T.
template <typename T>
__global__ void gumbel_rows(Noise noise, T* __restrict__ out, int64_t rows, int V) {
  const int64_t n = rows * V;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / V, s = row / noise.inner;
    const uint32_t key = row_key(noise.seeds[s], noise.counters[s], noise.salt);
    const uint32_t e = static_cast<uint32_t>((row - s * noise.inner) * V + (i - row * V));
    out[i] = from_f<T>(gumbel_f32(key, e));
  }
}

__global__ void empty_kernel() {}

template <typename T, bool kStream>
int launch(const void* z, long long z_stride, Noise noise, const void* keep, const void* active, void* out,
           long long rows, int V, int fill, void* stream) {
  if (rows == 0) return 0;
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  sample_rows<T, kStream><<<static_cast<unsigned>(blocks), kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), z_stride, noise, static_cast<const uint8_t*>(keep),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(out), rows, V, fill);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_noise(Noise noise, void* out, long long rows, int V, void* stream) {
  const long long n = rows * V;
  if (n == 0) return 0;
  long long blocks = (n + kNoiseThreads - 1) / kNoiseThreads;
  if (blocks > 65535) blocks = 65535;
  gumbel_rows<T><<<static_cast<unsigned>(blocks), kNoiseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      noise, static_cast<T*>(out), rows, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 1 for bf16 logits (and noise), 0 for fp32. keep and active may be
// null. Each entry returns the CUDA error of the launch (0 on success).
extern "C" int esgpt_fused_categorical(int dtype, const void* z, long long z_stride, const void* g, const void* keep,
                                       const void* active, void* out, long long rows, int V, int fill, void* stream) {
  const Noise noise{g, nullptr, nullptr, 0u, 1};
  if (dtype == 1) return launch<__nv_bfloat16, false>(z, z_stride, noise, keep, active, out, rows, V, fill, stream);
  return launch<float, false>(z, z_stride, noise, keep, active, out, rows, V, fill, stream);
}

extern "C" int esgpt_fused_categorical_stream(int dtype, const void* z, long long z_stride, const void* seeds,
                                              const void* counters, unsigned salt, long long inner,
                                              const void* keep, const void* active, void* out, long long rows,
                                              int V, int fill, void* stream) {
  if (rows > 0 && inner < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Noise noise{nullptr, static_cast<const int64_t*>(seeds), static_cast<const int64_t*>(counters), salt, inner};
  if (dtype == 1) return launch<__nv_bfloat16, true>(z, z_stride, noise, keep, active, out, rows, V, fill, stream);
  return launch<float, true>(z, z_stride, noise, keep, active, out, rows, V, fill, stream);
}

extern "C" int esgpt_gumbel_noise(int dtype, const void* seeds, const void* counters, unsigned salt, long long inner,
                                  void* out, long long rows, int V, void* stream) {
  if (rows > 0 && inner < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Noise noise{nullptr, static_cast<const int64_t*>(seeds), static_cast<const int64_t*>(counters), salt, inner};
  if (dtype == 1) return launch_noise<__nv_bfloat16>(noise, out, rows, V, stream);
  return launch_noise<float>(noise, out, rows, V, stream);
}

extern "C" int esgpt_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
