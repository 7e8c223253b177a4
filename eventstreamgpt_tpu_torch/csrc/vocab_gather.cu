// Last-axis gather from the regression projection plane and its backward
// (kernel C).
//
// Replaces the TPU kernel eventstreamgpt_tpu/ops/pallas_heads.py::vocab_gather
// (_fwd_kernel / _bwd_kernel under a custom_vjp):
//
//   forward   out[r, m] = float(z[r, ci[r, m]]), and 0 where ci[r, m] is
//             outside [0, V);
//   backward  dz[r, v] = cast(sum over m with ci[r, m] == v of g[r, m]), the
//             sum taken in fp32, then cast to z's type; out-of-range indices
//             receive nothing.
//
// Design. The TPU kernel factors each index into (index / 128, index % 128)
// and contracts one-hot planes on the MXU, over rows padded to 32 and lanes
// padded to 128. None of that carries over: the card gathers and scatters
// natively.
//
// * Forward: one thread per output element, a bounds test and one load. The
//   function moves the index plane, the output and the gathered elements,
//   about 3.9 MB at the training shape (rows 8192, V 7000 bf16, M 48), about
//   1.2 us at 3.35 TB/s; the launch costs more than that.
// * Backward: one block per (row, column tile). The block stages the row's M
//   indices and cotangents in shared memory, zeroes an fp32 accumulator for
//   its tile in shared memory, and then slot m, if it is the first slot of
//   its index, sums the cotangents of every slot with that index in
//   ascending slot order and stores the sum: no atomics, so two runs are
//   bitwise equal and duplicates sum in the order the plain version (a
//   sequential scatter-add into an fp32 plane) sums them. The block then
//   writes its whole tile once, cast to z's type, with coalesced stores. The
//   function must write the whole dz plane (114.7 MB in bf16 at the training
//   shape) plus read g and ci (3.1 MB): about 35 us at 3.35 TB/s, and the
//   plane's write is the whole cost. A tile holds at most kMaxTile columns
//   (32 KB of fp32), so any V works; at V = 7000 a row is one tile. A row's
//   indices and cotangents are staged in shared memory when they fit
//   (M <= kMaxStaged); a longer row reads them from device memory in place,
//   so any M works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 8192;  // fp32 columns per block: 32 KB of shared memory
constexpr int kMaxStaged = 4096;  // slots staged per row: 32 KB of shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__global__ void gather_fwd(const T* __restrict__ z, const int32_t* __restrict__ ci, float* __restrict__ out,
                           int64_t rows, int V, int M) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * M) return;
  const int64_t r = i / M;
  const int c = ci[i];
  out[i] = (c >= 0 && c < V) ? to_f(z[r * V + c]) : 0.0f;
}

template <typename T>
__global__ void gather_bwd(const float* __restrict__ g, const int32_t* __restrict__ ci, T* __restrict__ dz,
                           int V, int M, int tile) {
  extern __shared__ unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [tile]
  const int64_t r = blockIdx.x;
  const int lo = blockIdx.y * tile;
  const int width = min(tile, V - lo);
  const int32_t* idx = ci + r * M;
  const float* grad = g + r * M;
  if (M <= kMaxStaged) {
    int32_t* s_idx = reinterpret_cast<int32_t*>(acc + tile);  // [M]
    float* s_grad = reinterpret_cast<float*>(s_idx + M);  // [M]
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      s_idx[m] = idx[m];
      s_grad[m] = grad[m];
    }
    idx = s_idx;
    grad = s_grad;
  }
  for (int j = threadIdx.x; j < width; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();

  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int c = idx[m];
    if (c < lo || c >= lo + width) continue;
    bool first = true;
    for (int k = 0; k < m && first; ++k) first = idx[k] != c;
    if (!first) continue;
    float s = 0.0f;
    for (int k = m; k < M; ++k)
      if (idx[k] == c) s += grad[k];
    acc[c - lo] = s;  // one writer per index
  }
  __syncthreads();

  T* row = dz + r * V + lo;
  for (int j = threadIdx.x; j < width; j += blockDim.x) row[j] = from_f<T>(acc[j]);
}

template <typename T>
int launch_fwd(const void* z, const void* ci, void* out, int64_t rows, int V, int M, void* stream) {
  const int64_t n = rows * M;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  gather_fwd<T><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const int32_t*>(ci), static_cast<float*>(out), rows, V, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* ci, void* dz, int64_t rows, int V, int M, void* stream) {
  if (rows == 0 || V == 0) return 0;
  const int tile = V < kMaxTile ? V : kMaxTile;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>((V + tile - 1) / tile));
  const size_t staged = M <= kMaxStaged ? static_cast<size_t>(M) : 0;
  const size_t smem = sizeof(float) * tile + (sizeof(int32_t) + sizeof(float)) * staged;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gather_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_bwd<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(ci), static_cast<T*>(dz), V, M, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 1 for a bf16 plane, 0 for fp32. Returns the CUDA error of the launch (0 on success).
extern "C" int esgpt_vocab_gather_fwd(int dtype, const void* z, const void* ci, void* out, long long rows, int V,
                                      int M, void* stream) {
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(z, ci, out, rows, V, M, stream);
  return launch_fwd<float>(z, ci, out, rows, V, M, stream);
}

extern "C" int esgpt_vocab_gather_bwd(int dtype, const void* g, const void* ci, void* dz, long long rows, int V,
                                      int M, void* stream) {
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(g, ci, dz, rows, V, M, stream);
  return launch_bwd<float>(g, ci, dz, rows, V, M, stream);
}
