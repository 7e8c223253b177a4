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
// * Forward: the function moves the index plane, the output and the
//   gathered elements, 3.46 MB at the training shape (rows 8192, V 7000
//   bf16, M 48): 1.03 us at 3.35 TB/s (H100 SXM). An empty kernel, timed the
//   same way back to back, takes 1.7-1.9 us on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py phase 5 prints it beside the kernel), and each thread's
//   gathers wait on its index load: two dependent round trips to memory.
//   So the kernel spends as little as it can around its loads: where M % 4
//   == 0, the index and output planes sit on 16-byte boundaries and
//   rows * M < 2^31, a thread takes four consecutive slots of one row: one
//   16-byte index load, its four gathers in flight together, one 16-byte
//   store, and one 32-bit division to find the row (98,304 threads at the
//   training shape: one wave of 384 blocks). Any other shape takes one slot
//   a thread (32-bit arithmetic where it fits, else 64-bit). Measured 3.2-3.3
//   us at the training shape, against 3.6 us for one slot a thread with a
//   64-bit division (same card, tools/ab_kernels.py --c-fwd).
// * Backward: bound by the dz plane's single write (114.7 MB in bf16 at the
//   training shape, plus 3.1 MB of g and ci read: about 35 us at
//   3.35 TB/s), so it spends nothing beyond that write and keeps no plane in
//   shared memory. A grid the card holds at once; block b takes a
//   contiguous run of rows, in groups of as many rows as it has warps (8).
//   A group's indices and cotangents are staged in shared memory by
//   cp.async while the group before it is worked on (a longer row, M >
//   kMaxStaged, is read in place, so any M works). Each warp marks one
//   row: it splits the row into 16-byte chunks on aligned addresses (8 bf16
//   or 4 fp32 columns), sets a bit for every chunk that holds an in-range
//   index (110 bytes at V = 7000 bf16), ranks the marked chunks by prefix
//   counts of the bitmap, and sums each column's cotangents into its
//   chunk's fp32 slot in ascending slot order: slots 32 at a time, and
//   within them the lowest slot of each column (__match_any_sync) adds its
//   group's cotangents in lane order. No atomics on the sums, so two runs
//   are bitwise equal and each sum is the one the plain version (a
//   sequential scatter-add into an fp32 plane) takes. Then the whole block
//   writes the group's rows in order, every chunk once with one 16-byte
//   store: zeros, or the marked chunk's sums cast to T. Columns before the
//   first and after the last aligned chunk take scalar stores, so any V and
//   any row start work. The stores stream (st.global.cs): the plane is
//   larger than the 50 MB L2, so the Dense backward that reads it next does
//   not find it there anyway, and they measured faster than plain stores.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // forward
constexpr int kMaxWarps = 8;         // backward: rows a block holds at once, one a warp
constexpr int kSmemTarget = 64 * 1024;  // backward: fewer warps a block above this much shared memory
constexpr int kMaxStaged = 128;      // slots staged per row (1 KB of shared memory a warp)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// One gathered slot: the plane's element, upcast, or 0 out of range (no load).
template <typename T>
__device__ __forceinline__ float gather_one(const T* __restrict__ row, int c, int V) {
  return (c >= 0 && c < V) ? to_f(row[c]) : 0.0f;
}

// Four consecutive slots of one row a thread (M % 4 == 0, aligned planes, rows * M < 2^31).
template <typename T>
__global__ void gather_fwd4(const T* __restrict__ z, const int4* __restrict__ ci, float4* __restrict__ out, int quads,
                            int V, int M) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  const int4 c = ci[q];
  const T* row = z + static_cast<int64_t>(q * 4 / M) * V;
  out[q] = make_float4(gather_one(row, c.x, V), gather_one(row, c.y, V), gather_one(row, c.z, V),
                       gather_one(row, c.w, V));
}

// One slot a thread, any shape; Index is int where rows * M fits, else int64_t.
template <typename T, typename Index>
__global__ void gather_fwd1(const T* __restrict__ z, const int32_t* __restrict__ ci, float* __restrict__ out, Index n,
                            int V, int M) {
  const Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = gather_one(z + static_cast<int64_t>(i / M) * V, ci[i], V);
}

// The fp32 sum of g over the slots of `idx` equal to `col`, in ascending slot order.
__device__ __forceinline__ float column_sum(const int32_t* idx, const float* grad, int M, int col) {
  float s = 0.0f;
  for (int k = 0; k < M; ++k)
    if (idx[k] == col) s += grad[k];
  return s;
}

// Shared memory of the backward, in 4-byte words: per row of a group, the
// chunk bitmap, its prefix counts and the marked chunks' sums; then two
// buffers of a group's indices and cotangents (when M <= kMaxStaged).
__host__ __device__ inline int row_words(int V, int M, int per) {
  const int words = (V / per + 31) / 32;  // chunk bits a row needs, at any row alignment
  const int marked = M < V / per + 1 ? M : V / per + 1;  // chunks that can hold an index
  return 2 * words + marked * per;
}

__host__ __device__ inline int stage_words(int M, int rows) { return M <= kMaxStaged ? 2 * M * rows : 0; }

// A row's layout: the columns [head, head + chunks * per) lie in aligned 16-byte chunks.
struct RowLayout {
  int head, chunks, body_end;
};

template <typename T>
__device__ __forceinline__ RowLayout row_layout(const T* row, int V) {
  constexpr int kPer = 16 / sizeof(T);
  int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(T));
  if (head > V) head = V;
  const int chunks = (V - head) / kPer;
  return {head, chunks, head + chunks * kPer};
}

// The views of one row's shared memory `sm` (row_words of it).
struct RowShared {
  uint32_t* bits;    // [words]: chunks holding an in-range index
  uint32_t* prefix;  // [words]: marked chunks before each word
  float* acc;        // [marked chunks][per]: the marked chunks' sums
};

__device__ __forceinline__ RowShared row_shared(uint32_t* sm, int V, int per) {
  const int words = (V / per + 31) / 32;
  return {sm, sm + words, reinterpret_cast<float*>(sm + 2 * words)};
}

// The rank of marked chunk k among the row's marked chunks.
__device__ __forceinline__ int chunk_rank(const RowShared& sh, int k) {
  return sh.prefix[k >> 5] + __popc(sh.bits[k >> 5] & ((1u << (k & 31)) - 1u));
}

// One warp marks row r's chunks and sums each column's cotangents (idx and
// grad, its M slots), in fp32 and ascending slot order, into its shared memory.
template <typename T>
__device__ __forceinline__ void mark_row(const int32_t* idx, const float* grad, const T* row, int V, int M,
                                         uint32_t* sm) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int words = (V / kPer + 31) / 32;
  const RowShared sh = row_shared(sm, V, kPer);
  const RowLayout lay = row_layout(row, V);
  for (int w = lane; w < words; w += 32) sh.bits[w] = 0u;
  __syncwarp();
  for (int m = lane; m < M; m += 32) {
    const int c = idx[m];
    if (c >= lay.head && c < lay.body_end) {
      const int k = (c - lay.head) / kPer;
      atomicOr(&sh.bits[k >> 5], 1u << (k & 31));
    }
  }
  __syncwarp();

  // Exclusive prefix counts of the marked chunks.
  int marked = 0;
  for (int w0 = 0; w0 < words; w0 += 32) {
    const int w = w0 + lane;
    const int n = w < words ? __popc(sh.bits[w]) : 0;
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += t;
    }
    if (w < words) sh.prefix[w] = marked + incl - n;
    marked += __shfl_sync(kAll, incl, 31);
  }
  for (int i = lane; i < marked * kPer; i += 32) sh.acc[i] = 0.0f;
  __syncwarp();

  // Slots 32 at a time; within them the lowest slot of each column adds its
  // group's cotangents in lane order.
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    const int c = m < M ? idx[m] : -1;
    const bool in = m < M && c >= lay.head && c < lay.body_end;
    const unsigned group = __match_any_sync(kAll, in ? c : -1 - lane);
    if (in && __ffs(group) - 1 == lane) {
      float* a = sh.acc + chunk_rank(sh, (c - lay.head) / kPer) * kPer + (c - lay.head) % kPer;
      float v = *a;
      for (unsigned rest = group; rest; rest &= rest - 1u) v += grad[m0 + __ffs(rest) - 1];
      *a = v;
    }
    __syncwarp();
  }
}

// The block writes rows [r0, r0 + n) once from what mark_row left (row i's
// at sm + i * per_row; its slots at idx + i * M, grad + i * M), as one run
// of chunks over all threads: every aligned chunk with one 16-byte store
// (zeros, or the marked chunk's sums cast to T), the columns outside them
// with scalar stores.
template <typename T>
__device__ __forceinline__ void write_rows(const int32_t* idx, const float* grad, T* dz, int64_t r0, int n, int V,
                                           int M, uint32_t* sm, int per_row) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // Thread t takes chunk slots t, t + blockDim.x, ... of the rows laid end to
  // end, V / kPer + 1 slots a row (no row has more chunks), stepping (i, k).
  const int slots = V / kPer + 1;
  int i = threadIdx.x / slots, k = threadIdx.x % slots;
  while (i < n) {
    T* row = dz + (r0 + i) * V;
    const RowLayout lay = row_layout(row, V);
    if (k < lay.chunks) {
      const RowShared sh = row_shared(sm + static_cast<size_t>(i) * per_row, V, kPer);
      uint4* body = reinterpret_cast<uint4*>(row + lay.head);
      if ((sh.bits[k >> 5] >> (k & 31)) & 1u) {
        const float* a = sh.acc + chunk_rank(sh, k) * kPer;
        alignas(16) T out[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) out[e] = from_f<T>(a[e]);
        __stcs(body + k, *reinterpret_cast<const uint4*>(out));
      } else {
        __stcs(body + k, zero);
      }
    }
    for (k += blockDim.x; k >= slots; k -= slots) ++i;
  }
  if (V * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(dz + r0 * V) % 16 == 0) return;  // no edges
  for (int i = 0; i < n; ++i) {
    T* row = dz + (r0 + i) * V;
    const RowLayout lay = row_layout(row, V);
    for (int j = threadIdx.x; j < lay.head + (V - lay.body_end); j += blockDim.x) {
      const int col = j < lay.head ? j : lay.body_end + (j - lay.head);
      row[col] = from_f<T>(column_sum(idx + i * M, grad + i * M, M, col));
    }
  }
}

// Copies the n rows' indices and cotangents from r0 into a stage buffer, asynchronously.
__device__ __forceinline__ void stage_rows(const float* g, const int32_t* ci, int64_t r0, int n, int M,
                                           uint32_t* buf) {
  for (int e = threadIdx.x; e < n * M; e += blockDim.x) {
    __pipeline_memcpy_async(buf + e, ci + r0 * M + e, 4);
    __pipeline_memcpy_async(buf + n * M + e, g + r0 * M + e, 4);
  }
  __pipeline_commit();
}

// Block b takes the contiguous rows [rows b / grid, rows (b + 1) / grid), in
// groups of as many rows as it has warps: each warp marks one row, then the
// whole block writes the group's rows in order, so a block's stores run
// through one contiguous stretch of the plane. A group's indices and
// cotangents are staged while the group before it is marked and written.
template <typename T>
__global__ void gather_bwd(const float* __restrict__ g, const int32_t* __restrict__ ci, T* __restrict__ dz,
                           int64_t rows, int V, int M) {
  extern __shared__ uint32_t smem_words[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int per_row = row_words(V, M, 16 / sizeof(T));
  const bool staged = M <= kMaxStaged;
  uint32_t* stage = smem_words + static_cast<size_t>(warps) * per_row;
  const int64_t lo = rows * blockIdx.x / gridDim.x, hi = rows * (blockIdx.x + 1) / gridDim.x;
  auto size = [&](int64_t r0) { return static_cast<int>(hi - r0 < warps ? hi - r0 : warps); };
  if (staged && lo < hi) stage_rows(g, ci, lo, size(lo), M, stage);
  for (int64_t r0 = lo, j = 0; r0 < hi; r0 += warps, ++j) {
    const int n = size(r0);
    const int32_t* idx = ci + r0 * M;
    const float* grad = g + r0 * M;
    if (staged) {
      uint32_t* buf = stage + (j & 1) * 2 * M * warps;
      if (r0 + warps < hi) {
        stage_rows(g, ci, r0 + warps, size(r0 + warps), M, stage + ((j + 1) & 1) * 2 * M * warps);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      idx = reinterpret_cast<const int32_t*>(buf);
      grad = reinterpret_cast<const float*>(buf + n * M);
    }
    if (warp < n) mark_row<T>(idx + warp * M, grad + warp * M, dz + (r0 + warp) * V, V, M,
                              smem_words + static_cast<size_t>(warp) * per_row);
    __syncthreads();
    write_rows<T>(idx, grad, dz, r0, n, V, M, smem_words, per_row);
    __syncthreads();  // the rows' shared memory and stage buffer are free for the next groups
  }
}

template <typename T>
int launch_fwd(const void* z, const void* ci, void* out, int64_t rows, int V, int M, void* stream) {
  const int64_t n = rows * M;
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool fits = n < (int64_t{1} << 31);
  const bool aligned = (reinterpret_cast<uintptr_t>(ci) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (fits && aligned && M % 4 == 0) {
    const int quads = static_cast<int>(n / 4);
    gather_fwd4<T><<<(quads + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const T*>(z), static_cast<const int4*>(ci), static_cast<float4*>(out), quads, V, M);
  } else if (fits) {
    gather_fwd1<T, int><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const T*>(z), static_cast<const int32_t*>(ci), static_cast<float*>(out), static_cast<int>(n), V,
        M);
  } else {
    gather_fwd1<T, int64_t><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const T*>(z), static_cast<const int32_t*>(ci), static_cast<float*>(out), n, V, M);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* ci, void* dz, int64_t rows, int V, int M, void* stream) {
  if (rows == 0 || V == 0) return 0;
  constexpr int kPer = 16 / sizeof(T);
  int warps = kMaxWarps;
  auto bytes = [&](int w) {
    return sizeof(uint32_t) * (static_cast<size_t>(w) * row_words(V, M, kPer) + 2 * stage_words(M, w));
  };
  while (warps > 1 && bytes(warps) > kSmemTarget) warps /= 2;
  const size_t smem = bytes(warps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gather_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // A grid the card holds at once; each block takes a contiguous run of rows.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_bwd<T>, warps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = rows < resident ? rows : resident;
  gather_bwd<T><<<static_cast<unsigned>(blocks), warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(ci), static_cast<T*>(dz), rows, V, M);
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
