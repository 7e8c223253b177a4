// Causal, segment-masked, optionally windowed flash attention, forward and
// backward (kernels E and F).
//
// Replaces two library TPU kernels the JAX model calls under
// attention_implementation="pallas_flash":
//   E: eventstreamgpt_tpu/models/transformer.py:864, JAX's Pallas
//      flash_attention (global layers; its forward, dkv and dq pallas_calls);
//   F: eventstreamgpt_tpu/models/transformer.py:900-912, JAX's Pallas
//      splash_attention with LocalMask((S, S), (W - 1, 0)), vmapped over rows
//      (local layers whose window is above 128 or does not divide S).
// One source computes both: `window` <= 0 is E, `window` = W is F.
//
// For every row b and head h of (B, H, S, D) queries, keys and values, query
// i sees key j when
//   j <= i, seg[b, j] == seg[b, i], and (window <= 0 or j > i - window);
// padding rides as its own segment (-1), so every query sees at least itself
// and no softmax row is ever empty. Logits are unscaled (sm_scale = 1, the
// GPT-Neo lineage), in fp32; the softmax statistics are fp32; the output is
// written in the input type, with every row's fp32 softmax statistics: its
// running max m and normaliser l, the residuals the TPU kernel saves.
//
// Forward (FlashAttention-2): one block per (64-query tile, b * H + h). It
// walks the 64-key tiles from the first one the window reaches to the
// diagonal one (tiles above the diagonal or left of the window are skipped),
// staging each in shared memory as fp32, and keeps an online softmax per
// query row: running max m, running sum l, and the unnormalised fp32 output.
// Masked logits are -inf and their probability is set to exactly 0, so no
// masked value is ever added to anything (the TPU kernel adds a finite
// -0.7 * FLT_MAX instead). As the TPU forward does, the probabilities
// exp(s - m) are rounded to the value type before the P V product (fp32:
// no rounding); the normaliser l sums them unrounded.
//
// Backward: two kernels, as JAX splits its dkv and dq pallas_calls, with no
// atomics, so two runs are bitwise equal. Both recompute P = exp(s - m) / l
// from the saved statistics, as the TPU kernels do (exp(s - log-sum-exp) would
// put an ulp of the log-sum-exp, ~4e-6 at logits of 50, into every P), and
// take di = sum(o * do) (fp32, computed by the wrapper from the output as JAX
// computes it outside its kernels):
//   dkv: one block per (64-key tile, b * H + h), over the query tiles that
//        can see it; dv += cast(P)^T do, dS = P (do v^T - di),
//        dk += cast(dS)^T q;
//   dq:  one block per (64-query tile, b * H + h), over the key tiles it
//        sees; dq += cast(dS) k.
// `cast` rounds to the input type, as the TPU kernels do before each product.
//
// Products are plain fp32 FMAs on tiles in shared memory: 256 threads as a
// 16 x 16 grid, each owning a 4 x 4 patch of the 64 x 64 logits tile (rows
// ty*4 .. ty*4+3, columns tx, tx+16, tx+32, tx+48) and the same rows' output
// columns tx + 16c. A row's 16 owners are one half-warp, so row max and sum
// reduce with four shuffles. Tile rows are padded to D + 1 floats so that
// the half-warp's 16 different key rows fall in 16 different banks.
//
// Bound. At the packed training shape (B = 8, H = 4, S = 1024, D = 64, bf16,
// about 5 subjects a row) the forward must move q, k, v, o, the segment ids
// and the row statistics once, about 17 MB, 5 us at 3.35 TB/s; the allowed
// (q, k) pairs need a few GFLOP at most, about 1 us on the tensor cores: the
// function is bound by bytes. This first kernel is bound by neither: it runs
// every causal tile (segments do not skip tiles) with fp32 FMAs outside the
// tensor cores, reading two shared-memory values for every two FMAs. Its
// design is the simple one; mma/wgmma products, TMA staging and tiles
// skipped by segment are the later work.
//
// Layout: q, k, v, o, do, dq, dk and dv are read and written by stride (the
// model's projections are (B, S, H, D) tensors viewed as (B, H, S, D)), with
// the D axis contiguous; seg is (B, S) int32; stats (2, B, H, S) fp32 (m,
// then l) and di (B, H, S) fp32, all contiguous. S must be a multiple of 64;
// D is 32 or 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // queries and keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = 4;       // tile rows per thread: kTile / 16
constexpr int kCols = 4;       // logits columns per thread: kTile / 16
constexpr int kPLd = kTile + 1;  // padded row stride of a 64 x 64 probability tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// Sum and max over the 16 lanes of a half-warp (the owners of one row).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Element strides of a (B, H, S, D) tensor whose D axis is contiguous.
struct View {
  int64_t b, h, s;
};

struct Problem {
  int B, H, S;
  int window;  // <= 0: global
  View q, k, v, o, g, dq, dk, dv;
};

__device__ __forceinline__ bool visible(int qi, int kj, int seg_q, int seg_k, int window) {
  return kj <= qi && seg_q == seg_k && (window <= 0 || kj > qi - window);
}

// The first key tile any query of tile `qt` can see, and the last query tile
// that can see key tile `kt`.
__device__ __forceinline__ int first_key_tile(int qt, int window) {
  if (window <= 0) return 0;
  const int first_key = qt * kTile - window + 1;
  return first_key > 0 ? first_key / kTile : 0;
}
__device__ __forceinline__ int last_query_tile(int kt, int window, int n_tiles) {
  if (window <= 0) return n_tiles - 1;
  const int last_query = kt * kTile + kTile - 1 + window - 1;
  return min(n_tiles - 1, last_query / kTile);
}

// Copies rows s0 .. s0 + 63 of head (b, h) of x into dst (row stride D + 1), as fp32.
template <typename T, int D>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ x, const View& vw, int b, int h,
                                      int s0) {
  const T* base = x + b * vw.b + h * vw.h + static_cast<int64_t>(s0) * vw.s;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = to_f(base[r * vw.s + c]);
  }
}

// acc[i][j] = sum_d a[row i] * b[col j] over a 4-row patch of `a` (rows
// ty*4 + i) and a 4-column patch of `b` (rows tx + 16 j), both staged tiles.
template <int D>
__device__ __forceinline__ void patch_dot(const float* __restrict__ a, const float* __restrict__ b, int ty, int tx,
                                          float (&acc)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_t p[row i][t] * x[t][tx + 16 c]: a 64 x 64 probability
// tile (row stride kPLd) times a staged tile.
template <int D>
__device__ __forceinline__ void patch_accumulate(const float* __restrict__ p, const float* __restrict__ x, int ty,
                                                 int tx, float (&acc)[kRows][D / 16]) {
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    float pv[kRows], xv[D / 16];
#pragma unroll
    for (int i = 0; i < kRows; ++i) pv[i] = p[(ty * kRows + i) * kPLd + t];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) xv[c] = x[t * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void write_patch(T* __restrict__ x, const View& vw, int b, int h, int s0, int ty, int tx,
                                            const float (&acc)[kRows][D / 16]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    T* row = x + b * vw.b + h * vw.h + static_cast<int64_t>(s0 + ty * kRows + i) * vw.s;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <int D>
constexpr int fwd_smem_floats() {
  return 3 * kTile * (D + 1) + kTile * kPLd + 2 * kTile;
}
template <int D>
constexpr int dkv_smem_floats() {
  return 4 * kTile * (D + 1) + 2 * kTile * kPLd + 5 * kTile;
}
template <int D>
constexpr int dq_smem_floats() {
  return 4 * kTile * (D + 1) + kTile * kPLd + 5 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const int* __restrict__ seg,
              T* __restrict__ o, float* __restrict__ stats, Problem p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);
  int* seg_q = reinterpret_cast<int*>(sP + kTile * kPLd);
  int* seg_k = seg_q + kTile;

  const int qt = blockIdx.x, b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;

  stage<T, D>(sQ, q, p.q, b, h, q0);
  if (threadIdx.x < kTile) seg_q[threadIdx.x] = seg_row[q0 + threadIdx.x];

  float m[kRows], l[kRows], acc[kRows][D / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = first_key_tile(qt, p.window); kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK, sV and sP are no longer read
    stage<T, D>(sK, k, p.k, b, h, k0);
    stage<T, D>(sV, v, p.v, b, h, k0);
    if (threadIdx.x < kTile) seg_k[threadIdx.x] = seg_row[k0 + threadIdx.x];
    __syncthreads();

    float s[kRows][kCols];
    patch_dot<D>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        if (!visible(q0 + r, k0 + c, seg_q[r], seg_k[c], p.window)) s[i][j] = -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      // Rescales what was summed so far; nothing was when m is still -inf.
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - m_new);
        part += pj;
        sP[r * kPLd + tx + 16 * j] = round_to<T>(pj);
      }
      l[i] = l[i] * alpha + row_sum(part);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    patch_accumulate<D>(sP, sV, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float inv = 1.0f / l[i];  // l >= 1: a query always sees itself
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] *= inv;
    if (tx == 0) {
      const int64_t at = static_cast<int64_t>(blockIdx.y) * p.S + q0 + ty * kRows + i;
      stats[at] = m[i];
      stats[static_cast<int64_t>(p.B) * p.H * p.S + at] = l[i];
    }
  }
  write_patch<T, D>(o, p.o, b, h, q0, ty, tx, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ seg, const T* __restrict__ g, const float* __restrict__ stats,
                  const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sG = sQ + kTile * (D + 1);
  float* sPt = sG + kTile * (D + 1);  // P^T: rows keys, columns queries
  float* sDt = sPt + kTile * kPLd;    // dS^T
  float* s_m = sDt + kTile * kPLd;
  float* s_il = s_m + kTile;  // 1 / l
  float* s_di = s_il + kTile;
  int* seg_k = reinterpret_cast<int*>(s_di + kTile);
  int* seg_q = seg_k + kTile;

  const int kt = blockIdx.x, b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int k0 = kt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_tiles = p.S / kTile;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;
  const float* m_row = stats + static_cast<int64_t>(blockIdx.y) * p.S;
  const float* l_row = m_row + static_cast<int64_t>(p.B) * p.H * p.S;
  const float* di_row = di + static_cast<int64_t>(blockIdx.y) * p.S;

  stage<T, D>(sK, k, p.k, b, h, k0);
  stage<T, D>(sV, v, p.v, b, h, k0);
  if (threadIdx.x < kTile) seg_k[threadIdx.x] = seg_row[k0 + threadIdx.x];

  float dk_acc[kRows][D / 16], dv_acc[kRows][D / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  const int qt_last = last_query_tile(kt, p.window, n_tiles);
  for (int qt = kt; qt <= qt_last; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage<T, D>(sQ, q, p.q, b, h, q0);
    stage<T, D>(sG, g, p.g, b, h, q0);
    if (threadIdx.x < kTile) {
      seg_q[threadIdx.x] = seg_row[q0 + threadIdx.x];
      s_m[threadIdx.x] = m_row[q0 + threadIdx.x];
      s_il[threadIdx.x] = 1.0f / l_row[q0 + threadIdx.x];
      s_di[threadIdx.x] = di_row[q0 + threadIdx.x];
    }
    __syncthreads();

    // Rows keys (ty*4 + i), columns queries (tx + 16 j).
    float s[kRows][kCols], dp[kRows][kCols];
    patch_dot<D>(sK, sQ, ty, tx, s);
    patch_dot<D>(sV, sG, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(q0 + c, k0 + r, seg_q[c], seg_k[r], p.window);
        const float pij = ok ? expf(s[i][j] - s_m[c]) * s_il[c] : 0.0f;
        sPt[r * kPLd + c] = round_to<T>(pij);
        sDt[r * kPLd + c] = round_to<T>(pij * (dp[i][j] - s_di[c]));
      }
    }
    __syncthreads();
    patch_accumulate<D>(sPt, sG, ty, tx, dv_acc);
    patch_accumulate<D>(sDt, sQ, ty, tx, dk_acc);
  }
  write_patch<T, D>(dk, p.dk, b, h, k0, ty, tx, dk_acc);
  write_patch<T, D>(dv, p.dv, b, h, k0, ty, tx, dv_acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, const T* __restrict__ g, const float* __restrict__ stats,
                 const float* __restrict__ di, T* __restrict__ dq, Problem p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kTile * (D + 1);
  float* sK = sG + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sD = sV + kTile * (D + 1);  // dS: rows queries, columns keys
  float* s_m = sD + kTile * kPLd;
  float* s_il = s_m + kTile;  // 1 / l
  float* s_di = s_il + kTile;
  int* seg_q = reinterpret_cast<int*>(s_di + kTile);
  int* seg_k = seg_q + kTile;

  const int qt = blockIdx.x, b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;

  stage<T, D>(sQ, q, p.q, b, h, q0);
  stage<T, D>(sG, g, p.g, b, h, q0);
  if (threadIdx.x < kTile) {
    const int64_t at = static_cast<int64_t>(blockIdx.y) * p.S + q0 + threadIdx.x;
    seg_q[threadIdx.x] = seg_row[q0 + threadIdx.x];
    s_m[threadIdx.x] = stats[at];
    s_il[threadIdx.x] = 1.0f / stats[static_cast<int64_t>(p.B) * p.H * p.S + at];
    s_di[threadIdx.x] = di[at];
  }

  float dq_acc[kRows][D / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq_acc[i][c] = 0.0f;

  for (int kt = first_key_tile(qt, p.window); kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<T, D>(sK, k, p.k, b, h, k0);
    stage<T, D>(sV, v, p.v, b, h, k0);
    if (threadIdx.x < kTile) seg_k[threadIdx.x] = seg_row[k0 + threadIdx.x];
    __syncthreads();

    // Rows queries (ty*4 + i), columns keys (tx + 16 j).
    float s[kRows][kCols], dp[kRows][kCols];
    patch_dot<D>(sQ, sK, ty, tx, s);
    patch_dot<D>(sG, sV, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, seg_q[r], seg_k[c], p.window);
        const float pij = ok ? expf(s[i][j] - s_m[r]) * s_il[r] : 0.0f;
        sD[r * kPLd + c] = round_to<T>(pij * (dp[i][j] - s_di[r]));
      }
    }
    __syncthreads();
    patch_accumulate<D>(sD, sK, ty, tx, dq_acc);
  }
  write_patch<T, D>(dq, p.dq, b, h, q0, ty, tx, dq_acc);
}

// Sets a kernel's dynamic shared memory above the 48 KB default, then launches it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem_bytes, const Problem& p, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.S / kTile, p.B * p.H);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(args..., p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_fwd(const void* q, const void* k, const void* v, const int* seg, void* o, float* stats, const Problem& p,
            cudaStream_t stream) {
  return launch(flash_fwd<T, D>, fwd_smem_floats<D>() * 4, p, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), seg, static_cast<T*>(o), stats);
}

template <typename T, int D>
int run_bwd(const void* q, const void* k, const void* v, const int* seg, const void* g, const float* stats,
            const float* di, void* dq, void* dk, void* dv, const Problem& p, cudaStream_t stream) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  int err = launch(flash_bwd_dkv<T, D>, dkv_smem_floats<D>() * 4, p, stream, tq, tk, tv, seg, tg, stats, di,
                   static_cast<T*>(dk), static_cast<T*>(dv));
  if (err != 0) return err;
  return launch(flash_bwd_dq<T, D>, dq_smem_floats<D>() * 4, p, stream, tq, tk, tv, seg, tg, stats, di,
                static_cast<T*>(dq));
}

View view(const long long* strides, int i) { return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]}; }

bool valid(int dtype, int B, int H, int S, int D) {
  return (dtype == 0 || dtype == 1) && B >= 0 && H >= 1 && S >= 0 && S % kTile == 0 && (D == 32 || D == 64) &&
         static_cast<long long>(B) * H <= 65535;  // the grid's y dimension
}

}  // namespace

// dtype: 1 for bf16, 0 for fp32. strides: (b, h, s) element strides of q, k,
// v, o (forward) or q, k, v, do, dq, dk, dv (backward), three each. window <=
// 0: global. Returns the CUDA error of the launches (0 on success).
extern "C" int esgpt_flash_fwd(int dtype, const void* q, const void* k, const void* v, const int* seg, void* o,
                               float* stats, const long long* strides, int B, int H, int S, int D, int window,
                               void* stream) {
  if (!valid(dtype, B, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  Problem p{};
  p.B = B;
  p.H = H;
  p.S = S;
  p.window = window;
  p.q = view(strides, 0);
  p.k = view(strides, 1);
  p.v = view(strides, 2);
  p.o = view(strides, 3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 32 ? run_fwd<__nv_bfloat16, 32>(q, k, v, seg, o, stats, p, st)
                   : run_fwd<__nv_bfloat16, 64>(q, k, v, seg, o, stats, p, st);
  return D == 32 ? run_fwd<float, 32>(q, k, v, seg, o, stats, p, st)
                 : run_fwd<float, 64>(q, k, v, seg, o, stats, p, st);
}

extern "C" int esgpt_flash_bwd(int dtype, const void* q, const void* k, const void* v, const int* seg, const void* g,
                               const float* stats, const float* di, void* dq, void* dk, void* dv,
                               const long long* strides, int B, int H, int S, int D, int window, void* stream) {
  if (!valid(dtype, B, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  Problem p{};
  p.B = B;
  p.H = H;
  p.S = S;
  p.window = window;
  p.q = view(strides, 0);
  p.k = view(strides, 1);
  p.v = view(strides, 2);
  p.g = view(strides, 3);
  p.dq = view(strides, 4);
  p.dk = view(strides, 5);
  p.dv = view(strides, 6);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 32 ? run_bwd<__nv_bfloat16, 32>(q, k, v, seg, g, stats, di, dq, dk, dv, p, st)
                   : run_bwd<__nv_bfloat16, 64>(q, k, v, seg, g, stats, di, dq, dk, dv, p, st);
  return D == 32 ? run_bwd<float, 32>(q, k, v, seg, g, stats, di, dq, dk, dv, p, st)
                 : run_bwd<float, 64>(q, k, v, seg, g, stats, di, dq, dk, dv, p, st);
}
