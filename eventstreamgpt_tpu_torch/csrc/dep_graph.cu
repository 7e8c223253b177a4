// Dependency-graph attention over each event's tiny graph, forward and
// backward (kernel D).
//
// Replaces the TPU kernel
// eventstreamgpt_tpu/ops/pallas_dep_graph.py::dep_graph_attention_pallas
// (_fwd_kernel / _bwd_kernel under a custom_vjp). For every flattened event
// row n and head h, Q queries attend over S graph positions (S = G + 1, the
// history first; Q = S - 1 with q_offset 1 on the nested-attention path):
//
//   logits[qi, s] = sum_d float(q[n, qi, h, d]) * float(k[n, s, h, d]),
//                   unscaled, for s <= qi + q_offset (and s > qi + q_offset -
//                   window when a window is given), the rest masked;
//   p             = fp32 softmax over the unmasked positions;
//   p             = keep[n, qi, s, h] ? p / keep_prob : 0 with a keep-mask;
//   out[n, qi, h] = cast(sum_s float(cast(p_s)) * float(v[n, s, h])), the
//                   probabilities rounded to the value type before the fp32
//                   PV sum, as the reference formulation does.
//
// The backward recomputes the softmax and follows _bwd_kernel step for step:
// dv_s += cast(p_s') * g; dP_s = <g, v_s>, through the dropout select;
// dL_s = p_s (dP_s - sum_t p_t dP_t); dq += dL_s k_s; dk_s += dL_s q.
//
// Design. The TPU kernel pads rows to 256-row tiles and flattens each tile to
// 2-D blocks for the vector unit; none of that carries over. Here one warp
// owns one (row, head) pair: each lane holds D / 32 consecutive elements of
// every vector (a warp reads each 128-byte head slice of q, k, v and g with
// one coalesced load), dot products reduce across the warp with
// __shfl_xor_sync, and everything else (mask, max, exp, sum, divide, the
// dropout select, the casts) is per-lane fp32 arithmetic on values every lane
// holds. The backward keeps each graph position's dk and dv accumulators in
// registers; a (row, head) pair belongs to one warp, so there are no atomics
// and two runs are bitwise equal.
//
// Bound. At the nested-attention training shape (N = 8192 rows, Q = 3, S = 4,
// H = 4, D = 64, bf16) the forward must move q, k, v, the keep-mask and the
// output once, 59.1 MB, about 17.7 us at 3.35 TB/s; the backward q, k, v, g
// and the mask in and dq, dk, dv out, 105.3 MB, about 31.4 us. Each moves
// about 0.1 GFLOP, so both are bound by bytes. This first kernel is the simple
// one: 4-byte loads per lane, one (row, head) per warp.
//
// Sizes: Q and S at most kMaxPos (8), D a multiple of 32 up to 256 (the
// wrapper checks both). q may be a strided view (the nested-attention path
// passes query[:, 1:]): its row and query strides are arguments; its last two
// axes (H, D) must be contiguous. k, v, g and the outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPos = 8;
constexpr int kWarps = 8;  // warps per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and back: the reference casts the probabilities to the value type.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int P>
__device__ __forceinline__ void load(const T* __restrict__ src, float (&dst)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) dst[j] = to_f(src[j]);
}

template <typename T, int P>
__device__ __forceinline__ void store(T* __restrict__ dst, const float (&src)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) dst[j] = from_f<T>(src[j]);
}

__device__ __forceinline__ bool allowed(int qi, int s, int q_offset, int window) {
  const int q_pos = qi + q_offset;
  return s <= q_pos && (window <= 0 || s > q_pos - window);
}

struct Shape {
  int64_t N;
  int Q, S, H, D;
  int64_t q_row, q_step;  // q's strides (elements) over rows and queries
  int q_offset, window;   // window <= 0: global
  float keep_prob;
};

// The masked fp32 softmax of query qi against the S keys held in kf:
// probabilities in p (0 at masked positions).
template <int P>
__device__ __forceinline__ void softmax_row(const float (&qf)[P], const float (&kf)[kMaxPos][P], int qi,
                                            const Shape& sh, float (&p)[kMaxPos]) {
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxPos; ++s) {
    p[s] = 0.0f;
    if (s < sh.S && allowed(qi, s, sh.q_offset, sh.window)) {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) part += qf[j] * kf[s][j];
      p[s] = warp_sum(part);
      m = fmaxf(m, p[s]);
    }
  }
  float denom = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxPos; ++s) {
    if (s < sh.S && allowed(qi, s, sh.q_offset, sh.window)) {
      p[s] = expf(p[s] - m);
      denom += p[s];
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxPos; ++s) p[s] = p[s] / denom;  // masked entries stay 0
}

template <typename T, int P>
__global__ void __launch_bounds__(kWarps * 32)
    dep_graph_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ keep, T* __restrict__ out, Shape sh) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (pair >= sh.N * sh.H) return;
  const int lane = threadIdx.x % 32;
  const int64_t n = pair / sh.H;
  const int h = static_cast<int>(pair % sh.H);
  const int64_t lane_off = static_cast<int64_t>(h) * sh.D + lane * P;

  float kf[kMaxPos][P], vf[kMaxPos][P];
#pragma unroll
  for (int s = 0; s < kMaxPos; ++s) {
    if (s < sh.S) {
      const int64_t at = (n * sh.S + s) * sh.H * sh.D + lane_off;
      load(k + at, kf[s]);
      load(v + at, vf[s]);
    }
  }
  for (int qi = 0; qi < sh.Q; ++qi) {
    float qf[P], p[kMaxPos], acc[P];
    load(q + n * sh.q_row + qi * sh.q_step + lane_off, qf);
    softmax_row(qf, kf, qi, sh, p);
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxPos; ++s) {
      if (s < sh.S && allowed(qi, s, sh.q_offset, sh.window)) {
        float ps = p[s];
        if (keep != nullptr) ps = keep[((n * sh.Q + qi) * sh.S + s) * sh.H + h] ? ps / sh.keep_prob : 0.0f;
        ps = round_to<T>(ps);
#pragma unroll
        for (int j = 0; j < P; ++j) acc[j] += ps * vf[s][j];
      }
    }
    store(out + (n * sh.Q + qi) * sh.H * sh.D + lane_off, acc);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kWarps * 32)
    dep_graph_bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ keep, const T* __restrict__ g, T* __restrict__ dq,
                  T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (pair >= sh.N * sh.H) return;
  const int lane = threadIdx.x % 32;
  const int64_t n = pair / sh.H;
  const int h = static_cast<int>(pair % sh.H);
  const int64_t lane_off = static_cast<int64_t>(h) * sh.D + lane * P;

  float kf[kMaxPos][P], vf[kMaxPos][P], dk_acc[kMaxPos][P], dv_acc[kMaxPos][P];
#pragma unroll
  for (int s = 0; s < kMaxPos; ++s) {
#pragma unroll
    for (int j = 0; j < P; ++j) dk_acc[s][j] = dv_acc[s][j] = 0.0f;
    if (s < sh.S) {
      const int64_t at = (n * sh.S + s) * sh.H * sh.D + lane_off;
      load(k + at, kf[s]);
      load(v + at, vf[s]);
    }
  }
  for (int qi = 0; qi < sh.Q; ++qi) {
    float qf[P], gf[P], p[kMaxPos], dp[kMaxPos], dq_acc[P];
    load(q + n * sh.q_row + qi * sh.q_step + lane_off, qf);
    const int64_t o_at = (n * sh.Q + qi) * sh.H * sh.D + lane_off;
    load(g + o_at, gf);
    softmax_row(qf, kf, qi, sh, p);
    // dP through the value-type cast (its derivative is the identity) and the dropout select.
#pragma unroll
    for (int s = 0; s < kMaxPos; ++s) {
      dp[s] = 0.0f;
      if (s < sh.S && allowed(qi, s, sh.q_offset, sh.window)) {
        const bool kept = keep == nullptr || keep[((n * sh.Q + qi) * sh.S + s) * sh.H + h] != 0;
        float pd = p[s];
        if (keep != nullptr) pd = kept ? pd / sh.keep_prob : 0.0f;
        const float pd_cast = round_to<T>(pd);
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          dv_acc[s][j] += pd_cast * gf[j];
          part += gf[j] * vf[s][j];
        }
        float dps = warp_sum(part);
        if (keep != nullptr) dps = kept ? dps / sh.keep_prob : 0.0f;
        dp[s] = dps;
      }
    }
    // Softmax backward on the probabilities before dropout.
    float inner = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxPos; ++s)
      if (s < sh.S && allowed(qi, s, sh.q_offset, sh.window)) inner += p[s] * dp[s];
#pragma unroll
    for (int j = 0; j < P; ++j) dq_acc[j] = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxPos; ++s) {
      if (s < sh.S && allowed(qi, s, sh.q_offset, sh.window)) {
        const float dl = p[s] * (dp[s] - inner);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          dq_acc[j] += dl * kf[s][j];
          dk_acc[s][j] += dl * qf[j];
        }
      }
    }
    store(dq + o_at, dq_acc);
  }
#pragma unroll
  for (int s = 0; s < kMaxPos; ++s) {
    if (s < sh.S) {
      const int64_t at = (n * sh.S + s) * sh.H * sh.D + lane_off;
      store(dk + at, dk_acc[s]);
      store(dv + at, dv_acc[s]);
    }
  }
}

unsigned blocks_for(const Shape& sh) {
  return static_cast<unsigned>((sh.N * sh.H + kWarps - 1) / kWarps);
}

// Dispatches on the value type and on P = D / 32 (1..8).
template <template <typename, int> class Launch, typename... Args>
int dispatch(int dtype, int per_lane, Args... args) {
#define ESGPT_CASE(P)                                                       \
  case P:                                                                   \
    return dtype == 1 ? Launch<__nv_bfloat16, P>::run(args...) : Launch<float, P>::run(args...);
  switch (per_lane) {
    ESGPT_CASE(1)
    ESGPT_CASE(2)
    ESGPT_CASE(3)
    ESGPT_CASE(4)
    ESGPT_CASE(5)
    ESGPT_CASE(6)
    ESGPT_CASE(7)
    ESGPT_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ESGPT_CASE
}

// The launches, one struct per direction so that `dispatch` can take each as a template.
template <typename T, int P>
struct Fwd {
  static int run(const void* q, const void* k, const void* v, const void* keep, void* out, Shape sh,
                 cudaStream_t stream) {
    dep_graph_fwd<T, P><<<blocks_for(sh), kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(keep), static_cast<T*>(out), sh);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int P>
struct Bwd {
  static int run(const void* q, const void* k, const void* v, const void* keep, const void* g, void* dq, void* dk,
                 void* dv, Shape sh, cudaStream_t stream) {
    dep_graph_bwd<T, P><<<blocks_for(sh), kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(keep), static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), sh);
    return static_cast<int>(cudaGetLastError());
  }
};

Shape make_shape(long long N, int Q, int S, int H, int D, long long q_row, long long q_step, int q_offset, int window,
                 float keep_prob) {
  Shape sh;
  sh.N = N;
  sh.Q = Q;
  sh.S = S;
  sh.H = H;
  sh.D = D;
  sh.q_row = q_row;
  sh.q_step = q_step;
  sh.q_offset = q_offset;
  sh.window = window;
  sh.keep_prob = keep_prob;
  return sh;
}

bool valid(long long N, int Q, int S, int H, int D) {
  return N >= 0 && Q >= 1 && Q <= kMaxPos && S >= 1 && S <= kMaxPos && H >= 1 && D >= 32 && D <= 32 * 8 &&
         D % 32 == 0;
}

}  // namespace

// dtype: 1 for bf16, 0 for fp32. keep: a (N, Q, S, H) uint8 keep-mask, or null
// without dropout. window <= 0: global. Returns the CUDA error of the launch (0 on success).
extern "C" int esgpt_dep_graph_fwd(int dtype, const void* q, long long q_row, long long q_step, const void* k,
                                   const void* v, const void* keep, void* out, long long N, int Q, int S, int H, int D,
                                   int q_offset, int window, float keep_prob, void* stream) {
  if (!valid(N, Q, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const Shape sh = make_shape(N, Q, S, H, D, q_row, q_step, q_offset, window, keep_prob);
  return dispatch<Fwd>(dtype, D / 32, q, k, v, keep, out, sh, static_cast<cudaStream_t>(stream));
}

extern "C" int esgpt_dep_graph_bwd(int dtype, const void* q, long long q_row, long long q_step, const void* k,
                                   const void* v, const void* keep, const void* g, void* dq, void* dk, void* dv,
                                   long long N, int Q, int S, int H, int D, int q_offset, int window, float keep_prob,
                                   void* stream) {
  if (!valid(N, Q, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const Shape sh = make_shape(N, Q, S, H, D, q_row, q_step, q_offset, window, keep_prob);
  return dispatch<Bwd>(dtype, D / 32, q, k, v, keep, g, dq, dk, dv, sh, static_cast<cudaStream_t>(stream));
}
