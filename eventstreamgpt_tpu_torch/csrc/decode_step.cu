// One CI decode step through the whole transformer layer stack (kernel B).
//
// Replaces the TPU kernel eventstreamgpt_tpu/ops/pallas_decode_step.py::
// decode_stack_step (_stack_kernel / _layer_math): per layer LN1 -> q/k/v ->
// cursor write into the KV cache -> masked, unscaled fp32-softmax attention
// (per-layer window, 0 = global) -> out-proj + residual -> LN2 -> MLP +
// residual -> event-mask zeroing. Returns h before ln_f, and writes the new
// padding mask (this event's bit at the cursor) and lengths (cursor + 1);
// rows whose `active` bit is 0 keep their old mask and length there (the
// attention itself always sees the new mask, as in JAX).
//
// Bound: the step's output depends only on the cache positions that pass the
// causal, window and padding tests, so its bytes are the weights (about
// 3.1 MB in bf16 at the serving shape L=2, B=32, H=4, M=256, D=64, I=1024)
// plus K and V at those live positions (at most 32 a row on the local layer
// and cursor + 1 on the global one): about 9.6 MB with prompts of 128-192
// events, about 3 us at 3.35 TB/s (chip_smoke.py computes it from the
// captured inputs). Every product is a mat-vec (about 1 FLOP a byte), far
// below the ~295 FLOPs a byte at which the tensor cores would set the pace.
//
// Design: one thread-block cluster of C CTAs per slot row (C the largest
// divisor of H up to 8; C = 4 at the serving shape: 128 CTAs on 132 SMs),
// launched with cudaLaunchKernelEx and a cluster dimension.
//
// * CTA c owns heads [c H/C, (c+1) H/C): it computes their q/k/v columns,
//   writes their k/v at the cursor, and runs their attention. In the
//   out-projection, fc and MLP projection it owns 1/C of each product's
//   output columns. Every CTA keeps the whole residual row and computes the
//   LayerNorms redundantly, in the same order, so they agree bit for bit.
// * Whole vectors are exchanged through distributed shared memory: the
//   attention output before Wo, the new residual after Wo and after the MLP,
//   and the MLP intermediate before Wpr. A CTA writes each value it computes
//   into every CTA's copy of the vector (cluster.map_shared_rank), and one
//   cluster.sync() makes the whole vector visible: 4 barriers a layer, plus
//   one before the first remote write. The last layer's last barrier is the
//   last remote access, so no CTA exits while a peer may still write to it.
//   No copy is overwritten while it is read: a vector is written into a
//   buffer only after the barrier that follows the buffer's last reads, and
//   the residual's columns, which each CTA reads while the others write, are
//   disjoint.
// * Mat-vecs: weights are (L, in, out) row-major (the flax kernel layout). A
//   thread holds 8 bf16 (4 fp32) output columns and reads each weight row
//   slice with 16-byte loads, 16 rows in flight (the weights sit in L2
//   across steps, so each mat-vec is paced by rounds of L2 latency); groups
//   of threads split the input dimension, and the groups' partial sums are
//   added in shared memory in a fixed order, so two runs are bitwise equal. Slices whose width, offset or row
//   stride is not a multiple of 16 bytes take a scalar path (one column a
//   thread), so every shape works.
// * Attention reads K and V only over [max(0, st - w + 1), min(st, M - 1)]
//   and only at positions whose padding bit is set; a warp reads K rows with
//   16-byte loads, lanes across D. The cursor's k and v come from shared
//   memory (computed, not re-read). JAX fills masked scores with
//   finfo(float32).min, not -inf, so a row with no live position gets a
//   uniform softmax over all M positions, the value just written at the
//   cursor included: only such a row reads the whole buffer.
// * Activations round to the compute type (bf16 or fp32) at the points where
//   the JAX layer rounds, so the kernel tracks the plain version to bf16
//   rounding. The new k/v are written into the cache IN PLACE (the JAX
//   kernel returns new arrays); a cursor at or past M writes nothing and
//   attends to m < M only. The new mask and length are written by rank 0.
//
// Quantized caches (the second entry, esgpt_decode_stack_step_quant): the
// planes hold int8 or fp8 (e4m3) codes Q with one fp32 scale a (layer, row,
// head, position), as _layer_math with quantized=True. After the q/k/v
// mat-vec a warp takes each of the CTA's heads' new k and v (a CTA owns whole
// heads, so no exchange): amax = max |x| over D (NaN propagates, as in
// torch and jnp), scale = amax > 0 ? amax / qmax : 1 (qmax 127 or 448),
// codes rint(x / scale) clamped to +-127, or x / scale cast with
// __NV_SATFINITE; true divisions and round-half-even, no fast math. Codes
// and scale land at the cursor (only where 0 <= cursor < M), and the shared
// copy of k and v becomes its dequantized value, so the cursor's term is
// dequantize(quantize(k)) as in JAX. Every position attention reads is
// rnd<T>(float(code) * scale[m]); the 16-byte paths take 16 codes a load.
// Zero codes carry scale 1, so a row with no live position still averages
// zeros over the unwritten positions.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kThreads = 256;         // threads a CTA
constexpr int kPartialPerThread = 8;  // floats of partial sums a thread may hold in a mat-vec
constexpr int kCannotPlace = -1;      // returned when no cluster fits on the card

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Rounds an fp32 value to the compute type and back.
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// The 16 / sizeof(T) elements of a 16-byte word, as floats.
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 one-byte codes.
__device__ __forceinline__ void unpack(const uint4& u, float* out, int8_t) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xffu);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, __nv_fp8_e4m3) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_fp8_e4m3 c;
    c.__x = (__nv_fp8_storage_t)((w[i / 4] >> (8 * (i % 4))) & 0xffu);
    out[i] = static_cast<float>(c);
  }
}

// Quantized cache codes: the largest code and the code of a scaled value.
template <typename Q>
__device__ __forceinline__ float qmax();
template <>
__device__ __forceinline__ float qmax<int8_t>() { return 127.f; }
template <>
__device__ __forceinline__ float qmax<__nv_fp8_e4m3>() { return 448.f; }

__device__ __forceinline__ int8_t quantize(float y, int8_t) {
  const int c = __float2int_rn(y);  // round half to even; NaN gives 0
  return (int8_t)max(-127, min(127, c));
}
__device__ __forceinline__ __nv_fp8_e4m3 quantize(float y, __nv_fp8_e4m3) {
  __nv_fp8_e4m3 c;
  c.__x = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  return c;
}

// max that keeps a NaN from either side (fmaxf drops it), as torch.amax and jnp.max do.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// flax LayerNorm: fp32 stats, var = max(0, E[x^2] - E[x]^2),
// (x - mean) * (rsqrt(var + eps) * scale) + bias, rounded to T. Every warp
// sums the whole row itself, in the same order, so no barrier comes before
// the normalisation. Ends synchronised.
template <typename T>
__device__ void layer_norm(const float* x, float* y, const float* scale, const float* bias, int E, float eps) {
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x & 31; i < E; i += 32) {
    s += x[i];
    ss += x[i] * x[i];
  }
  const float mean = warp_sum(s) / E;
  const float meansq = warp_sum(ss) / E;
  const float inv = 1.0f / sqrtf(fmaxf(0.f, meansq - mean * mean) + eps);
  for (int i = threadIdx.x; i < E; i += blockDim.x) y[i] = rnd<T>((x[i] - mean) * (inv * scale[i]) + bias[i]);
  __syncthreads();
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fmaxf(x, 0.f);
  const float c = 0.7978845608028654f;  // sqrt(2 / pi): flax's tanh-form gelu
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// y_w[j] = sum over i in [0, K) of x[i] * W_w[i * ldw + j], for j in [0, N)
// and each of the NW matrices W_w (pointers already at the first column);
// epi(w, j, y) receives each result once. SKIP: rows with x[i] == 0 or
// i == skip_row are not read (their terms would add nothing or are added by
// the caller). Groups of threads split the rows; each thread holds `per`
// adjacent columns (8 bf16 or 4 fp32 on the 16-byte path, with kBatch rows'
// loads in flight; 1 on the scalar path). The groups' partial sums are added
// by as many threads per output as the block has to spare, each over a fixed
// set of groups, then by shuffles in a fixed order. Ends synchronised.
// Q, when not T, is a quantized cache's code type (16 codes a load, fewer
// groups so the partial sums fit), and row i of W reads as
// rnd<T>(code * row_scale[i]).
template <typename T, int NW, bool SKIP, typename Q = T, typename Epi>
__device__ void matvec(const float* x, int K, const Q* const* W, size_t ldw, int N, int skip_row, float* partial,
                       Epi epi, const float* row_scale = nullptr) {
  constexpr bool kQuant = !std::is_same<Q, T>::value;
  constexpr int kVec = 16 / sizeof(Q);
  constexpr int kBatch = sizeof(Q) == 1 ? 8 : 16;
  bool vec = (ldw * sizeof(Q)) % 16 == 0 && N % kVec == 0;
  for (int w = 0; w < NW; ++w) vec = vec && (reinterpret_cast<uintptr_t>(W[w]) & 15) == 0;
  const int per = vec ? kVec : 1;
  const int tpr = N / per + (N % per != 0);  // thread columns a matrix row needs
  const int cols = NW * tpr;
  const int nt = blockDim.x, tid = threadIdx.x;
  for (int c0 = 0; c0 < cols; c0 += nt) {
    const int tc = min(nt, cols - c0);
    const int groups = min(nt / tc, nt * kPartialPerThread / (tc * per));
    const int g = tid / tc, cc = c0 + tid % tc;
    const int w = cc / tpr, j0 = (cc % tpr) * per;
    if (g < groups) {
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
      const Q* base = W[w] + j0;
      if (vec) {
        for (int i0 = g; i0 < K; i0 += kBatch * groups) {
          uint4 raw[kBatch];
          float xs[kBatch], sc[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * groups;
            xs[u] = 0.f;
            sc[u] = 1.f;
            raw[u] = make_uint4(0u, 0u, 0u, 0u);
            if (i < K && (!SKIP || i != skip_row)) {
              xs[u] = x[i];
              if (!SKIP || xs[u] != 0.f) {
                raw[u] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)i * ldw));
                if constexpr (kQuant) sc[u] = __ldg(row_scale + i);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            float v[kVec];
            unpack(raw[u], v, Q());
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              if constexpr (kQuant) v[e] = rnd<T>(v[e] * sc[u]);
              acc[e] += xs[u] * v[e];
            }
          }
        }
      } else {
#pragma unroll 4
        for (int i = g; i < K; i += groups) {
          const float xi = x[i];
          if (SKIP && (xi == 0.f || i == skip_row)) continue;
          float wi = to_f(base[(size_t)i * ldw]);
          if constexpr (kQuant) wi = rnd<T>(wi * row_scale[i]);
          acc[0] += xi * wi;
        }
      }
      float* out = partial + (size_t)g * tc * per + (tid % tc) * per;
      if (vec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) out[e] = acc[e];
      } else {
        out[0] = acc[0];
      }
    }
    __syncthreads();
    const int outs = tc * per;
    int share = 1;  // threads an output, a power of two up to a warp
    while (share < 32 && 2 * share * outs <= nt) share *= 2;
    for (int t0 = 0; t0 < outs * share; t0 += nt) {
      const int t = t0 + tid, o = t / share, part = t % share;
      float y = 0.f;
      if (o < outs)
        for (int gg = part; gg < groups; gg += share) y += partial[(size_t)gg * outs + o];
      for (int d = share / 2; d > 0; d >>= 1) y += __shfl_xor_sync(0xffffffffu, y, d);
      if (o < outs && part == 0) {
        const int ccol = c0 + o / per, e = o % per;
        epi(ccol / tpr, (ccol % tpr) * per + e, y);
      }
    }
    __syncthreads();
  }
}

// Writes v at dst[j] in the shared memory of every CTA of the cluster.
__device__ __forceinline__ void push(cg::cluster_group& cluster, float* dst, int j, float v, int C) {
  for (int p = 0; p < C; ++p) cluster.map_shared_rank(dst, p)[j] = v;
}

// Compiled only with -DESGPT_DECODE_TRACE (tools/ab_kernels.py --trace): for
// each CTA of the latest launch, the global timer (ns) at its start and at the
// end of each phase of each layer (kPhases a layer, in the order of
// kernel B's loop: LN1, q/k/v, attention, exchange, Wo, exchange, LN2, fc,
// exchange, Wpr, exchange), then at its end.
constexpr int kPhases = 11;
#ifdef ESGPT_DECODE_TRACE
constexpr int kTraceCtas = 1024, kTraceStamps = 64;
__device__ unsigned long long g_trace[kTraceCtas][kTraceStamps];

__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x != 0 || blockIdx.x >= kTraceCtas || i >= kTraceStamps) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_trace[blockIdx.x][i] = t;
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

struct Shared {
  float *x, *n, *in, *qkv, *s, *partial, *flag;
};

// The shared-memory layout, in floats: sets sh's pointers from base and returns the total.
__host__ __device__ inline size_t shared_layout(int H, int M, int D, int I, int C, int threads, Shared& sh,
                                                float* base) {
  const int E = H * D, Ec = E / C;
  const size_t sizes[7] = {(size_t)E, (size_t)E, (size_t)(E > I ? E : I), (size_t)3 * Ec, (size_t)(H / C) * M,
                           (size_t)threads * kPartialPerThread, 1};
  float** slots[7] = {&sh.x, &sh.n, &sh.in, &sh.qkv, &sh.s, &sh.partial, &sh.flag};
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    *slots[i] = base + off;
    off += (sizes[i] + 3) / 4 * 4;  // 16-byte aligned
  }
  return off;
}

// Unscaled fp32 q . k over [lo, hi] for one head into s[m - lo]; -inf where
// the position is masked; the cursor (from shared memory) is scored apart.
// A quantized cache (Q not T) reads row m as rnd<T>(code * ks[m]).
template <typename T, typename Q>
__device__ void scores(const float* q, const float* k_cur, const Q* K, const float* ks, int D, int lo, int hi, int st,
                       bool ev, const uint8_t* mrow, float* s) {
  constexpr bool kQuant = !std::is_same<Q, T>::value;
  constexpr int kVec = 16 / sizeof(Q);
  const int lanes = D / kVec;  // lanes a K row takes on the 16-byte path
  const bool vec = D % kVec == 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
                   (reinterpret_cast<uintptr_t>(K) & 15) == 0;
  const int n = hi - lo + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    const int warp = tid >> 5, lane = tid & 31, rows_per_warp = 32 / lanes, nwarps = nt >> 5;
    const int lr = lane % lanes, step = nwarps * rows_per_warp;
    constexpr int kRows = 4;  // K rows a lane group has in flight
    for (int base = warp * rows_per_warp; base < n; base += kRows * step) {
      uint4 raw[kRows];
      bool live[kRows];
      float sc[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = base + u * step + lane / lanes, m = lo + r;
        live[u] = r < n && m != st && mrow[m];
        raw[u] = live[u] ? __ldg(reinterpret_cast<const uint4*>(K + (size_t)m * D + lr * kVec)) : make_uint4(0, 0, 0, 0);
        sc[u] = 1.f;
        if constexpr (kQuant) sc[u] = live[u] ? __ldg(ks + m) : 1.f;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = base + u * step + lane / lanes, m = lo + r;
        float v[kVec], acc = 0.f;
        unpack(raw[u], v, Q());
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if constexpr (kQuant) v[e] = rnd<T>(v[e] * sc[u]);
          acc += q[lr * kVec + e] * v[e];
        }
        for (int o = lanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lr == 0 && r < n && m != st) s[r] = live[u] ? acc : -INFINITY;
      }
    }
  } else {
    for (int r = tid; r < n; r += nt) {
      const int m = lo + r;
      if (m == st) continue;
      float acc = -INFINITY;
      if (mrow[m]) {
        acc = 0.f;
        for (int d = 0; d < D; ++d) {
          float kd = to_f(K[(size_t)m * D + d]);
          if constexpr (kQuant) kd = rnd<T>(kd * ks[m]);
          acc += q[d] * kd;
        }
      }
      s[r] = acc;
    }
  }
  if (tid < 32 && st >= lo && st <= hi) {  // the cursor: warp 0, lanes across D
    float acc = 0.f;
    for (int d = tid; d < D; d += 32) acc += q[d] * k_cur[d];
    acc = warp_sum(acc);
    if (tid == 0) s[st - lo] = ev ? acc : -INFINITY;
  }
  __syncthreads();
}

// The softmax of the n scores s (-inf where masked) in place, by warp 0, as
// probabilities rounded to T; returns false, leaving s, when none is live.
// Ends synchronised.
template <typename T>
__device__ bool softmax(float* s, int n, float* flag) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = -INFINITY;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s[r]);
    mx = warp_max(mx);
    if (mx != -INFINITY) {
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = s[r] == -INFINITY ? 0.f : expf(s[r] - mx);
        s[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int r = lane; r < n; r += 32) s[r] = rnd<T>(s[r] / sum);
    }
    if (lane == 0) *flag = mx;
  }
  __syncthreads();
  return *flag != -INFINITY;
}

// A quantized cache's write at the cursor: for each of the CTA's HC heads, a
// warp quantizes the new k and v (qkv[Ec..3Ec)) over D, stores codes and
// scale at position `st` of rows row0 + hh when `write`, and leaves the
// dequantized values in qkv for the cursor's own attention terms. Ends
// synchronised.
template <typename T, typename Q>
__device__ void quantize_cursor(float* qkv, int Ec, int HC, int D, Q* kc, Q* vc, float* ks, float* vs, size_t row0,
                                int M, int st, bool write) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int p = warp; p < 2 * HC; p += nwarps) {
    const int which = p / HC, hh = p % HC;  // 0: key, 1: value
    float* x = qkv + (size_t)(1 + which) * Ec + hh * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = nan_max(amax, fabsf(x[d]));
    for (int o = 16; o > 0; o >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = amax > 0.f ? amax / qmax<Q>() : 1.f;
    const size_t at = (row0 + hh) * M + st;
    Q* cache = which == 0 ? kc : vc;
    for (int d = lane; d < D; d += 32) {
      const Q c = quantize(x[d] / scale, Q());
      if (write) cache[at * D + d] = c;
      x[d] = rnd<T>(to_f(c) * scale);
    }
    if (write && lane == 0) (which == 0 ? ks : vs)[at] = scale;
  }
  __syncthreads();
}

// Two CTAs an SM (at most 128 registers a thread): a cluster needs C SMs of
// one GPC with room, and at one CTA an SM the serving shape's 32 clusters of
// 4 do not all fit on the card at once.
template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads, 2) decode_stack_kernel(const T* __restrict__ h0, const int32_t* __restrict__ start,
                                    const uint8_t* __restrict__ event_mask, const uint8_t* __restrict__ mask,
                                    const uint8_t* __restrict__ active, const int32_t* __restrict__ windows,
                                    const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                                    const T* __restrict__ wq, const T* __restrict__ wk, const T* __restrict__ wv,
                                    const T* __restrict__ wo, const T* __restrict__ bo,
                                    const float* __restrict__ ln2_s, const float* __restrict__ ln2_b,
                                    const T* __restrict__ wfc, const T* __restrict__ bfc, const T* __restrict__ wpr,
                                    const T* __restrict__ bpr, Q* kc, Q* vc, float* ks, float* vs, T* __restrict__ h_out,
                                    uint8_t* __restrict__ new_mask, int32_t* __restrict__ new_length, int L, int B,
                                    int H, int M, int D, int I, float eps, int act, int C) {
  constexpr bool kQuant = !std::is_same<Q, T>::value;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Shared sh;
  shared_layout(H, M, D, I, C, blockDim.x, sh, smem);
  const int E = H * D, HC = H / C, Ec = HC * D;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int e0 = rank * Ec, i0 = I * rank / C, Ic = I * (rank + 1) / C - i0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int st = start[b];
  const bool ev = event_mask[b] != 0;
  const uint8_t* mrow = mask + (size_t)b * M;

  if (rank == 0) {  // the layer-shared cache tracking: this event's bit at the cursor
    const bool live = active == nullptr || active[b] != 0;
    for (int m = tid; m < M; m += nt) new_mask[(size_t)b * M + m] = (live && m == st) ? (uint8_t)ev : mrow[m];
    if (tid == 0) new_length[b] = live ? st + 1 : st;
  }
  for (int i = tid; i < E; i += nt) sh.x[i] = to_f(h0[(size_t)b * E + i]);
  stamp(0);
  cluster.sync();  // every CTA of the cluster runs before any remote write

  for (int l = 0; l < L; ++l) {
    const size_t ee = (size_t)l * E * E;
    const int at = 1 + l * kPhases;
    layer_norm<T>(sh.x, sh.n, ln1_s + (size_t)l * E, ln1_b + (size_t)l * E, E, eps);
    stamp(at);

    // This CTA's heads' q/k/v; k/v land in the cache at the row's cursor, in place.
    {
      const T* W[3] = {wq + ee + e0, wk + ee + e0, wv + ee + e0};
      float* qkv = sh.qkv;
      const bool write = st >= 0 && st < M;
      matvec<T, 3, false>(sh.n, E, W, E, Ec, -1, sh.partial, [&](int w, int j, float y) {
        const float r = rnd<T>(y);
        qkv[w * Ec + j] = r;
        if constexpr (!kQuant) {
          if (w > 0 && write) {
            const int h = (e0 + j) / D, d = j % D;
            T* cache = w == 1 ? kc : vc;
            cache[((((size_t)l * B + b) * H + h) * M + st) * D + d] = from_f<T>(r);
          }
        }
      });
      if constexpr (kQuant)
        quantize_cursor<T, Q>(qkv, Ec, HC, D, kc, vc, ks, vs, ((size_t)l * B + b) * H + rank * HC, M, st, write);
    }
    stamp(at + 1);

    // Attention for this CTA's heads over the live range; the output goes to every CTA's `in`.
    const int w = windows[l];
    const int lo = w > 0 ? max(0, st - w + 1) : 0, hi = min(st, M - 1);
    for (int hh = 0; hh < HC; ++hh) {
      const int h = rank * HC + hh;
      const size_t head_s = (((size_t)l * B + b) * H + h) * M, head = head_s * D;
      const float* q = sh.qkv + hh * D;
      const float* k_cur = sh.qkv + Ec + hh * D;
      const float* v_cur = sh.qkv + 2 * Ec + hh * D;
      float* s = sh.s + (size_t)hh * M;
      bool live = false;
      if (lo <= hi) {
        scores<T, Q>(q, k_cur, kc + head, kQuant ? ks + head_s : nullptr, D, lo, hi, st, ev, mrow, s);
        live = softmax<T>(s, hi - lo + 1, sh.flag);
      }
      int plo = lo, phi = hi;
      if (!live) {  // no live position: JAX's uniform softmax over the whole buffer
        plo = 0;
        phi = M - 1;
        const float p = rnd<T>(1.0f / M);
        for (int r = tid; r < M; r += nt) s[r] = p;
        __syncthreads();
      }
      const bool cursor_in = st >= plo && st <= phi;
      const float p_cur = cursor_in ? s[st - plo] : 0.f;
      const Q* V[1] = {vc + head + (size_t)plo * D};
      float* o = sh.in + e0 + hh * D;
      matvec<T, 1, true, Q>(
          s, phi - plo + 1, V, D, D, st - plo, sh.partial,
          [&](int, int j, float y) { push(cluster, o, j, rnd<T>(cursor_in ? y + p_cur * v_cur[j] : y), C); },
          kQuant ? vs + head_s + plo : nullptr);
    }
    stamp(at + 2);
    cluster.sync();
    stamp(at + 3);

    // Out-projection + bias + attention residual, this CTA's columns, to every CTA's x.
    {
      const T* W[1] = {wo + ee + e0};
      const T* bias = bo + (size_t)l * E + e0;
      float* x = sh.x;
      matvec<T, 1, false>(sh.in, E, W, E, Ec, -1, sh.partial, [&](int, int j, float y) {
        push(cluster, x, e0 + j, rnd<T>(rnd<T>(rnd<T>(y) + to_f(bias[j])) + x[e0 + j]), C);
      });
    }
    stamp(at + 4);
    cluster.sync();
    stamp(at + 5);

    layer_norm<T>(sh.x, sh.n, ln2_s + (size_t)l * E, ln2_b + (size_t)l * E, E, eps);
    stamp(at + 6);

    // fc + bias + activation, this CTA's columns of the intermediate, to every CTA's `in`.
    {
      const T* W[1] = {wfc + (size_t)l * E * I + i0};
      const T* bias = bfc + (size_t)l * I + i0;
      float* f = sh.in + i0;
      matvec<T, 1, false>(sh.n, E, W, I, Ic, -1, sh.partial, [&](int, int j, float y) {
        push(cluster, f, j, rnd<T>(activate(rnd<T>(rnd<T>(y) + to_f(bias[j])), act)), C);
      });
    }
    stamp(at + 7);
    cluster.sync();
    stamp(at + 8);

    // MLP projection + residual, then the between-layer event-mask zeroing, to every CTA's x.
    {
      const T* W[1] = {wpr + (size_t)l * I * E + e0};
      const T* bias = bpr + (size_t)l * E + e0;
      float* x = sh.x;
      matvec<T, 1, false>(sh.in, I, W, E, Ec, -1, sh.partial, [&](int, int j, float y) {
        push(cluster, x, e0 + j, ev ? rnd<T>(x[e0 + j] + rnd<T>(rnd<T>(y) + to_f(bias[j]))) : 0.f, C);
      });
    }
    stamp(at + 9);
    cluster.sync();  // also the last remote access: no CTA exits while a peer may still write to it
    stamp(at + 10);
  }

  for (int j = tid; j < Ec; j += nt) h_out[(size_t)b * E + e0 + j] = from_f<T>(sh.x[e0 + j]);
  stamp(1 + L * kPhases);
}

// CTAs a cluster: the largest divisor of H up to kMaxCluster.
int cluster_size(int H) {
  int C = 0;
  for (int c = 1; c <= kMaxCluster; ++c)
    if (H % c == 0) C = c;
  return C;
}

template <typename T, typename Q>
int launch(const void* h0, const void* start, const void* event_mask, const void* mask, const void* active,
           const void* windows, const void* ln1_s, const void* ln1_b, const void* wq, const void* wk, const void* wv,
           const void* wo, const void* bo, const void* ln2_s, const void* ln2_b, const void* wfc, const void* bfc,
           const void* wpr, const void* bpr, void* kc, void* vc, void* ks, void* vs, void* h_out, void* new_mask,
           void* new_length, int L, int B, int H, int M, int D, int I, float eps, int act, int threads, void* stream) {
  const int C = cluster_size(H);
  if (C < 1 || threads != kThreads) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Shared layout;
  const size_t smem = shared_layout(H, M, D, I, C, threads, layout, nullptr) * sizeof(float);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return kCannotPlace;
  err = cudaFuncSetAttribute(decode_stack_kernel<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(B * C));
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, decode_stack_kernel<T, Q>, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return kCannotPlace;
  err = cudaLaunchKernelEx(&config, decode_stack_kernel<T, Q>, (const T*)h0, (const int32_t*)start,
                           (const uint8_t*)event_mask, (const uint8_t*)mask, (const uint8_t*)active,
                           (const int32_t*)windows, (const float*)ln1_s, (const float*)ln1_b, (const T*)wq,
                           (const T*)wk, (const T*)wv, (const T*)wo, (const T*)bo, (const float*)ln2_s,
                           (const float*)ln2_b, (const T*)wfc, (const T*)bfc, (const T*)wpr, (const T*)bpr, (Q*)kc,
                           (Q*)vc, (float*)ks, (float*)vs, (T*)h_out, (uint8_t*)new_mask, (int32_t*)new_length, L, B,
                           H, M, D, I, eps, act, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant(int cache_type, const void* h0, const void* start, const void* event_mask, const void* mask,
                 const void* active, const void* windows, const void* ln1_s, const void* ln1_b, const void* wq,
                 const void* wk, const void* wv, const void* wo, const void* bo, const void* ln2_s, const void* ln2_b,
                 const void* wfc, const void* bfc, const void* wpr, const void* bpr, void* kc, void* vc, void* ks,
                 void* vs, void* h_out, void* new_mask, void* new_length, int L, int B, int H, int M, int D, int I,
                 float eps, int act, int threads, void* stream) {
  if (cache_type == 1)
    return launch<T, int8_t>(h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk, wv, wo, bo, ln2_s,
                             ln2_b, wfc, bfc, wpr, bpr, kc, vc, ks, vs, h_out, new_mask, new_length, L, B, H, M, D, I,
                             eps, act, threads, stream);
  if (cache_type == 2)
    return launch<T, __nv_fp8_e4m3>(h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk, wv, wo, bo,
                                    ln2_s, ln2_b, wfc, bfc, wpr, bpr, kc, vc, ks, vs, h_out, new_mask, new_length, L,
                                    B, H, M, D, I, eps, act, threads, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (activations, caches, Dense weights and biases);
// LayerNorm parameters are always fp32. act: 0 = gelu (tanh form), 1 = relu.
// active may be null (every row active). Returns 0 when launched, -1 when no
// cluster of esgpt_decode_cluster_size(H) CTAs with the shared memory this
// shape needs fits on the card, else a CUDA error.
extern "C" int esgpt_decode_stack_step(int dtype, const void* h0, const void* start, const void* event_mask,
                                       const void* mask, const void* active, const void* windows,
                                       const void* ln1_s, const void* ln1_b, const void* wq, const void* wk,
                                       const void* wv, const void* wo, const void* bo, const void* ln2_s,
                                       const void* ln2_b, const void* wfc, const void* bfc, const void* wpr,
                                       const void* bpr, void* kc, void* vc, void* h_out, void* new_mask,
                                       void* new_length, int L, int B, int H, int M, int D, int I, float eps,
                                       int act, int threads, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk,
                                                 wv, wo, bo, ln2_s, ln2_b, wfc, bfc, wpr, bpr, kc, vc, nullptr,
                                                 nullptr, h_out, new_mask, new_length, L, B, H, M, D, I, eps, act,
                                                 threads, stream);
  return launch<float, float>(h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk, wv, wo, bo, ln2_s,
                              ln2_b, wfc, bfc, wpr, bpr, kc, vc, nullptr, nullptr, h_out, new_mask, new_length, L, B,
                              H, M, D, I, eps, act, threads, stream);
}

// The same step over a quantized cache: cache_type 1 = int8, 2 = fp8 (e4m3)
// codes in kc / vc, with fp32 scale tables ks / vs of shape (L, B, H, M),
// written at the cursor with the codes. Returns as esgpt_decode_stack_step,
// and cudaErrorInvalidValue for another cache type.
extern "C" int esgpt_decode_stack_step_quant(int dtype, int cache_type, const void* h0, const void* start,
                                             const void* event_mask, const void* mask, const void* active,
                                             const void* windows, const void* ln1_s, const void* ln1_b,
                                             const void* wq, const void* wk, const void* wv, const void* wo,
                                             const void* bo, const void* ln2_s, const void* ln2_b, const void* wfc,
                                             const void* bfc, const void* wpr, const void* bpr, void* kc, void* vc,
                                             void* ks, void* vs, void* h_out, void* new_mask, void* new_length, int L,
                                             int B, int H, int M, int D, int I, float eps, int act, int threads,
                                             void* stream) {
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(cache_type, h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk,
                                       wv, wo, bo, ln2_s, ln2_b, wfc, bfc, wpr, bpr, kc, vc, ks, vs, h_out, new_mask,
                                       new_length, L, B, H, M, D, I, eps, act, threads, stream);
  return launch_quant<float>(cache_type, h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk, wv, wo,
                             bo, ln2_s, ln2_b, wfc, bfc, wpr, bpr, kc, vc, ks, vs, h_out, new_mask, new_length, L, B,
                             H, M, D, I, eps, act, threads, stream);
}

// The CTAs of each slot row's cluster for H heads.
extern "C" int esgpt_decode_cluster_size(int H) { return cluster_size(H); }

#ifdef ESGPT_DECODE_TRACE
// Copies the per-CTA trace (1024 x 64 uint64) to host memory `dst`.
extern "C" int esgpt_decode_trace(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}
#endif
