// One CI decode step through the whole transformer layer stack (kernel B).
//
// Replaces the TPU kernel eventstreamgpt_tpu/ops/pallas_decode_step.py::
// decode_stack_step (_stack_kernel / _layer_math): per layer LN1 -> q/k/v ->
// cursor write into the KV cache -> masked, unscaled fp32-softmax attention
// over the whole cache buffer (per-layer window, 0 = global) -> out-proj +
// residual -> LN2 -> MLP + residual -> event-mask zeroing. Returns h before
// ln_f, and writes the new padding mask (this event's bit at the cursor) and
// lengths (cursor + 1); rows whose `active` bit is 0 keep their old mask and
// length there (the attention itself always sees the new mask, as in JAX).
//
// Design: the step mixes no rows and its layers are sequential per row, so
// one thread block serves one slot row and loops over the L layers; no grid
// sync is needed. Shared memory holds the row's residual stream, the LN
// output, q, the attention output, the H x M scores and the MLP
// intermediate, all fp32. The projections are mat-vecs in the block: weights
// are (L, in, out) row-major (the flax kernel layout), thread j owns output
// column j, so a warp's loads of one weight row are coalesced and no
// reduction is needed; LayerNorm and softmax use warp-shuffle block
// reductions summed in a fixed order. Activations round to the compute type
// (bf16 or fp32) at the points where the JAX layer rounds, so the kernel
// tracks the plain version to bf16 rounding.
//
// The new k/v are written into the cache at each row's cursor IN PLACE (the
// JAX kernel returns new arrays); a cursor at or past M writes nothing, as
// the JAX one-hot write matches nothing there.
//
// Bound: the step's output depends only on the cache positions that pass the
// causal, window and padding tests, so its bytes are the weights (about
// 3.1 MB in bf16 at the serving shape) plus K and V at those live positions:
// at most 32 per row on the local layer and cursor + 1 on the global one.
// With prompts of 128-192 events that is about 6 MB of cache, so roughly
// 9-10 MB a step, about 3 us at 3.35 TB/s (chip_smoke.py computes it from the
// captured inputs). The kernel skips K at masked positions but reads V over
// the whole buffer (their probabilities are 0), the 16.8 MB the JAX kernel
// reads. With one block per slot (32 blocks on 132 SMs) and scalar mat-vecs
// it sits far from the bound; a split over (row, head), live-range V reads
// and tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kF32Min = -3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Rounds an fp32 value to the compute type and back.
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread gets the result. `red` holds 32 floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) r += red[i];
  return r;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = -INFINITY;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) r = fmaxf(r, red[i]);
  return r;
}

// flax LayerNorm: fp32 stats, var = max(0, E[x^2] - E[x]^2),
// (x - mean) * (rsqrt(var + eps) * scale) + bias, rounded to T.
template <typename T>
__device__ void layer_norm(const float* x, float* y, const float* scale, const float* bias, int E, float eps,
                           float* red) {
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    s += x[i];
    ss += x[i] * x[i];
  }
  const float mean = block_sum(s, red) / E;
  const float meansq = block_sum(ss, red) / E;
  const float inv = 1.0f / sqrtf(fmaxf(0.f, meansq - mean * mean) + eps);
  for (int i = threadIdx.x; i < E; i += blockDim.x) y[i] = rnd<T>((x[i] - mean) * (inv * scale[i]) + bias[i]);
  __syncthreads();
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fmaxf(x, 0.f);
  const float c = 0.7978845608028654f;  // sqrt(2 / pi): flax's tanh-form gelu
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

template <typename T>
__global__ void decode_stack_kernel(const T* __restrict__ h0, const int32_t* __restrict__ start,
                                    const uint8_t* __restrict__ event_mask, const uint8_t* __restrict__ mask,
                                    const uint8_t* __restrict__ active, const int32_t* __restrict__ windows,
                                    const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                                    const T* __restrict__ wq,
                                    const T* __restrict__ wk, const T* __restrict__ wv, const T* __restrict__ wo,
                                    const T* __restrict__ bo, const float* __restrict__ ln2_s,
                                    const float* __restrict__ ln2_b, const T* __restrict__ wfc,
                                    const T* __restrict__ bfc, const T* __restrict__ wpr,
                                    const T* __restrict__ bpr, T* kc, T* vc, T* __restrict__ h_out,
                                    uint8_t* __restrict__ new_mask, int32_t* __restrict__ new_length, int L,
                                    int B, int H, int M, int D, int I, float eps, int act) {
  extern __shared__ float smem[];
  const int E = H * D;
  float* x = smem;        // E: residual stream
  float* n = x + E;       // E: LayerNorm output
  float* q = n + E;       // E: query
  float* o = q + E;       // E: attention output
  float* s = o + E;       // H * M: scores, then probabilities
  float* f = s + H * M;   // I: MLP intermediate
  float* red = f + I;     // 32: reduction scratch
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int st = start[b];
  const bool ev = event_mask[b] != 0;
  const bool live = active == nullptr || active[b] != 0;
  const uint8_t* mrow = mask + (size_t)b * M;

  // The layer-shared cache tracking: this event's bit at the cursor.
  for (int m = tid; m < M; m += nt) new_mask[(size_t)b * M + m] = (live && m == st) ? (uint8_t)ev : mrow[m];
  if (tid == 0) new_length[b] = live ? st + 1 : st;
  for (int i = tid; i < E; i += nt) x[i] = to_f(h0[(size_t)b * E + i]);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t cache_row = ((size_t)l * B + b) * H * M * D;  // cache layout (L, B, H, M, D)
    const T* Wq = wq + (size_t)l * E * E;
    const T* Wk = wk + (size_t)l * E * E;
    const T* Wv = wv + (size_t)l * E * E;
    const T* Wo = wo + (size_t)l * E * E;
    const T* Wfc = wfc + (size_t)l * E * I;
    const T* Wpr = wpr + (size_t)l * I * E;

    layer_norm<T>(x, n, ln1_s + (size_t)l * E, ln1_b + (size_t)l * E, E, eps, red);

    // q/k/v projections; k/v land in the cache at the row's cursor, in place.
    for (int j = tid; j < E; j += nt) {
      float aq = 0.f, ak = 0.f, av = 0.f;
      for (int i = 0; i < E; ++i) {
        const float ni = n[i];
        const size_t w = (size_t)i * E + j;
        aq += ni * to_f(Wq[w]);
        ak += ni * to_f(Wk[w]);
        av += ni * to_f(Wv[w]);
      }
      q[j] = rnd<T>(aq);
      if (st >= 0 && st < M) {
        const size_t c = cache_row + ((size_t)(j / D) * M + st) * D + (j % D);
        kc[c] = from_f<T>(ak);
        vc[c] = from_f<T>(av);
      }
    }
    __syncthreads();

    // Scores: unscaled fp32 q.k; causal (k <= cursor), window, padding mask.
    const int w = windows[l];
    for (int e = tid; e < H * M; e += nt) {
      const int h = e / M, m = e % M;
      const bool ok = m <= st && (w <= 0 || m > st - w) && (m == st ? ev : mrow[m] != 0);
      float acc = kF32Min;
      if (ok) {
        const T* kr = kc + cache_row + ((size_t)h * M + m) * D;
        const float* qh = q + h * D;
        acc = 0.f;
        for (int d = 0; d < D; ++d) acc += qh[d] * to_f(kr[d]);
      }
      s[e] = acc;
    }
    __syncthreads();

    // Softmax per head in fp32; probabilities rounded to the value type.
    for (int h = 0; h < H; ++h) {
      float* sh = s + h * M;
      float mx = -INFINITY;
      for (int m = tid; m < M; m += nt) mx = fmaxf(mx, sh[m]);
      mx = block_max(mx, red);
      float sum = 0.f;
      for (int m = tid; m < M; m += nt) {
        const float e = expf(sh[m] - mx);
        sh[m] = e;
        sum += e;
      }
      sum = block_sum(sum, red);
      for (int m = tid; m < M; m += nt) sh[m] = rnd<T>(sh[m] / sum);
      __syncthreads();
    }

    // Probabilities x values over the whole buffer (masked weights are 0).
    for (int j = tid; j < E; j += nt) {
      const int h = j / D, d = j % D;
      const T* vr = vc + cache_row + (size_t)h * M * D + d;
      const float* ph = s + h * M;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) acc += ph[m] * to_f(vr[(size_t)m * D]);
      o[j] = rnd<T>(acc);
    }
    __syncthreads();

    // Out-projection + bias + attention residual.
    for (int j = tid; j < E; j += nt) {
      float acc = 0.f;
      for (int i = 0; i < E; ++i) acc += o[i] * to_f(Wo[(size_t)i * E + j]);
      const float y = rnd<T>(rnd<T>(acc) + to_f(bo[(size_t)l * E + j]));
      x[j] = rnd<T>(y + x[j]);
    }
    __syncthreads();

    layer_norm<T>(x, n, ln2_s + (size_t)l * E, ln2_b + (size_t)l * E, E, eps, red);

    for (int j = tid; j < I; j += nt) {
      float acc = 0.f;
      for (int i = 0; i < E; ++i) acc += n[i] * to_f(Wfc[(size_t)i * I + j]);
      const float y = rnd<T>(rnd<T>(acc) + to_f(bfc[(size_t)l * I + j]));
      f[j] = rnd<T>(activate(y, act));
    }
    __syncthreads();

    // MLP projection + residual, then the between-layer event-mask zeroing.
    for (int j = tid; j < E; j += nt) {
      float acc = 0.f;
      for (int i = 0; i < I; ++i) acc += f[i] * to_f(Wpr[(size_t)i * E + j]);
      const float y = rnd<T>(rnd<T>(acc) + to_f(bpr[(size_t)l * E + j]));
      x[j] = ev ? rnd<T>(x[j] + y) : 0.f;
    }
    __syncthreads();
  }

  for (int i = tid; i < E; i += nt) h_out[(size_t)b * E + i] = from_f<T>(x[i]);
}

template <typename T>
int launch(const void* h0, const void* start, const void* event_mask, const void* mask, const void* active,
           const void* windows, const void* ln1_s, const void* ln1_b, const void* wq, const void* wk, const void* wv,
           const void* wo,
           const void* bo, const void* ln2_s, const void* ln2_b, const void* wfc, const void* bfc,
           const void* wpr, const void* bpr, void* kc, void* vc, void* h_out, void* new_mask, void* new_length,
           int L, int B, int H, int M, int D, int I, float eps, int act, int threads, void* stream) {
  const size_t smem = (size_t)(4 * H * D + H * M + I + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_stack_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)h0, (const int32_t*)start, (const uint8_t*)event_mask, (const uint8_t*)mask,
      (const uint8_t*)active, (const int32_t*)windows, (const float*)ln1_s, (const float*)ln1_b, (const T*)wq,
      (const T*)wk, (const T*)wv, (const T*)wo, (const T*)bo, (const float*)ln2_s, (const float*)ln2_b, (const T*)wfc,
      (const T*)bfc, (const T*)wpr, (const T*)bpr, (T*)kc, (T*)vc, (T*)h_out, (uint8_t*)new_mask,
      (int32_t*)new_length, L, B, H, M, D, I, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (activations, caches, Dense weights and biases);
// LayerNorm parameters are always fp32. act: 0 = gelu (tanh form), 1 = relu.
// active may be null (every row active). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int esgpt_decode_stack_step(int dtype, const void* h0, const void* start, const void* event_mask,
                                       const void* mask, const void* active, const void* windows,
                                       const void* ln1_s, const void* ln1_b, const void* wq, const void* wk,
                                       const void* wv, const void* wo, const void* bo, const void* ln2_s,
                                       const void* ln2_b, const void* wfc, const void* bfc, const void* wpr,
                                       const void* bpr, void* kc, void* vc, void* h_out, void* new_mask,
                                       void* new_length, int L, int B, int H, int M, int D, int I, float eps,
                                       int act, int threads, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16>(h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk, wv, wo, bo,
                                 ln2_s, ln2_b, wfc, bfc, wpr, bpr, kc, vc, h_out, new_mask, new_length, L, B, H, M,
                                 D, I, eps, act, threads, stream);
  return launch<float>(h0, start, event_mask, mask, active, windows, ln1_s, ln1_b, wq, wk, wv, wo, bo, ln2_s, ln2_b,
                       wfc, bfc, wpr, bpr, kc, vc, h_out, new_mask, new_length, L, B, H, M, D, I, eps, act, threads,
                       stream);
}
