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
// Bound. At the nested-attention training shape (N = 8192 rows, Q = 3, S = 4,
// H = 4, D = 64, bf16, the query a [:, 1:] view) the forward must move q, k,
// v, the keep-mask and the output once, 59.1 MB, 17.6 us at 3.35 TB/s; the
// backward q, k, v, g and the mask in and dq, dk, dv out, 105.3 MB, 31.4 us.
// Each does about 0.1 GFLOP of fp32 arithmetic, some 2 operations a byte, so
// both are bound by bytes; tensor cores have nothing to add (a (row, head) is
// a 3 x 4 x 64 product that shares no operand with any other). On an H100
// (700 W) a variant that moves the same bytes and computes nothing
// (-DESGPT_DG_COPY_ONLY=1) takes 18.3 / 38.7 us: the floor of this access
// pattern, 0.7 / 7.3 us above the bound.
//
// Design: a streaming kernel, all of whose time should be the card moving
// bytes, with as few dependent steps as possible between a row's loads and
// its stores.
//
// * Wide loads. A group of P lanes (a power of two, 4 to 32) owns one (row,
//   head) unit; a warp holds 32 / P units, consecutive in (row, head) order,
//   so at the training shape (8 lanes a head, 4 heads) a warp owns one whole
//   event row. Each lane holds CH 16-byte chunks of every D-long vector (8
//   bf16 or 4 fp32 values a chunk; CH = 2 only for fp32 heads over 128
//   wide), so every load and store is one 16-byte vector a lane, neighbouring
//   lanes on neighbouring addresses (a warp moves 512 contiguous bytes at the
//   training shape). Where D / (values a chunk x CH) is not a power of two
//   (bf16 D = 96: 12 of 16 lanes) the other lanes hold zeros. Loads and
//   stores stream (ld/st.global.cs); nothing is read twice. q, k, v and g
//   stay packed in registers, widened to fp32 where they are used.
// * All of a warp's loads before any arithmetic: q (all Q queries), k, v,
//   its keep-mask bytes and, in the backward, g: 5.7 KB a warp forward, 7.2
//   KB backward. The warp reads its row's keep-mask (48 bytes) once, one byte
//   a lane and (query, position) pair in ceil(Q S / P) rounds (2 warp-wide
//   loads), and __ballot_sync turns the bytes into a 64-bit mask a unit that
//   every lane of the group holds.
// * Independent reductions interleaved: all visible logits of a unit (9 at
//   the training shape; in the backward also the 9 products <g, v_s>) reduce
//   together over the lane group, log2(P) shuffle steps (3) for all of them,
//   in place of a chain per product.
// * Bytes in flight from occupancy: one warp a block, one warp tile a warp.
//   The registers (__launch_bounds__: at most 128 a thread forward, 168
//   backward; 80 and 133 used at the training shape, no spills) leave 25 / 15
//   warps resident an SM, each with its whole tile's loads in flight: over
//   100 KB an SM, against the ~20 KB the card needs to stream. A persistent
//   grid walking tiles with the next tile's loads in flight in registers
//   measured slower: the double buffer cost registers (spills, or 8 warps an
//   SM), and the hardware already starts a new warp as soon as one finishes.
// * The graph at compile time: the nested-attention graph (Q = 3 at
//   positions 1-3, S = 4, global) has its own instance, in which only the 9
//   visible pairs are computed and no mask is tested; any other graph up to 8
//   x 8 takes the instance that reads it from the shape.
// * Registers: the backward keeps no dk / dv accumulators across queries. It
//   first computes every probability and dL as scalars, then each output
//   vector in turn (dq per query, dk and dv per position), summing the same
//   terms in the same order as _bwd_kernel.
// * Deterministic: no atomics; each output element comes from one lane, so
//   two runs are bitwise equal.
//
// Sizes: Q and S at most kMaxPos (8), D a multiple of 32 up to 256, N * H
// below 2^31 (the wrapper checks all but the last; the entry points return
// cudaErrorInvalidValue). q may be a strided view: its row and query strides
// are arguments; its last two axes (H, D) must be contiguous. k, v, g and the
// outputs are contiguous. Alignment: every pointer on 16 bytes, and q's row
// and query strides (over axes longer than 1) multiples of 16 bytes; the
// entry points return cudaErrorMisalignedAddress otherwise, and the wrapper
// raises first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#ifndef ESGPT_DG_COPY_ONLY
// 1: a variant that moves the same bytes and computes nothing, the floor of
// this access pattern on the card (tools/ab_kernels.py times it beside the kernel).
#define ESGPT_DG_COPY_ONLY 0
#endif

namespace {

constexpr int kMaxPos = 8;
// Resident warps an SM the register budget is set for (__launch_bounds__; one
// warp a block): 128 registers a thread forward, 168 backward.
constexpr int kFwdWarps = 16, kBwdWarps = 12;
constexpr unsigned kFull = 0xffffffffu;

// One lane's share of a D-long vector: CH 16-byte chunks, as loaded.
template <int CH>
struct Vec {
  uint4 w[CH];
};

template <typename T>
__host__ __device__ constexpr int per_chunk() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void unpack(uint4 w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(uint4 w, float* f, __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// x rounded to T and back: the reference casts the probabilities to the value type.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Streaming loads and stores (ld/st.global.cs): nothing is read twice.
__device__ __forceinline__ uint4 ld_stream(const void* p) { return __ldcs(static_cast<const uint4*>(p)); }
__device__ __forceinline__ void st_stream(void* p, uint4 v) { __stcs(static_cast<uint4*>(p), v); }

// This lane's part of <a, b>, in fp32.
template <typename T, int CH>
__device__ __forceinline__ float dot(const Vec<CH>& a, const Vec<CH>& b) {
  constexpr int E = per_chunk<T>();
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float x[E], y[E];
    unpack(a.w[c], x, T());
    unpack(b.w[c], y, T());
#pragma unroll
    for (int e = 0; e < E; ++e) sum += x[e] * y[e];
  }
  return sum;
}

// acc += p * v on this lane's part.
template <typename T, int CH>
__device__ __forceinline__ void axpy(float p, const Vec<CH>& v, float (&acc)[CH * per_chunk<T>()]) {
  constexpr int E = per_chunk<T>();
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float x[E];
    unpack(v.w[c], x, T());
#pragma unroll
    for (int e = 0; e < E; ++e) acc[c * E + e] += p * x[e];
  }
}

// Sums every x[i] over the lane group of P lanes (P a power of two), all of
// them at once: log2(P) shuffle steps.
template <int M>
__device__ __forceinline__ void group_sum(float (&x)[M], int P) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < P) {
#pragma unroll
      for (int i = 0; i < M; ++i) x[i] += __shfl_xor_sync(kFull, x[i], off);
    }
  }
}

struct Shape {
  int64_t units, tiles;  // (row, head) units; warps, each 32 / group units
  int Q, S, H, D;
  int64_t q_row, q_step;  // q's strides (elements) over rows and queries
  int q_offset, window;   // window <= 0: global
  float keep_prob;
  int lanes, group;  // lanes of a group holding data; lanes a group (a power of two, >= 4)
};

// The graphs an instance serves. The nested-attention graph (3 queries at
// positions 1-3 over 4 positions, global) is fixed at compile time, so only
// its 9 visible pairs are computed; any other graph up to 8 x 8 is read from
// the shape at run time.
struct NestedGraph {
  static constexpr int kQ = 3, kS = 4;
  __device__ static constexpr bool visible(int qi, int s, const Shape&) { return s <= qi + 1; }
  static bool serves(const Shape& sh) {
    return sh.Q == kQ && sh.S == kS && sh.q_offset == 1 && (sh.window <= 0 || sh.window >= kS);
  }
};

struct AnyGraph {
  static constexpr int kQ = kMaxPos, kS = kMaxPos;
  __device__ static bool visible(int qi, int s, const Shape& sh) {
    const int q_pos = qi + sh.q_offset;
    return qi < sh.Q && s < sh.S && s <= q_pos && (sh.window <= 0 || s > q_pos - sh.window);
  }
};

// Where a lane works: its group's (row, head) unit and its place in the group.
struct Lane {
  int64_t n;
  int h, sub, base;  // head; lane within the group; the group's first lane
  bool unit, data;   // the unit exists; and this lane holds data of it
};

__device__ __forceinline__ Lane lane_at(int64_t tile, const Shape& sh) {
  const int lane = threadIdx.x;
  const int grp = lane / sh.group;
  Lane ln;
  ln.sub = lane % sh.group;
  ln.base = grp * sh.group;
  const int64_t u = tile * (32 / sh.group) + grp;
  ln.unit = u < sh.units;
  ln.data = ln.unit && ln.sub < sh.lanes;
  const int unit = ln.unit ? static_cast<int>(u) : 0;  // units < 2^31 (`valid`)
  ln.n = unit / sh.H;
  ln.h = unit % sh.H;
  return ln;
}

// Element offset of this lane's chunk c within a head's D values.
template <typename T>
__device__ __forceinline__ int column(int c, const Lane& ln, const Shape& sh) {
  return (c * sh.lanes + ln.sub) * per_chunk<T>();
}

// A unit's inputs, as this lane holds them. `keep`: the mask bytes this lane
// reads, for pairs j = r * P + sub (round r).
template <int CH, typename G, bool BWD>
struct Inputs {
  Vec<CH> q[G::kQ], k[G::kS], v[G::kS], g[BWD ? G::kQ : 1];
  uint32_t keep[(G::kQ * G::kS + 3) / 4];
};

template <typename T, int CH, typename G, bool BWD>
__device__ __forceinline__ void load(Inputs<CH, G, BWD>& in, const Lane& ln, const T* __restrict__ q,
                                     const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
                                     const uint8_t* __restrict__ keep, const Shape& sh) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int64_t hd = static_cast<int64_t>(ln.h) * sh.D, row = static_cast<int64_t>(sh.H) * sh.D;
  const T* qr = q + ln.n * sh.q_row + hd;
  const T* gr = BWD ? g + ln.n * sh.Q * row + hd : nullptr;
  const T* kr = k + ln.n * sh.S * row + hd;
  const T* vr = v + ln.n * sh.S * row + hd;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = column<T>(c, ln, sh);
#pragma unroll
    for (int qi = 0; qi < G::kQ; ++qi) {
      const bool ok = ln.data && qi < sh.Q;
      in.q[qi].w[c] = ok ? ld_stream(qr + qi * sh.q_step + col) : zero;
      if constexpr (BWD) in.g[qi].w[c] = ok ? ld_stream(gr + qi * row + col) : zero;
    }
#pragma unroll
    for (int s = 0; s < G::kS; ++s) {
      const bool ok = ln.data && s < sh.S;
      in.k[s].w[c] = ok ? ld_stream(kr + s * row + col) : zero;
      in.v[s].w[c] = ok ? ld_stream(vr + s * row + col) : zero;
    }
  }
  const int QS = sh.Q * sh.S;
#pragma unroll
  for (int r = 0; r < (G::kQ * G::kS + 3) / 4; ++r) {
    const int j = r * sh.group + ln.sub;
    in.keep[r] = keep != nullptr && ln.unit && j < QS ? __ldcs(keep + (ln.n * QS + j) * sh.H + ln.h) : 0u;
  }
}

// Bit j = qi * S + s set where the unit keeps pair (qi, s): every lane of a
// group gets its unit's mask from the bytes the group's lanes read.
template <int R>
__device__ __forceinline__ uint64_t keep_bits(const uint32_t (&bytes)[R], bool has_keep, const Lane& ln,
                                              const Shape& sh) {
  if (!has_keep) return ~0ull;
  const unsigned low = sh.group == 32 ? kFull : (1u << sh.group) - 1u;
  uint64_t bits = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r * sh.group < sh.Q * sh.S) {
      const unsigned b = __ballot_sync(kFull, bytes[r] != 0u);
      bits |= static_cast<uint64_t>((b >> ln.base) & low) << (r * sh.group);
    }
  }
  return bits;
}

__device__ __forceinline__ bool kept_at(uint64_t kept, int qi, int s, const Shape& sh) {
  return (kept >> (qi * sh.S + s)) & 1u;
}

// Softmax of query qi's visible logits x[qi * kS + s], in place (masked
// entries stay as they are); x may run on past the kQ x kS logits.
template <typename G, int X>
__device__ __forceinline__ void softmax(float (&x)[X], int qi, const Shape& sh) {
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < G::kS; ++s)
    if (G::visible(qi, s, sh)) m = fmaxf(m, x[qi * G::kS + s]);
  float denom = 0.0f;
#pragma unroll
  for (int s = 0; s < G::kS; ++s) {
    if (G::visible(qi, s, sh)) {
      x[qi * G::kS + s] = expf(x[qi * G::kS + s] - m);
      denom += x[qi * G::kS + s];
    }
  }
#pragma unroll
  for (int s = 0; s < G::kS; ++s)
    if (G::visible(qi, s, sh)) x[qi * G::kS + s] = x[qi * G::kS + s] / denom;
}

template <typename T, int CH>
__device__ __forceinline__ void store(T* dst, const float* acc, const Lane& ln, const Shape& sh) {
  constexpr int E = per_chunk<T>();
#pragma unroll
  for (int c = 0; c < CH; ++c) st_stream(dst + column<T>(c, ln, sh), pack(acc + c * E, T()));
}

template <typename T, int CH, typename G>
__device__ __forceinline__ void forward_unit(const Inputs<CH, G, false>& in, const Lane& ln, bool has_keep,
                                             T* __restrict__ out, const Shape& sh) {
  constexpr int E = per_chunk<T>(), Q = G::kQ, S = G::kS;
  T* const out_row = out + ((ln.n * sh.Q) * sh.H + ln.h) * sh.D;
  const int64_t out_step = static_cast<int64_t>(sh.H) * sh.D;
#if ESGPT_DG_COPY_ONLY
  {
    const uint64_t kept = keep_bits(in.keep, has_keep, ln, sh);
    for (int qi = 0; qi < Q; ++qi) {
      if (qi >= sh.Q || !ln.data) continue;
      for (int c = 0; c < CH; ++c) {
        uint4 w = in.q[qi].w[c];
        for (int s = 0; s < S; ++s) w.x ^= in.k[s].w[c].x ^ in.v[s].w[c].y;
        w.y ^= static_cast<uint32_t>(kept);
        st_stream(out_row + qi * out_step + column<T>(c, ln, sh), w);
      }
    }
    return;
  }
#endif
  float p[Q * S];
#pragma unroll
  for (int qi = 0; qi < Q; ++qi)
#pragma unroll
    for (int s = 0; s < S; ++s) p[qi * S + s] = G::visible(qi, s, sh) ? dot<T, CH>(in.q[qi], in.k[s]) : 0.0f;
  group_sum(p, sh.group);
  const uint64_t kept = keep_bits(in.keep, has_keep, ln, sh);
#pragma unroll
  for (int qi = 0; qi < Q; ++qi) {
    if (qi >= sh.Q) continue;
    softmax<G>(p, qi, sh);
    float acc[CH * E];
#pragma unroll
    for (int e = 0; e < CH * E; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (G::visible(qi, s, sh)) {
        float ps = p[qi * S + s];
        if (has_keep) ps = kept_at(kept, qi, s, sh) ? ps / sh.keep_prob : 0.0f;
        axpy<T, CH>(round_to(ps, T()), in.v[s], acc);
      }
    }
    if (ln.data) store<T, CH>(out_row + qi * out_step, acc, ln, sh);
  }
}

template <typename T, int CH, typename G>
__device__ __forceinline__ void backward_unit(const Inputs<CH, G, true>& in, const Lane& ln, bool has_keep,
                                              T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                              const Shape& sh) {
  constexpr int E = per_chunk<T>(), Q = G::kQ, S = G::kS, M = Q * S;
  const int64_t step = static_cast<int64_t>(sh.H) * sh.D;
  T* const dq_row = dq + ((ln.n * sh.Q) * sh.H + ln.h) * sh.D;
  const int64_t kv_at = ((ln.n * sh.S) * sh.H + ln.h) * sh.D;
#if ESGPT_DG_COPY_ONLY
  {
    const uint64_t kept = keep_bits(in.keep, has_keep, ln, sh);
    if (!ln.data) return;
    for (int qi = 0; qi < Q; ++qi) {
      if (qi >= sh.Q) continue;
      for (int c = 0; c < CH; ++c) {
        uint4 w = in.q[qi].w[c];
        w.x ^= in.g[qi].w[c].x;
        w.y ^= in.g[qi].w[c].y ^ static_cast<uint32_t>(kept);
        w.z ^= in.g[qi].w[c].z;
        w.w ^= in.g[qi].w[c].w;
        st_stream(dq_row + qi * step + column<T>(c, ln, sh), w);
      }
    }
    for (int s = 0; s < S; ++s) {
      if (s >= sh.S) continue;
      for (int c = 0; c < CH; ++c) {
        st_stream(dk + kv_at + s * step + column<T>(c, ln, sh), in.k[s].w[c]);
        st_stream(dv + kv_at + s * step + column<T>(c, ln, sh), in.v[s].w[c]);
      }
    }
    return;
  }
#endif
  float x[2 * M];  // logits then probabilities then dL in x[0, M); <g, v_s> then dP in x[M, 2M)
#pragma unroll
  for (int qi = 0; qi < Q; ++qi) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool on = G::visible(qi, s, sh);
      x[qi * S + s] = on ? dot<T, CH>(in.q[qi], in.k[s]) : 0.0f;
      x[M + qi * S + s] = on ? dot<T, CH>(in.g[qi], in.v[s]) : 0.0f;
    }
  }
  group_sum(x, sh.group);
  const uint64_t kept = keep_bits(in.keep, has_keep, ln, sh);
  float pc[M];  // the probabilities after dropout, rounded to T: dv's weights
#pragma unroll
  for (int qi = 0; qi < Q; ++qi) {
    if (qi >= sh.Q) continue;
    softmax<G>(x, qi, sh);
    float inner = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = qi * S + s;
      pc[i] = 0.0f;
      if (G::visible(qi, s, sh)) {
        // dP through the value-type cast (its derivative is the identity) and the dropout select.
        float pd = x[i], dp = x[M + i];
        if (has_keep) {
          const bool k_ = kept_at(kept, qi, s, sh);
          pd = k_ ? pd / sh.keep_prob : 0.0f;
          dp = k_ ? dp / sh.keep_prob : 0.0f;
        }
        pc[i] = round_to(pd, T());
        x[M + i] = dp;
      }
    }
    // Softmax backward on the probabilities before dropout.
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (G::visible(qi, s, sh)) inner += x[qi * S + s] * x[M + qi * S + s];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = qi * S + s;
      x[i] = G::visible(qi, s, sh) ? x[i] * (x[M + i] - inner) : 0.0f;
    }
  }
  // dq, one query at a time: sum over positions of dL k_s.
#pragma unroll
  for (int qi = 0; qi < Q; ++qi) {
    if (qi >= sh.Q) continue;
    float acc[CH * E];
#pragma unroll
    for (int e = 0; e < CH * E; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (G::visible(qi, s, sh)) axpy<T, CH>(x[qi * S + s], in.k[s], acc);
    if (ln.data) store<T, CH>(dq_row + qi * step, acc, ln, sh);
  }
  // dk and dv, one position at a time: sums over queries of dL q and cast(p') g.
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s >= sh.S) continue;
    float ak[CH * E], av[CH * E];
#pragma unroll
    for (int e = 0; e < CH * E; ++e) ak[e] = av[e] = 0.0f;
#pragma unroll
    for (int qi = 0; qi < Q; ++qi) {
      if (G::visible(qi, s, sh)) {
        axpy<T, CH>(x[qi * S + s], in.q[qi], ak);
        axpy<T, CH>(pc[qi * S + s], in.g[qi], av);
      }
    }
    if (ln.data) {
      store<T, CH>(dk + kv_at + s * step, ak, ln, sh);
      store<T, CH>(dv + kv_at + s * step, av, ln, sh);
    }
  }
}

// One warp a block, one warp tile (32 / group units) a warp: every load of
// the tile is issued before any arithmetic, and the card keeps as many warps
// resident as the registers allow, each with its loads in flight.
template <typename T, int CH, typename G>
__global__ void __launch_bounds__(32, kFwdWarps)
    dep_graph_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ keep, T* __restrict__ out, Shape sh) {
  const Lane ln = lane_at(blockIdx.x, sh);
  Inputs<CH, G, false> in;
  load<T>(in, ln, q, k, v, static_cast<const T*>(nullptr), keep, sh);
  forward_unit<T>(in, ln, keep != nullptr, out, sh);
}

template <typename T, int CH, typename G>
__global__ void __launch_bounds__(32, kBwdWarps)
    dep_graph_bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ keep, const T* __restrict__ g, T* __restrict__ dq,
                  T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  const Lane ln = lane_at(blockIdx.x, sh);
  Inputs<CH, G, true> in;
  load<T>(in, ln, q, k, v, g, keep, sh);
  backward_unit<T>(in, ln, keep != nullptr, dq, dk, dv, sh);
}

// The launches, one struct per direction so that `dispatch` can take each as a template.
template <typename T, int CH, typename G>
struct Fwd {
  static int run(const void* q, const void* k, const void* v, const void* keep, void* out, Shape sh,
                 cudaStream_t stream) {
    dep_graph_fwd<T, CH, G><<<static_cast<unsigned>(sh.tiles), 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(keep), static_cast<T*>(out), sh);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int CH, typename G>
struct Bwd {
  static int run(const void* q, const void* k, const void* v, const void* keep, const void* g, void* dq, void* dk,
                 void* dv, Shape sh, cudaStream_t stream) {
    dep_graph_bwd<T, CH, G><<<static_cast<unsigned>(sh.tiles), 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(keep), static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), sh);
    return static_cast<int>(cudaGetLastError());
  }
};

// Dispatches on the value type, the chunks a lane holds (fp32 heads over 128
// wide take two) and the graph.
template <template <typename, int, typename> class Launch, typename... Args>
int dispatch(int dtype, const Shape& sh, Args... args) {
  const bool nested = NestedGraph::serves(sh);
  if (dtype == 1)
    return nested ? Launch<__nv_bfloat16, 1, NestedGraph>::run(args...) : Launch<__nv_bfloat16, 1, AnyGraph>::run(args...);
  if (sh.D <= 128) return nested ? Launch<float, 1, NestedGraph>::run(args...) : Launch<float, 1, AnyGraph>::run(args...);
  return nested ? Launch<float, 2, NestedGraph>::run(args...) : Launch<float, 2, AnyGraph>::run(args...);
}

Shape make_shape(int dtype, long long N, int Q, int S, int H, int D, long long q_row, long long q_step, int q_offset,
                 int window, float keep_prob) {
  Shape sh;
  sh.Q = Q;
  sh.S = S;
  sh.H = H;
  sh.D = D;
  sh.q_row = q_row;
  sh.q_step = q_step;
  sh.q_offset = q_offset;
  sh.window = window;
  sh.keep_prob = keep_prob;
  const int chunks = D / (dtype == 1 ? 8 : 4);  // 16-byte chunks a head
  sh.lanes = chunks > 32 ? chunks / 2 : chunks;
  sh.group = 4;
  while (sh.group < sh.lanes) sh.group *= 2;
  sh.units = N * H;
  const int per_tile = 32 / sh.group;
  sh.tiles = (sh.units + per_tile - 1) / per_tile;
  return sh;
}

bool valid(long long N, int Q, int S, int H, int D) {
  // At most 2^31 - 1 warps (one a block), each 1 to 8 units.
  return N >= 0 && N * H <= (1ll << 31) - 1 && Q >= 1 && Q <= kMaxPos && S >= 1 && S <= kMaxPos && H >= 1 &&
         D >= 32 && D <= 32 * 8 && D % 32 == 0;
}

// Every pointer on 16 bytes, q's row and query strides (over axes longer than 1) multiples of 16 bytes.
bool aligned(int dtype, long long N, int Q, long long q_row, long long q_step,
             std::initializer_list<const void*> ptrs) {
  const long long esz = dtype == 1 ? 2 : 4;
  if ((N > 1 && (q_row * esz) % 16 != 0) || (Q > 1 && (q_step * esz) % 16 != 0)) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace

// dtype: 1 for bf16, 0 for fp32. keep: a (N, Q, S, H) uint8 keep-mask, or null
// without dropout. window <= 0: global. Returns the CUDA error of the launch (0 on success).
extern "C" int esgpt_dep_graph_fwd(int dtype, const void* q, long long q_row, long long q_step, const void* k,
                                   const void* v, const void* keep, void* out, long long N, int Q, int S, int H, int D,
                                   int q_offset, int window, float keep_prob, void* stream) {
  if (!valid(N, Q, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(dtype, N, Q, q_row, q_step, {q, k, v, out})) return static_cast<int>(cudaErrorMisalignedAddress);
  if (N == 0) return 0;
  const Shape sh = make_shape(dtype, N, Q, S, H, D, q_row, q_step, q_offset, window, keep_prob);
  return dispatch<Fwd>(dtype, sh, q, k, v, keep, out, sh, static_cast<cudaStream_t>(stream));
}

extern "C" int esgpt_dep_graph_bwd(int dtype, const void* q, long long q_row, long long q_step, const void* k,
                                   const void* v, const void* keep, const void* g, void* dq, void* dk, void* dv,
                                   long long N, int Q, int S, int H, int D, int q_offset, int window, float keep_prob,
                                   void* stream) {
  if (!valid(N, Q, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(dtype, N, Q, q_row, q_step, {q, k, v, g, dq, dk, dv})) return static_cast<int>(cudaErrorMisalignedAddress);
  if (N == 0) return 0;
  const Shape sh = make_shape(dtype, N, Q, S, H, D, q_row, q_step, q_offset, window, keep_prob);
  return dispatch<Bwd>(dtype, sh, q, k, v, keep, g, dq, dk, dv, sh, static_cast<cudaStream_t>(stream));
}
