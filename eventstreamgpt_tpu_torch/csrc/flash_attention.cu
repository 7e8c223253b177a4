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
// Bound. At the packed training shape (B = 8, H = 4, S = 1024, D = 64, bf16,
// 4-7 subjects a row) the forward must move q, k, v, o, the segment ids and
// the row statistics once (17.07 MB, 5.10 us at 3.35 TB/s) and the backward
// also do, dq, dk and dv (33.85 MB, 10.10 us); the allowed (q, k) pairs (28%
// of the causal triangle) need 1.2 and 3.0 GFLOP, about 1 and 3 us on the
// tensor cores: the function is bound by bytes.
//
// Design: tiles of 64 queries by 64 keys, one block per (b * H + h, tile).
//
// 1. Tiles skipped by segment. Warp 0 of every block reads the segment ids of
//    the tiles its own tile could pair with (16-byte loads, one tile a lane),
//    takes each tile's [min, max] over its real ids (>= 0) and whether it
//    holds padding (< 0), and lists the tiles inside the causal and window
//    range whose intervals meet its own, or that hold padding when its own
//    does (ops/flash_attention.py::tile_schedule is the same predicate in
//    PyTorch). Disjoint intervals share no id, so no allowed pair is ever
//    skipped; with ids that do not decrease along a row, as the packing
//    writes them, every listed tile holds an allowed pair (41.8% of the
//    causal tiles on the packed batch). Forward and dq blocks walk the key
//    tiles their query tile lists, dkv blocks the query tiles that list
//    their key tile, the diagonal tile first: it is always listed, so it
//    loads while the list is built. Inside a visited tile the per-element
//    mask decides, except where the schedule marks both tiles as one segment
//    without padding below the diagonal and inside the window (a third of
//    the visited tiles). Masked logits are -inf and their probability exactly
//    0, so no masked value is added to anything (the TPU kernel adds a finite
//    -0.7 * FLT_MAX instead).
// 2. bf16: tensor-core products. Four warps a block, each owning 16 rows of
//    the tile (FlashAttention-2's layout), compute every product with
//    mma.sync.aligned.m16n8k16 (bf16 in, fp32 accumulation): Q K^T and P V
//    forward; Q K^T, dO V^T and dS K for dq; K Q^T, V dO^T, P^T dO and
//    dS^T Q for dk and dv. Operands come from shared memory through ldmatrix
//    (.trans where the staged tile is the product's right-hand side along
//    its rows); the operand a block keeps (Q, and dO for dq; K and V for dkv)
//    is read into registers once, and the probability tile stays in
//    registers and becomes the A operand of the next product. mma.sync
//    rather than wgmma: the 64 x 64 tiles at D <= 64 are small, and the
//    accumulator layout of mma.sync is its A-operand layout, so P^T and dS^T
//    feed the backward's products with no shuffle; wgmma's descriptors and
//    swizzled layouts are a later step (see the times below).
// 3. bf16: staging. Tiles live in shared memory as bf16, rows padded by 16
//    bytes so that the eight rows an ldmatrix reads fall in distinct banks,
//    loaded with 16-byte cp.async and double-buffered: tile i + 1 loads while
//    tile i computes, two barriers a tile (a third buffer measured no faster:
//    a tile's compute, not its load, sets the pace). exp is one ex2.approx
//    instruction on s log2(e) - m log2(e).
// 4. di = sum(o * do) (fp32, over the rounded output, as the TPU kernel
//    takes it) is computed by the dq kernel for its 64 queries and written,
//    with m log2(e) and 1 / l, for the dkv kernel, which runs after it.
// 5. Launch order: blockIdx.x walks (b, h) and blockIdx.y the tiles, the
//    heaviest first (the last query tiles, the first key tiles), so that the
//    long blocks do not start in the grid's last wave.
// The fp32 instances keep fp32 FMAs outside the tensor cores (TF32 would not
// hold fp32 results) on tiles staged as fp32, with the same tile schedule.
//
// Rounding follows the TPU kernels: forward, exp(s - m) is rounded to the
// value type before P V and l sums the unrounded values; backward, P is
// recomputed as exp(s - m) / l from the saved statistics and rounded before
// dV, dS = P (dP - di) is fp32 and rounded before dK and dQ, dP an fp32
// accumulation of the value-type do and v. Two backward kernels, no atomics
// on any output (the one atomic add a block goes to the tile counter that
// esgpt_flash_tiles reads): two runs are bitwise equal.
//
// Registers (nvcc -Xptxas -v, sm_90a, no spills) and dynamic shared memory
// at S = 1024, D = 64 (D = 32):
//   bf16 forward 153 (132) registers, 38,980 (22,596) bytes, 3 blocks an SM;
//   bf16 dq      167 (127) registers, the same bytes, 3 blocks an SM;
//   bf16 dk/dv   168 (161) registers, the same bytes, 3 blocks an SM;
//   fp32 forward 124 (80), dq 128 (128), dk/dv 128 (128) registers at 256
//   threads; 67,140 (42,564), 84,548 (51,780), 101,188 (68,420) bytes.
// At D = 128 a thread holds 64 fp32 accumulators (128 in dk/dv) beside its
// kept operand fragments, so the forward and dk/dv kernels are compiled for
// two blocks an SM (mma_min_blocks): bf16 forward 238, dq 246 and dk/dv 255
// registers (dk/dv spills 4 bytes), 71,748 bytes, two blocks an SM; fp32
// forward 128, dq 128, dk/dv 180 registers, no spills. The same tiles and
// schedule; on an H100 (700 W) at (8, 8, 1024, 128) on the packed batch the
// bf16 kernels take about 3x the bytes bound forward and 4.6x backward
// (PERF.md).
// On an H100 (700 W) at the packed shape the bf16 kernels take about 4x the
// bytes bound forward and 6x backward (tools/ab_flash.py, --trace for the
// per-block record, on the global timer): a block walks 3.6 tiles on average
// and up to 9; its start (staging its first tiles while the whole grid reads
// q, k and v) takes 5.5 (forward), 7.2 (dq) and 4.2 us (dk/dv) of a median
// block of 11.8, 14.6 and 13.6 us; a tile costs 1.8, 2.3 and 2.9 us of
// issue-bound compute at three blocks an SM; and the heaviest blocks set
// each kernel's span.
//
// Layout: q, k, v, o, do, dq, dk and dv are read and written by stride (the
// model's projections are (B, S, H, D) tensors viewed as (B, H, S, D)), with
// the D axis contiguous and 16-byte aligned rows (the wrapper checks); seg is
// (B, S) int32; stats (2, B, H, S) fp32 (m, then l) and the backward's rows
// (3, B, H, S) fp32 scratch, all contiguous and 16-byte aligned. S must be a
// multiple of 64; D is 32, 64 or 128 (bench.py's production widths: 8 heads
// of 128 at hidden 1,024).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // queries and keys per tile

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

template <typename T>
__device__ __forceinline__ T* row_ptr(T* x, const View& vw, int b, int h, int s) {
  return x + b * vw.b + h * vw.h + static_cast<int64_t>(s) * vw.s;
}

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

// Blocks start in the order of blockIdx.x, then blockIdx.y: x walks the
// (b, h) pairs and y the tiles, the heaviest first (the last query tiles,
// which have the most key tiles to walk, and the first key tiles).
__device__ __forceinline__ int block_query_tile() { return gridDim.y - 1 - blockIdx.y; }
__device__ __forceinline__ int block_key_tile() { return blockIdx.y; }

// ---------------------------------------------------------------- tile schedule

// A schedule entry is a tile index, flagged when the two tiles hold one and
// the same real segment id and no padding.
constexpr int kOneSegment = 1 << 30;
__device__ __forceinline__ int tile_of(int entry) { return entry & (kOneSegment - 1); }

// Whether every (query, key) pair of query tile qt and key tile kt is
// visible: one segment, below the diagonal, and inside the window.
__device__ __forceinline__ bool all_visible(int entry, int qt, int kt, int window) {
  return (entry & kOneSegment) && kt < qt && (window <= 0 || kt * kTile > qt * kTile + kTile - 1 - window);
}

// A tile's real segment ids span [lo, hi] (lo > hi: none); pad: it holds a negative id.
struct Range {
  int lo, hi;
  bool pad;
};

__device__ __forceinline__ Range tile_range(const int* __restrict__ seg_row, int t) {
  const int4* ids = reinterpret_cast<const int4*>(seg_row + t * kTile);
  Range r{INT_MAX, INT_MIN, false};
#pragma unroll
  for (int i = 0; i < kTile / 4; ++i) {
    const int4 x = __ldg(ids + i);
    const int v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] >= 0) {
        r.lo = min(r.lo, v[j]);
        r.hi = max(r.hi, v[j]);
      } else {
        r.pad = true;
      }
    }
  }
  return r;
}

// The tiles the blocks walked since esgpt_flash_tiles last read them, by
// kernel (0 forward, 1 dq, 2 dk/dv; both types): one atomic add a block,
// into this counter only, so no output depends on the order of blocks.
__device__ unsigned long long g_tiles[3];

// Lists the tiles t in [first, last] that tile `own` pairs with
// (ops/flash_attention.py::tile_schedule's predicate): `own` itself first
// (it always pairs with itself, and the caller starts loading it before the
// list exists), then the others in ascending order, flagged kOneSegment
// where that applies; returns their count, and adds it to g_tiles[kernel].
// `own` is `first` or `last`. Warp 0 works, lane i on tile first + 32 j + i:
// for up to 32 candidates, one round of loads. Every thread of the block
// must call it.
__device__ int build_schedule(const int* __restrict__ seg_row, int own, int first, int last, int* list, int* count,
                              int kernel) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Range r = tile_range(seg_row, min(first + lane, last));
    Range mine;
    if (own - first < 32) {
      mine.lo = __shfl_sync(0xffffffffu, r.lo, own - first);
      mine.hi = __shfl_sync(0xffffffffu, r.hi, own - first);
      mine.pad = __shfl_sync(0xffffffffu, static_cast<int>(r.pad), own - first);
    } else {
      mine = tile_range(seg_row, own);
    }
    int n = 1;
    for (int base = first; base <= last; base += 32) {
      const int t = base + lane;
      if (base > first) r = tile_range(seg_row, min(t, last));
      const bool ok = t <= last && t != own && (max(mine.lo, r.lo) <= min(mine.hi, r.hi) || (mine.pad && r.pad));
      const bool one = !mine.pad && !r.pad && mine.lo == mine.hi && r.lo == r.hi && r.lo == mine.lo;
      const unsigned vote = __ballot_sync(0xffffffffu, ok);
      if (ok) list[n + __popc(vote & ((1u << lane) - 1u))] = t | (one ? kOneSegment : 0);
      n += __popc(vote);
    }
    if (lane == 0) {
      list[0] = own;
      *count = n;
      atomicAdd(&g_tiles[kernel], static_cast<unsigned long long>(n));
    }
  }
  __syncthreads();
  return *count;
}

// ---------------------------------------------------------------- per-block trace

// Compiled only with -DESGPT_FLASH_TRACE (tools/ab_flash.py --trace): for each
// block of the latest launch of each bf16 kernel (0 forward, 1 dq, 2 dk/dv),
// the global timer (ns) at its start, at the start of its tile walk and at
// its end, its SM and the number of tiles it walked.
#ifdef ESGPT_FLASH_TRACE
constexpr int kTraceBlocks = 1 << 14;
__device__ unsigned long long g_trace[3][kTraceBlocks][5];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Trace {
  int kernel;
  unsigned long long t0, t1;
  __device__ void start(int k) {
    kernel = k;
    t0 = global_ns();
  }
  __device__ void walk() { t1 = global_ns(); }
  __device__ void end(int n) {
    const int block = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x != 0 || block >= kTraceBlocks) return;
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* r = g_trace[kernel][block];
    r[0] = t0;
    r[1] = t1;
    r[2] = global_ns();
    r[3] = sm;
    r[4] = n;
  }
};
#else
struct Trace {
  __device__ void start(int) {}
  __device__ void walk() {}
  __device__ void end(int) {}
};
#endif

// ---------------------------------------------------------------- bf16: mma.sync kernels

constexpr int kMmaThreads = 128;  // four warps, 16 rows of the tile each
constexpr float kLog2e = 1.4426950408889634f;

// Blocks an SM the forward and dk/dv kernels are compiled for. At D = 128 a
// thread holds 64 fp32 accumulators (128 in dk/dv) and 32 (64) registers of
// operand fragments, more than the 170 registers three blocks allow.
template <int D>
constexpr int mma_min_blocks() {
  return D <= 64 ? 3 : 2;
}

template <int D>
struct Tiles {
  static constexpr int kLd = D + 8;               // padded row, in elements (16 bytes more than D)
  static constexpr int kElems = kTile * kLd;      // one staged 64-row tile
  static constexpr int kBytes = kElems * 2;
  static constexpr int kChunks = kTile * D / 8;   // its 16-byte pieces
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows s0 .. s0 + 63 of head (b, h) of x into a padded bf16 tile.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ x, const View& vw, int b, int h, int s0) {
  const bf16* base = row_ptr(x, vw, b, h, s0);
  constexpr int kPer = D / 8;
#pragma unroll
  for (int c = 0; c < Tiles<D>::kChunks / kMmaThreads; ++c) {
    const int i = c * kMmaThreads + threadIdx.x;
    const int r = i / kPer, piece = i % kPer;
    cp_async16(smem_u32(dst + r * Tiles<D>::kLd + piece * 8), base + r * vw.s + piece * 8);
  }
}

// 64 consecutive 32-bit words (segment ids or row statistics) into shared memory;
// `lane0` is the first of the 16 threads that copy them.
__device__ __forceinline__ void load_words(void* dst, const void* __restrict__ src, int lane0) {
  const int i = threadIdx.x - lane0;
  if (i >= 0 && i < 16) cp_async16(smem_u32(static_cast<char*>(dst) + 16 * i), static_cast<const char*>(src) + 16 * i);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16 x 16 bf16 A fragment, a 16 x 8 bf16 B fragment (b0, b1), fp32 c.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (flushing results below 2^-126 to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment addresses in a padded tile, for lane `l` of a warp:
//   a_addr: the A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 15, or,
//           with ldmatrix.trans, the B fragments of two 8-column groups
//           (c0, c0 + 8) over rows r0 .. r0 + 15 (rows along the product's depth);
//   b_addr: without .trans, the B fragments of two 8-row groups (r0, r0 + 8)
//           over columns c0 .. c0 + 15 (columns along the depth).
template <int D>
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int r0, int c0, int l) {
  return smem_u32(tile + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * Tiles<D>::kLd + c0 + (l >> 4) * 8);
}
template <int D>
__device__ __forceinline__ uint32_t b_addr(const bf16* tile, int r0, int c0, int l) {
  return smem_u32(tile + (r0 + (l & 7) + (l >> 4) * 8) * Tiles<D>::kLd + c0 + ((l >> 3) & 1) * 8);
}

// The A fragments of this warp's 16 rows of a staged tile, over all of D.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t (&f)[D / 16][4], const bf16* tile, int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(f[ks], a_addr<D>(tile, warp * 16, ks * 16, lane));
}

// acc[n][*] (n over D / 8 column groups) of rows (g, g + 8) of this warp, scaled, to x.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ x, const View& vw, int b, int h, int row0,
                                           const float (&acc)[D / 8][4], float scale0, float scale1, int g, int t) {
  bf16* r0 = row_ptr(x, vw, b, h, row0 + g);
  bf16* r1 = row_ptr(x, vw, b, h, row0 + g + 8);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] * scale0, acc[n][1] * scale0);
    *reinterpret_cast<__nv_bfloat162*>(r1 + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] * scale1, acc[n][3] * scale1);
  }
}

// Accumulator element e of n-tile u in a 16-row by 16-column chunk: row g + 8 (e >> 1),
// column 8 u + 2 t + (e & 1). Two such n-tiles make one A fragment.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x0)[4], const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

template <int D>
constexpr int mma_smem_bytes(int n_tiles) {
  // four staged tiles, two buffers of 4 x 64 words, the schedule and its count
  return 4 * Tiles<D>::kBytes + 2 * 4 * kTile * 4 + (n_tiles + 1) * 4;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<D>())
    mma_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ stats, Problem p) {
  Trace trace;
  trace.start(0);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);     // [2] key tiles
  bf16* sV = sK + 2 * Tiles<D>::kElems;         // [2] value tiles
  // [2][4 x 64] words: the first 64 of each buffer hold its key tile's segment ids.
  int* sSeg = reinterpret_cast<int*>(sV + 2 * Tiles<D>::kElems);
  int* list = sSeg + 2 * 4 * kTile;
  int* count = list + p.S / kTile;

  const int qt = block_query_tile(), bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;

  auto load_kv = [&](int kt, int buf) {
    load_tile<D>(sK + buf * Tiles<D>::kElems, k, p.k, b, h, kt * kTile);
    load_tile<D>(sV + buf * Tiles<D>::kElems, v, p.v, b, h, kt * kTile);
    load_words(sSeg + buf * 4 * kTile, seg_row + kt * kTile, 0);
  };
  // The query tile goes to the second key buffer, read into registers before
  // the walk; the diagonal tile, always visited first, loads while the
  // schedule is built.
  load_tile<D>(sK + Tiles<D>::kElems, q, p.q, b, h, q0);
  load_kv(qt, 0);
  cp_async_commit();
  const int n = build_schedule(seg_row, qt, first_key_tile(qt, p.window), qt, list, count, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_rows<D>(qf, sK + Tiles<D>::kElems, warp, lane);
  __syncthreads();

  int qi[2], seg_q[2];
  float m[2], l[2], acc[D / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + warp * 16 + g + 8 * r;
    seg_q[r] = seg_row[qi[r]];
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;

  trace.walk();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load_kv(tile_of(list[i + 1]), (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = i & 1, kt = tile_of(list[i]), k0 = kt * kTile;
    const bool masked = !all_visible(list[i], qt, kt, p.window);
    const bf16* tK = sK + buf * Tiles<D>::kElems;
    const bf16* tV = sV + buf * Tiles<D>::kElems;
    const int* tSeg = sSeg + buf * 4 * kTile;

    // S = Q K^T: this warp's 16 rows by 64 keys, eight n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, b_addr<D>(tK, j * 16, ks * 16, lane));
        mma(s[2 * j], qf[ks], kb[0], kb[1]);
        mma(s[2 * j + 1], qf[ks], kb[2], kb[3]);
      }

    if (masked) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = j * 8 + 2 * t + c;
            if (!visible(qi[r], k0 + col, seg_q[r], tSeg[col], p.window)) s[j][2 * r + c] = -INFINITY;
          }
    }

    // Online softmax; each row's four owners are one quad of lanes.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) tile_max = fmaxf(tile_max, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(tile_max));
      // exp(x - m_new) as exp2(x log2(e) - m_new log2(e)); with nothing seen
      // yet (m_new = -inf) every x is -inf and exp2(-inf) = 0. alpha rescales
      // what was summed so far (0 while m is still -inf).
      const float ms = m_new == -INFINITY ? 0.0f : m_new * kLog2e;
      const float alpha = exp2_approx(fmaf(m[r], kLog2e, -ms));
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * r + c];
          x = exp2_approx(fmaf(x, kLog2e, -ms));
          part += x;
        }
      l[r] = l[r] * alpha + quad_sum(part);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 as the A operand, 16 keys at a time.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t vb[4];
        ldsm_x4_t(vb, a_addr<D>(tV, kc * 16, dc * 16, lane));
        mma(acc[2 * dc], pa, vb[0], vb[1]);
        mma(acc[2 * dc + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // buffer `buf` is free for tile i + 2
  }

  trace.end(n);
  // l >= 1: a query always sees itself.
  store_rows<D>(o, p.o, b, h, q0 + warp * 16, acc, 1.0f / l[0], 1.0f / l[1], g, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t at = static_cast<int64_t>(bh) * p.S + qi[r];
      stats[at] = m[r];
      stats[static_cast<int64_t>(p.B) * p.H * p.S + at] = l[r];
    }
  }
}

// dq for one query tile, over the key tiles it sees. It first writes, for
// each of the tile's queries, the three numbers dkv reads per query into
// rows (3, B, H, S): di = sum(o * do), m log2(e) and 1 / l.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    mma_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ seg, const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ stats, float* __restrict__ rows, bf16* __restrict__ dq, Problem p) {
  Trace trace;
  trace.start(1);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + 2 * Tiles<D>::kElems;
  // [2][4 x 64] words: the first 64 of each buffer hold its key tile's segment ids; the
  // second buffer's next 64 hold the query tile's di.
  int* sSeg = reinterpret_cast<int*>(sV + 2 * Tiles<D>::kElems);
  float* sDi = reinterpret_cast<float*>(sSeg + 5 * kTile);
  int* list = sSeg + 2 * 4 * kTile;
  int* count = list + p.S / kTile;

  const int qt = block_query_tile(), bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;

  const int64_t bhs = static_cast<int64_t>(p.B) * p.H * p.S;
  auto load_kv = [&](int kt, int buf) {
    load_tile<D>(sK + buf * Tiles<D>::kElems, k, p.k, b, h, kt * kTile);
    load_tile<D>(sV + buf * Tiles<D>::kElems, v, p.v, b, h, kt * kTile);
    load_words(sSeg + buf * 4 * kTile, seg_row + kt * kTile, 0);
  };
  // The query and cotangent tiles go to the second buffers, read into
  // registers before the walk; the diagonal tile, always visited first, loads
  // while di and the schedule are computed.
  load_tile<D>(sK + Tiles<D>::kElems, q, p.q, b, h, q0);
  load_tile<D>(sV + Tiles<D>::kElems, dout, p.g, b, h, q0);
  load_kv(qt, 0);
  cp_async_commit();

  // di of the tile's 64 rows: two threads a row, 16-byte loads of o and do.
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const uint4* ro = reinterpret_cast<const uint4*>(row_ptr(o, p.o, b, h, q0 + r) + half * (D / 2));
    const uint4* rg = reinterpret_cast<const uint4*>(row_ptr(dout, p.g, b, h, q0 + r) + half * (D / 2));
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint4 a = ro[c], z = rg[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* z2 = reinterpret_cast<const __nv_bfloat162*>(&z);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(z2[e]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      const int64_t at = static_cast<int64_t>(bh) * p.S + q0 + r;
      sDi[r] = sum;
      rows[at] = sum;
      rows[bhs + at] = stats[at] * kLog2e;
      rows[2 * bhs + at] = 1.0f / stats[bhs + at];
    }
  }

  const int n = build_schedule(seg_row, qt, first_key_tile(qt, p.window), qt, list, count, 1);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_rows<D>(qf, sK + Tiles<D>::kElems, warp, lane);
  load_rows<D>(gf, sV + Tiles<D>::kElems, warp, lane);

  int qi[2], seg_q[2];
  float ms[2], il[2], dr[2], acc[D / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const int64_t at = static_cast<int64_t>(bh) * p.S + q0 + row;
    qi[r] = q0 + row;
    seg_q[r] = seg_row[qi[r]];
    ms[r] = stats[at] * kLog2e;
    il[r] = 1.0f / stats[bhs + at];
    dr[r] = sDi[row];
  }
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;
  __syncthreads();  // the second buffers and sDi are read

  trace.walk();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load_kv(tile_of(list[i + 1]), (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = i & 1, kt = tile_of(list[i]), k0 = kt * kTile;
    const bool masked = !all_visible(list[i], qt, kt, p.window);
    const bf16* tK = sK + buf * Tiles<D>::kElems;
    const bf16* tV = sV + buf * Tiles<D>::kElems;
    const int* tSeg = sSeg + buf * 4 * kTile;

#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // 16 keys at a time
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, b_addr<D>(tK, kc * 16, ks * 16, lane));
        mma(s[0], qf[ks], kb[0], kb[1]);
        mma(s[1], qf[ks], kb[2], kb[3]);
        ldsm_x4(vb, b_addr<D>(tV, kc * 16, ks * 16, lane));
        mma(dp[0], gf[ks], vb[0], vb[1]);
        mma(dp[1], gf[ks], vb[2], vb[3]);
      }
      // P = exp(s - m) / l, masked to 0; then dS = P (dP - di).
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] = exp2_approx(fmaf(s[u][e], kLog2e, -ms[e >> 1])) * il[e >> 1];
      if (masked) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = kc * 16 + u * 8 + 2 * t + (e & 1);
            if (!visible(qi[r], k0 + col, seg_q[r], tSeg[col], p.window)) s[u][e] = 0.0f;
          }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] *= dp[u][e] - dr[e >> 1];
      uint32_t da[4];
      to_a(da, s[0], s[1]);
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t kb[4];
        ldsm_x4_t(kb, a_addr<D>(tK, kc * 16, dc * 16, lane));
        mma(acc[2 * dc], da, kb[0], kb[1]);
        mma(acc[2 * dc + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }
  trace.end(n);
  store_rows<D>(dq, p.dq, b, h, q0 + warp * 16, acc, 1.0f, 1.0f, g, t);
}

// dk and dv for one key tile, over the query tiles that see it; rows is
// what the dq kernel wrote: di, m log2(e) and 1 / l of every query.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<D>())
    mma_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ rows,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  Trace trace;
  trace.start(2);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [2] query tiles
  bf16* sG = sQ + 2 * Tiles<D>::kElems;      // [2] cotangent tiles
  // [2][4][64]: each query tile's segment ids, di, m log2(e) and 1 / l.
  float* sVec = reinterpret_cast<float*>(sG + 2 * Tiles<D>::kElems);
  int* list = reinterpret_cast<int*>(sVec + 2 * 4 * kTile);
  int* count = list + p.S / kTile;

  const int kt = block_key_tile(), bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kTile, n_tiles = p.S / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;
  const int64_t bhs = static_cast<int64_t>(p.B) * p.H * p.S;
  const float* di_row = rows + static_cast<int64_t>(bh) * p.S;

  auto load_qg = [&](int qt, int buf) {
    const int q0 = qt * kTile;
    float* vec = sVec + buf * 4 * kTile;
    load_tile<D>(sQ + buf * Tiles<D>::kElems, q, p.q, b, h, q0);
    load_tile<D>(sG + buf * Tiles<D>::kElems, dout, p.g, b, h, q0);
    load_words(vec, seg_row + q0, 0);
    load_words(vec + kTile, di_row + q0, 16);
    load_words(vec + 2 * kTile, di_row + bhs + q0, 32);
    load_words(vec + 3 * kTile, di_row + 2 * bhs + q0, 48);
  };
  // The key and value tiles go to the second buffers, read into registers
  // before the walk; the diagonal query tile, always visited first, loads
  // while the schedule is built.
  load_tile<D>(sQ + Tiles<D>::kElems, k, p.k, b, h, k0);
  load_tile<D>(sG + Tiles<D>::kElems, v, p.v, b, h, k0);
  load_qg(kt, 0);
  cp_async_commit();
  const int n = build_schedule(seg_row, kt, kt, last_query_tile(kt, p.window, n_tiles), list, count, 2);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_rows<D>(kf, sQ + Tiles<D>::kElems, warp, lane);
  load_rows<D>(vf, sG + Tiles<D>::kElems, warp, lane);
  __syncthreads();

  int kj[2], seg_k[2];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = k0 + warp * 16 + g + 8 * r;
    seg_k[r] = seg_row[kj[r]];
  }
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.0f;

  trace.walk();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load_qg(tile_of(list[i + 1]), (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = i & 1, qt = tile_of(list[i]), q0 = qt * kTile;
    const bool masked = !all_visible(list[i], qt, kt, p.window);
    const bf16* tQ = sQ + buf * Tiles<D>::kElems;
    const bf16* tG = sG + buf * Tiles<D>::kElems;
    const int* tSeg = reinterpret_cast<const int*>(sVec + buf * 4 * kTile);
    const float* tDi = sVec + buf * 4 * kTile + kTile;
    const float* tMs = tDi + kTile;
    const float* tIl = tMs + kTile;

#pragma unroll
    for (int qc = 0; qc < 4; ++qc) {  // 16 queries at a time; rows keys, columns queries
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t qb[4], gb[4];
        ldsm_x4(qb, b_addr<D>(tQ, qc * 16, ks * 16, lane));
        mma(s[0], kf[ks], qb[0], qb[1]);
        mma(s[1], kf[ks], qb[2], qb[3]);
        ldsm_x4(gb, b_addr<D>(tG, qc * 16, ks * 16, lane));
        mma(dp[0], vf[ks], gb[0], gb[1]);
        mma(dp[1], vf[ks], gb[2], gb[3]);
      }
      // P^T = exp(s - m) / l, masked to 0; then dS^T = P^T (dP^T - di).
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc * 16 + u * 8 + 2 * t + (e & 1);
          s[u][e] = exp2_approx(fmaf(s[u][e], kLog2e, -tMs[col])) * tIl[col];
        }
      if (masked) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = qc * 16 + u * 8 + 2 * t + (e & 1);
            if (!visible(q0 + col, kj[r], tSeg[col], seg_k[r], p.window)) s[u][e] = 0.0f;
          }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[u][e] = s[u][e] * (dp[u][e] - tDi[qc * 16 + u * 8 + 2 * t + (e & 1)]);
      uint32_t pa[4], da[4];
      to_a(pa, s[0], s[1]);
      to_a(da, dp[0], dp[1]);
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t gb[4], qb[4];
        ldsm_x4_t(gb, a_addr<D>(tG, qc * 16, dc * 16, lane));
        mma(dv_acc[2 * dc], pa, gb[0], gb[1]);
        mma(dv_acc[2 * dc + 1], pa, gb[2], gb[3]);
        ldsm_x4_t(qb, a_addr<D>(tQ, qc * 16, dc * 16, lane));
        mma(dk_acc[2 * dc], da, qb[0], qb[1]);
        mma(dk_acc[2 * dc + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();
  }
  trace.end(n);
  store_rows<D>(dk, p.dk, b, h, k0 + warp * 16, dk_acc, 1.0f, 1.0f, g, t);
  store_rows<D>(dv, p.dv, b, h, k0 + warp * 16, dv_acc, 1.0f, 1.0f, g, t);
}

// ---------------------------------------------------------------- fp32: FMA kernels
//
// 256 threads as a 16 x 16 grid, each owning a 4 x 4 patch of the 64 x 64
// logits tile (rows ty*4 .. ty*4+3, columns tx, tx+16, tx+32, tx+48) and the
// same rows' output columns tx + 16c. A row's 16 owners are one half-warp, so
// row max and sum reduce with four shuffles. Tile rows are padded to D + 1
// floats so that the half-warp's 16 different key rows fall in 16 banks.

constexpr int kFmaThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = 4;          // tile rows per thread: kTile / 16
constexpr int kCols = 4;          // logits columns per thread: kTile / 16
constexpr int kPLd = kTile + 1;   // padded row stride of a 64 x 64 probability tile

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

// Copies rows s0 .. s0 + 63 of head (b, h) of x into dst (row stride D + 1).
template <int D>
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ x, const View& vw, int b,
                                      int h, int s0) {
  const float* base = row_ptr(x, vw, b, h, s0);
  for (int i = threadIdx.x; i < kTile * D; i += kFmaThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = base[r * vw.s + c];
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

template <int D>
__device__ __forceinline__ void write_patch(float* __restrict__ x, const View& vw, int b, int h, int s0, int ty,
                                            int tx, const float (&acc)[kRows][D / 16]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float* row = row_ptr(x, vw, b, h, s0 + ty * kRows + i);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

// Shared memory in 4-byte words, the schedule (n_tiles + 1 words) included.
template <int D>
constexpr int fma_fwd_words(int n_tiles) {
  return 3 * kTile * (D + 1) + kTile * kPLd + 2 * kTile + n_tiles + 1;
}
template <int D>
constexpr int fma_dkv_words(int n_tiles) {
  return 4 * kTile * (D + 1) + 2 * kTile * kPLd + 5 * kTile + n_tiles + 1;
}
template <int D>
constexpr int fma_dq_words(int n_tiles) {
  return 4 * kTile * (D + 1) + kTile * kPLd + 5 * kTile + n_tiles + 1;
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
    fma_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const int* __restrict__ seg, float* __restrict__ o, float* __restrict__ stats, Problem p) {
  extern __shared__ float smem_f[];
  float* sQ = smem_f;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);
  int* seg_q = reinterpret_cast<int*>(sP + kTile * kPLd);
  int* seg_k = seg_q + kTile;
  int* list = seg_k + kTile;
  int* count = list + p.S / kTile;

  const int qt = block_query_tile(), bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;

  stage<D>(sQ, q, p.q, b, h, q0);
  if (threadIdx.x < kTile) seg_q[threadIdx.x] = seg_row[q0 + threadIdx.x];
  const int n = build_schedule(seg_row, qt, first_key_tile(qt, p.window), qt, list, count, 0);

  float m[kRows], l[kRows], acc[kRows][D / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.0f;
  }

  for (int it = 0; it < n; ++it) {
    const int k0 = tile_of(list[it]) * kTile;
    __syncthreads();  // the previous tile's sK, sV and sP are no longer read
    stage<D>(sK, k, p.k, b, h, k0);
    stage<D>(sV, v, p.v, b, h, k0);
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
        sP[r * kPLd + tx + 16 * j] = pj;
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
      const int64_t at = static_cast<int64_t>(bh) * p.S + q0 + ty * kRows + i;
      stats[at] = m[i];
      stats[static_cast<int64_t>(p.B) * p.H * p.S + at] = l[i];
    }
  }
  write_patch<D>(o, p.o, b, h, q0, ty, tx, acc);
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
    fma_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const int* __restrict__ seg, const float* __restrict__ g, const float* __restrict__ stats,
                const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv, Problem p) {
  extern __shared__ float smem_f[];
  float* sK = smem_f;
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
  int* list = seg_q + kTile;
  int* count = list + p.S / kTile;

  const int kt = block_key_tile(), bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_tiles = p.S / kTile;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;
  const float* m_row = stats + static_cast<int64_t>(bh) * p.S;
  const float* l_row = m_row + static_cast<int64_t>(p.B) * p.H * p.S;
  const float* di_row = di + static_cast<int64_t>(bh) * p.S;

  stage<D>(sK, k, p.k, b, h, k0);
  stage<D>(sV, v, p.v, b, h, k0);
  if (threadIdx.x < kTile) seg_k[threadIdx.x] = seg_row[k0 + threadIdx.x];
  const int n = build_schedule(seg_row, kt, kt, last_query_tile(kt, p.window, n_tiles), list, count, 2);

  float dk_acc[kRows][D / 16], dv_acc[kRows][D / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int it = 0; it < n; ++it) {
    const int q0 = tile_of(list[it]) * kTile;
    __syncthreads();
    stage<D>(sQ, q, p.q, b, h, q0);
    stage<D>(sG, g, p.g, b, h, q0);
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
        sPt[r * kPLd + c] = pij;
        sDt[r * kPLd + c] = pij * (dp[i][j] - s_di[c]);
      }
    }
    __syncthreads();
    patch_accumulate<D>(sPt, sG, ty, tx, dv_acc);
    patch_accumulate<D>(sDt, sQ, ty, tx, dk_acc);
  }
  write_patch<D>(dk, p.dk, b, h, k0, ty, tx, dk_acc);
  write_patch<D>(dv, p.dv, b, h, k0, ty, tx, dv_acc);
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
    fma_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const int* __restrict__ seg, const float* __restrict__ o, const float* __restrict__ g,
               const float* __restrict__ stats, float* __restrict__ di, float* __restrict__ dq, Problem p) {
  extern __shared__ float smem_f[];
  float* sQ = smem_f;
  float* sG = sQ + kTile * (D + 1);
  float* sK = sG + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sD = sV + kTile * (D + 1);  // dS: rows queries, columns keys
  float* s_m = sD + kTile * kPLd;
  float* s_il = s_m + kTile;  // 1 / l
  float* s_di = s_il + kTile;
  int* seg_q = reinterpret_cast<int*>(s_di + kTile);
  int* seg_k = seg_q + kTile;
  int* list = seg_k + kTile;
  int* count = list + p.S / kTile;

  const int qt = block_query_tile(), bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int* seg_row = seg + static_cast<int64_t>(b) * p.S;

  stage<D>(sQ, q, p.q, b, h, q0);
  stage<D>(sG, g, p.g, b, h, q0);
  if (threadIdx.x < kTile) {
    const int64_t at = static_cast<int64_t>(bh) * p.S + q0 + threadIdx.x;
    const float* ro = row_ptr(o, p.o, b, h, q0 + threadIdx.x);
    const float* rg = row_ptr(g, p.g, b, h, q0 + threadIdx.x);
    float sum = 0.0f;
    for (int d = 0; d < D; ++d) sum = fmaf(ro[d], rg[d], sum);
    seg_q[threadIdx.x] = seg_row[q0 + threadIdx.x];
    s_m[threadIdx.x] = stats[at];
    s_il[threadIdx.x] = 1.0f / stats[static_cast<int64_t>(p.B) * p.H * p.S + at];
    s_di[threadIdx.x] = sum;
    di[at] = sum;  // for the dkv kernel, launched after this one
  }
  const int n = build_schedule(seg_row, qt, first_key_tile(qt, p.window), qt, list, count, 1);

  float dq_acc[kRows][D / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq_acc[i][c] = 0.0f;

  for (int it = 0; it < n; ++it) {
    const int k0 = tile_of(list[it]) * kTile;
    __syncthreads();
    stage<D>(sK, k, p.k, b, h, k0);
    stage<D>(sV, v, p.v, b, h, k0);
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
        sD[r * kPLd + c] = pij * (dp[i][j] - s_di[r]);
      }
    }
    __syncthreads();
    patch_accumulate<D>(sD, sK, ty, tx, dq_acc);
  }
  write_patch<D>(dq, p.dq, b, h, q0, ty, tx, dq_acc);
}

// ---------------------------------------------------------------- launches

// Sets a kernel's dynamic shared memory (above the 48 KB default where
// needed), then launches it on a (B * H, S / 64) grid.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int smem_bytes, const Problem& p, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)  // as many blocks an SM as registers allow, not fewer for want of shared memory
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, p.S / kTile);
  kernel<<<grid, threads, smem_bytes, stream>>>(args..., p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_fwd(int dtype, const void* q, const void* k, const void* v, const int* seg, void* o, float* stats,
            const Problem& p, cudaStream_t stream) {
  const int n_tiles = p.S / kTile;
  if (dtype == 1)
    return launch(mma_fwd<D>, kMmaThreads, mma_smem_bytes<D>(n_tiles), p, stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg, static_cast<bf16*>(o), stats);
  return launch(fma_fwd<D>, kFmaThreads, fma_fwd_words<D>(n_tiles) * 4, p, stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v), seg, static_cast<float*>(o), stats);
}

// dq first: it writes di, which dkv reads.
template <int D>
int run_bwd(int dtype, const void* q, const void* k, const void* v, const int* seg, const void* o, const void* g,
            const float* stats, float* rows, void* dq, void* dk, void* dv, const Problem& p, cudaStream_t stream) {
  const int n_tiles = p.S / kTile;
  if (dtype == 1) {
    const bf16 *tq = static_cast<const bf16*>(q), *tk = static_cast<const bf16*>(k), *tv = static_cast<const bf16*>(v);
    const bf16 *to = static_cast<const bf16*>(o), *tg = static_cast<const bf16*>(g);
    const int err = launch(mma_bwd_dq<D>, kMmaThreads, mma_smem_bytes<D>(n_tiles), p, stream, tq, tk, tv, seg, to,
                           tg, stats, rows, static_cast<bf16*>(dq));
    if (err != 0) return err;
    return launch(mma_bwd_dkv<D>, kMmaThreads, mma_smem_bytes<D>(n_tiles), p, stream, tq, tk, tv, seg, tg,
                  static_cast<const float*>(rows), static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  }
  const float *tq = static_cast<const float*>(q), *tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float *to = static_cast<const float*>(o), *tg = static_cast<const float*>(g);
  const int err = launch(fma_bwd_dq<D>, kFmaThreads, fma_dq_words<D>(n_tiles) * 4, p, stream, tq, tk, tv, seg, to, tg,
                         stats, rows, static_cast<float*>(dq));
  if (err != 0) return err;
  return launch(fma_bwd_dkv<D>, kFmaThreads, fma_dkv_words<D>(n_tiles) * 4, p, stream, tq, tk, tv, seg, tg, stats,
                static_cast<const float*>(rows), static_cast<float*>(dk), static_cast<float*>(dv));
}

View view(const long long* strides, int i) { return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]}; }

bool valid(int dtype, int B, int H, int S, int D) {
  return (dtype == 0 || dtype == 1) && B >= 0 && H >= 1 && S >= 0 && S % kTile == 0 &&
         (D == 32 || D == 64 || D == 128) && S / kTile <= 65535 && static_cast<long long>(B) * H <= INT_MAX;  // the grid's y and x dimensions
}

}  // namespace

// dtype: 1 for bf16, 0 for fp32. strides: (b, h, s) element strides of q, k,
// v, o (forward) or q, k, v, o, do, dq, dk, dv (backward), three each. rows:
// (3, B, H, S) fp32 scratch (di, then m log2(e) and 1 / l for bf16). window
// <= 0: global. Returns the CUDA error of the launches (0 on success).
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
  if (D == 32) return run_fwd<32>(dtype, q, k, v, seg, o, stats, p, st);
  if (D == 64) return run_fwd<64>(dtype, q, k, v, seg, o, stats, p, st);
  return run_fwd<128>(dtype, q, k, v, seg, o, stats, p, st);
}

extern "C" int esgpt_flash_bwd(int dtype, const void* q, const void* k, const void* v, const int* seg, const void* o,
                               const void* g, const float* stats, float* rows, void* dq, void* dk, void* dv,
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
  p.o = view(strides, 3);
  p.g = view(strides, 4);
  p.dq = view(strides, 5);
  p.dk = view(strides, 6);
  p.dv = view(strides, 7);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32) return run_bwd<32>(dtype, q, k, v, seg, o, g, stats, rows, dq, dk, dv, p, st);
  if (D == 64) return run_bwd<64>(dtype, q, k, v, seg, o, g, stats, rows, dq, dk, dv, p, st);
  return run_bwd<128>(dtype, q, k, v, seg, o, g, stats, rows, dq, dk, dv, p, st);
}

// Copies the tiles walked since the last call (3 uint64: forward, dq, dk/dv)
// to host memory `dst`, after the launches before it, and zeroes them.
extern "C" int esgpt_flash_tiles(unsigned long long* dst) {
  const unsigned long long zeros[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(dst, g_tiles, sizeof(g_tiles));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_tiles, zeros, sizeof(g_tiles));
  return static_cast<int>(err);
}

#ifdef ESGPT_FLASH_TRACE
// Copies the per-block trace (3 x 16384 x 5 uint64) to host memory `dst`.
extern "C" int esgpt_flash_trace(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}
#endif
