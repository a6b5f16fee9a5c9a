// One layer of the folded dense D-MPNN block, in CUDA C++ for sm_90a, with
// the two ends of the whole-encoder kernel folded into its first and last
// launch, and a variant of the layer that double-buffers its tiles.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_mpnn.py:
//   - fused_dense_mpnn_block / _block_kernel (with its operator
//     _edge_adjacency) and fused_dense_mpnn_block_stash /
//     _block_kernel_stash: dense_mpnn_layer, launched once per layer;
//   - fused_dense_encoder_fwd / _encoder_kernel(_stash): the same launches,
//     with the V->E gather in the first and the masked E->V scatter in the
//     last (both in one launch at depth 1);
//   - fused_dense_mpnn_block_dbuf / _dbuf_kernel: dense_mpnn_dbuf_layer.
// The Python wrapper (notorch_tpu_torch/kernels/dense_mpnn.py) launches a
// kernel once per layer and ping-pongs the edge state between two buffers
// (or writes it into the stash). A launch with neither end runs
// dense_mpnn_plain_kernel; the encoder's first and last launches run
// dense_mpnn_ends_kernel, the same steps with the ends folded in.
//
// Per bin b, with rev(e) = e ^ 1 (edges interleaved in reverse pairs):
//   keep[e,e'] = src[e] == dst[e'] && emask[e']
//   sum:  A[e,e'] = keep[e,e'] && e' != rev(e)
//   mean: A[e,e'] = keep[e,e'] / max(indeg(e), 1) - [e' == rev(e)],
//         indeg(e) = sum_e' keep[e,e']
//   h_out = (h_in +) bias + A @ (relu(h_in) @ W)
// The rev subtraction is folded into A exactly as the TPU kernel folds it, so
// padded edge lanes come out the same as there, not as the unfolded form.
// The encoder's ends, per bin:
//   gather (first layer): h_in[e] = nf[src[e]] + ef[e]   (unmasked; a src
//                         outside [0, V) gathers zero, as a one-hot would)
//   scatter (last layer): nh[v] = sum_e [dst[e] == v] * emask[e] * h_out[e],
//                         divided by max(that count, 1) for mean
//
// Grid: (bin, 64-column slice of d); 256 threads per block.
//   1. The block stages src/dst/emask of its bin and builds A's nonzero pattern
//      as one bit row per edge ([E][ceil(E/32)] words, 8 KiB at E = 256); the
//      scatter also builds one bit row per node of the edges it sums.
//   2. mW[:, slice] = relu(h_in[b]) @ W[:, slice] by k-tiled shared-memory f32
//      FMA (32-deep k tiles of h and W); mW stays in shared memory. Each
//      thread loads its share of the next tile into registers, in 16-byte
//      vectors, while the block computes on the current one. The gather adds
//      nf[src[e]] to each h vector as it is loaded, so h0 is never stored.
//   3. Each output row walks the set bits of its A row and sums the mW rows
//      they name: the row-sparse form of A @ mW, with no E x E product. The
//      residual reads are issued eight rows at a time (the gather's residual
//      is nf[src] + ef again, the same values the product used).
//   4. The scatter: the block keeps its output slice in shared memory, and
//      each node row sums the output rows of its set bits in ascending edge
//      order. The block owns every edge of its bin for its columns, so the
//      sum needs no atomics and its order is fixed.
// The double-buffered layer (dense_mpnn_dbuf_layer) differs in step 2 only:
// the tiles of h and W go from device memory to shared memory by cp.async in
// a two-stage pipeline (the next tile's copies in flight while the block
// computes on this one, cp.async.wait_group between stages) instead of
// through registers, and relu is applied in shared memory once a tile has
// landed (a copy cannot transform what it moves; applying it where the FMA
// loop reads the tile adds one instruction for every four FMAs). Its FMAs
// are row 1's in the same order, so it gives row 1's bits.
//
// What bounds it: the work is exact f32 (no TF32, no bf16), so the floor is
// the CUDA-core f32 rate (67 TFLOP/s on an H100 SXM at 700 W). The W products
// need depth * 2 * B * E * d^2 operations and A @ mW only 2 * nnz(A) * d per
// layer, a few per row for molecules; the gather and scatter add B * E * d
// each; the bytes (read h0 or nf and ef, W, b and the index arrays once,
// write the outputs once) take about a tenth as long. So it is bound by
// operations, and the design spends them only where A is nonzero and keeps
// the device-memory latency behind the FMAs. It does not reach that floor:
// the product phase is plain FMA from shared memory with no tensor cores, one
// launch per layer re-reads h_in from device memory (it stays in the 50 MB
// L2 at these shapes), and every column slice of a bin rebuilds the same bit
// rows. Moving the state into shared memory for the whole depth and the
// products onto wgmma is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCols = 64;       // output columns per block
constexpr int kKTile = 32;      // k depth of one staged tile
constexpr int kThreads = 256;
constexpr int kMaxEdges = 256;  // edge lanes per bin these kernels take
constexpr int kMaxNodes = 256;  // node slots per bin the scatter takes
constexpr int kResGroup = 8;    // residual reads in flight per thread in step 3
constexpr int kRowStep = kThreads / kCols;  // rows a block pass covers in steps 3 and 4
constexpr int kHStride = kKTile + 4;        // row of the dbuf h tile: 16-byte aligned

// The pointers and sizes of one layer launch. The kernels take the pointers
// as __restrict__ parameters (no two of them alias, so the compiler may load
// the read-only ones through the non-coherent path and move loads past the
// stores) and bundle them into a LayerArgs for the device functions.
struct LayerArgs {
  const float* h_in;   // [B, E, d] the layer's input; ef when gathering
  float* h_out;        // [B, E, d]
  const float* nf;     // [B, V, d] node features (gather)
  float* nh;           // [B, V, d] node hiddens (scatter)
  const int* src;      // [B, E]
  const int* dst;      // [B, E]
  const uint8_t* emask;  // [B, E]
  const float* W;      // [d, d], [in, out]
  const float* bias;   // [d]
  int E, V, d, residual, mean;
};

__host__ inline size_t smem_bytes(int E, int V, bool scatter) {
  size_t floats = (size_t)kKTile * kCols     // W tile (first: 16-byte aligned)
                  + (size_t)E * kCols        // mW slice
                  + (size_t)E * (kKTile + 1);  // relu(h) tile, padded rows
  if (scatter) floats += (size_t)E * kCols;  // the output slice
  size_t words = (size_t)E * adj_words(E) + 3 * (size_t)E;  // A bit rows; src, dst, emask
  if (scatter) words += (size_t)V * adj_words(E);            // node bit rows
  return sizeof(float) * floats + sizeof(uint32_t) * words;
}

__host__ inline size_t dbuf_smem_bytes(int E) {
  return sizeof(float) * (2 * (size_t)kKTile * kCols      // two W tiles (first)
                          + (size_t)E * kCols             // mW slice
                          + 2 * (size_t)E * kHStride)     // two h tiles
         + sizeof(uint32_t) * ((size_t)E * adj_words(E) + 3 * (size_t)E);
}

__device__ inline float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN passes, as in torch

// Element col of row e of the layer input: input_vec's scalar form.
template <bool kGather>
__device__ inline float input_at(const LayerArgs& a, size_t bin_off, int b, int e, int col) {
  float v = a.h_in[(bin_off + e) * a.d + col];
  if constexpr (kGather) {
    const int s = a.src[bin_off + e];
    if (s >= 0 && s < a.V) v = a.nf[((size_t)b * a.V + s) * a.d + col] + v;
  }
  return v;
}

// Step 1: stage the bin's index arrays, then (after a barrier) build A's bit
// rows (sum: keep without rev; mean: keep) and, for the scatter, the node bit
// rows: bit e of row v set where dst[e] == v and emask[e].
template <bool kScatter>
__device__ inline void build_bits(const LayerArgs& a, size_t bin_off, uint32_t* adj,
                                  uint32_t* node_bits, int* src_s, int* dst_s, int* ok_s,
                                  int tid) {
  const int E = a.E, words = adj_words(E);
  for (int e = tid; e < E; e += kThreads) {
    src_s[e] = a.src[bin_off + e];
    dst_s[e] = a.dst[bin_off + e];
    ok_s[e] = a.emask[bin_off + e] != 0;
  }
  __syncthreads();
  for (int i = tid; i < E * words; i += kThreads) {
    const int e = i / words;
    const int base = (i % words) * 32;
    const int se = src_s[e];
    const int rev = e ^ 1;
    uint32_t bits = 0u;
    for (int t = 0; t < 32; ++t) {
      const int e2 = base + t;
      if (e2 < E && ok_s[e2] && dst_s[e2] == se && (a.mean || e2 != rev)) bits |= 1u << t;
    }
    adj[i] = bits;
  }
  if constexpr (kScatter) {
    for (int i = tid; i < a.V * words; i += kThreads) {
      const int v = i / words;
      const int base = (i % words) * 32;
      uint32_t bits = 0u;
      for (int t = 0; t < 32; ++t) {
        const int e2 = base + t;
        if (e2 < E && ok_s[e2] && dst_s[e2] == v) bits |= 1u << t;
      }
      node_bits[i] = bits;
    }
  }
}

// Step 3: h_out[b, e, c] = (h_in +) bias + sum over the set bits of row e;
// the scatter also keeps the output slice in `outs` ([E][kCols]).
template <bool kGather, bool kScatter>
__device__ inline void write_rows(const LayerArgs& a, size_t bin_off, int b, int c0,
                                  const float* mw, const uint32_t* adj, float* outs, int tid) {
  const int E = a.E, words = adj_words(E);
  const int c = tid % kCols;
  const float bc = a.bias[c0 + c];
  for (int e0 = tid / kCols; e0 < E; e0 += kRowStep * kResGroup) {
    float res[kResGroup];
#pragma unroll
    for (int u = 0; u < kResGroup; ++u) {
      const int e = e0 + u * kRowStep;
      res[u] = a.residual && e < E ? input_at<kGather>(a, bin_off, b, e, c0 + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kResGroup; ++u) {
      const int e = e0 + u * kRowStep;
      if (e >= E) break;
      const uint32_t* row = adj + (size_t)e * words;
      float s = 0.f;
      int deg = 0;
      for (int w = 0; w < words; ++w) {
        uint32_t bits = row[w];
        deg += __popc(bits);
        while (bits) {
          const int t = __ffs(bits) - 1;
          bits &= bits - 1u;
          s += mw[(w * 32 + t) * kCols + c];
        }
      }
      if (a.mean) s = s / fmaxf((float)deg, 1.f) - mw[(e ^ 1) * kCols + c];
      const float o = bc + s;
      const float h = a.residual ? res[u] + o : o;
      a.h_out[(bin_off + e) * a.d + c0 + c] = h;
      if constexpr (kScatter) outs[e * kCols + c] = h;
    }
  }
}

// Step 4: nh[b, v, c] = sum of the output rows of node v's set bits, in
// ascending edge order; divided by max(count, 1) for mean.
__device__ inline void scatter_nodes(const LayerArgs& a, int b, int c0, const float* outs,
                                     const uint32_t* node_bits, int tid) {
  const int words = adj_words(a.E);
  const int c = tid % kCols;
  for (int v = tid / kCols; v < a.V; v += kRowStep) {
    const uint32_t* row = node_bits + (size_t)v * words;
    float s = 0.f;
    int deg = 0;
    for (int w = 0; w < words; ++w) {
      uint32_t bits = row[w];
      deg += __popc(bits);
      while (bits) {
        const int t = __ffs(bits) - 1;
        bits &= bits - 1u;
        s += outs[(w * 32 + t) * kCols + c];
      }
    }
    if (a.mean) s = s / fmaxf((float)deg, 1.f);
    a.nh[((size_t)b * a.V + v) * a.d + c0 + c] = s;
  }
}

// One thread's share of a k-tile, in registers: R / 2 vectors of h (a block
// covers 16 * R rows of 8 vectors) and 2 of W (32 rows of 16 vectors).
template <int R>
struct TileRegs {
  float4 h[R / 2];
  float4 w[2];
};

template <int R, bool kGather>
__device__ inline void load_tile(TileRegs<R>& t, const LayerArgs& a, size_t bin_off, int b,
                                 int c0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int idx = tid + kThreads * i, e = idx >> 3, q = idx & 7;
    t.h[i] = e < a.E ? input_vec<kGather>(a.h_in, a.nf, a.src, bin_off + e, b, a.V, a.d, k0, q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i, k = idx >> 4, q = idx & 15;
    t.w[i] = reinterpret_cast<const float4*>(a.W + (size_t)(k0 + k) * a.d + c0)[q];
  }
}

template <int R>
__device__ inline void store_tile(const TileRegs<R>& t, float* hs, float* ws, int E, int tid) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int idx = tid + kThreads * i, e = idx >> 3, q = idx & 7;
    if (e < E) {
      float* row = hs + e * (kKTile + 1) + 4 * q;
      row[0] = relu(t.h[i].x);
      row[1] = relu(t.h[i].y);
      row[2] = relu(t.h[i].z);
      row[3] = relu(t.h[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) reinterpret_cast<float4*>(ws)[tid + kThreads * i] = t.w[i];
}

// ---- the plain layer ----------------------------------------------------------
// Steps 1-3 with neither end, in one body: rows 1, 2 and 4 and the encoder's
// middle layers. The ends kernel below, instantiated with both ends off,
// computes the same layer, but its blocks ran about a tenth slower on the
// H100 with near-equal machine code (PERF.md), so the plain layer keeps this
// kernel of its own.

template <int R>
__device__ inline void load_plain_tile(TileRegs<R>& t, const float* hb, const float* W, int E,
                                       int d, int c0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int idx = tid + kThreads * i, e = idx >> 3, q = idx & 7;
    t.h[i] = e < E ? reinterpret_cast<const float4*>(hb + (size_t)e * d + k0)[q]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i, k = idx >> 4, q = idx & 15;
    t.w[i] = reinterpret_cast<const float4*>(W + (size_t)(k0 + k) * d + c0)[q];
  }
}

// R: rows of the product phase per thread; a block covers 16 * R edge lanes.
template <int R>
__global__ void __launch_bounds__(kThreads)
dense_mpnn_plain_kernel(const float* __restrict__ h_in, float* __restrict__ h_out,
                        const int* __restrict__ src, const int* __restrict__ dst,
                        const uint8_t* __restrict__ emask, const float* __restrict__ W,
                        const float* __restrict__ bias, int E, int d, int residual,
                        int mean) {
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* ws = reinterpret_cast<float*>(smem4);                       // [kKTile][kCols]
  float* mw = ws + kKTile * kCols;                                   // [E][kCols]
  float* hs = mw + (size_t)E * kCols;                                // [E][kKTile + 1]
  uint32_t* adj = reinterpret_cast<uint32_t*>(hs + (size_t)E * (kKTile + 1));  // [E][words]
  int* src_s = reinterpret_cast<int*>(adj + (size_t)E * words);
  int* dst_s = src_s + E;
  int* ok_s = dst_s + E;

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;
  const float* hb = h_in + bin_off * d;

  // the first tile's loads go out before anything waits on shared memory
  TileRegs<R> tile;
  load_plain_tile<R>(tile, hb, W, E, d, c0, 0, tid);

  for (int e = tid; e < E; e += kThreads) {
    src_s[e] = src[bin_off + e];
    dst_s[e] = dst[bin_off + e];
    ok_s[e] = emask[bin_off + e] != 0;
  }
  __syncthreads();

  // 1. bit rows of A's pattern (sum: keep without rev; mean: keep)
  for (int i = tid; i < E * words; i += kThreads) {
    const int e = i / words;
    const int base = (i % words) * 32;
    const int se = src_s[e];
    const int rev = e ^ 1;
    uint32_t bits = 0u;
    for (int t = 0; t < 32; ++t) {
      const int e2 = base + t;
      if (e2 < E && ok_s[e2] && dst_s[e2] == se && (mean || e2 != rev)) bits |= 1u << t;
    }
    adj[i] = bits;
  }

  // 2. mW[:, c0:c0+64] = relu(h_in[b]) @ W[:, c0:c0+64]; thread (tx, ty)
  //    owns columns 4tx..4tx+3 of rows ty + 16r
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kKTile) {
    __syncthreads();  // the previous tiles are consumed (and step 1 is done)
    store_tile<R>(tile, hs, ws, E, tid);
    __syncthreads();
    if (k0 + kKTile < d) load_plain_tile<R>(tile, hb, W, E, d, c0, k0 + kKTile, tid);
#pragma unroll 4
    for (int k = 0; k < kKTile; ++k) {
      const float4 bv = reinterpret_cast<const float4*>(ws + k * kCols)[tx];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = ty + 16 * r;
        const float a = e < E ? hs[e * (kKTile + 1) + k] : 0.f;
        acc[r][0] = fmaf(a, bv.x, acc[r][0]);
        acc[r][1] = fmaf(a, bv.y, acc[r][1]);
        acc[r][2] = fmaf(a, bv.z, acc[r][2]);
        acc[r][3] = fmaf(a, bv.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = ty + 16 * r;
    if (e < E)
      reinterpret_cast<float4*>(mw + e * kCols)[tx] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  // 3. h_out[b, e, c] = (h_in +) bias + sum over the set bits of row e
  const int c = tid % kCols;
  const float bc = bias[c0 + c];
  for (int e0 = tid / kCols; e0 < E; e0 += kRowStep * kResGroup) {
    float res[kResGroup];
#pragma unroll
    for (int u = 0; u < kResGroup; ++u) {
      const int e = e0 + u * kRowStep;
      res[u] = residual && e < E ? h_in[(bin_off + e) * d + c0 + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kResGroup; ++u) {
      const int e = e0 + u * kRowStep;
      if (e >= E) break;
      const uint32_t* row = adj + (size_t)e * words;
      float s = 0.f;
      int deg = 0;
      for (int w = 0; w < words; ++w) {
        uint32_t bits = row[w];
        deg += __popc(bits);
        while (bits) {
          const int t = __ffs(bits) - 1;
          bits &= bits - 1u;
          s += mw[(w * 32 + t) * kCols + c];
        }
      }
      if (mean) s = s / fmaxf((float)deg, 1.f) - mw[(e ^ 1) * kCols + c];
      const float o = bc + s;
      h_out[(bin_off + e) * d + c0 + c] = residual ? res[u] + o : o;
    }
  }
}

// ---- the encoder's ends --------------------------------------------------------

// R as above. kGather / kScatter: the encoder's first and last layer (at
// least one of them; both at depth 1).
template <int R, bool kGather, bool kScatter>
__global__ void __launch_bounds__(kThreads)
dense_mpnn_ends_kernel(const float* __restrict__ h_in, float* __restrict__ h_out,
                       const float* __restrict__ nf, float* __restrict__ nh,
                        const int* __restrict__ src, const int* __restrict__ dst,
                        const uint8_t* __restrict__ emask, const float* __restrict__ W,
                        const float* __restrict__ bias, int E, int V, int d, int residual,
                        int mean) {
  const LayerArgs a{h_in, h_out, nf, nh, src, dst, emask, W, bias, E, V, d, residual, mean};
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* ws = reinterpret_cast<float*>(smem4);                       // [kKTile][kCols]
  float* mw = ws + kKTile * kCols;                                   // [E][kCols]
  float* outs = mw + (size_t)E * kCols;                              // [E][kCols] (scatter)
  float* hs = outs + (kScatter ? (size_t)E * kCols : 0);             // [E][kKTile + 1]
  uint32_t* adj = reinterpret_cast<uint32_t*>(hs + (size_t)E * (kKTile + 1));  // [E][words]
  int* src_s = reinterpret_cast<int*>(adj + (size_t)E * words);
  int* dst_s = src_s + E;
  int* ok_s = dst_s + E;
  uint32_t* node_bits = reinterpret_cast<uint32_t*>(ok_s + E);       // [V][words] (scatter)

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;

  // the first tile's loads go out before anything waits on shared memory
  TileRegs<R> tile;
  load_tile<R, kGather>(tile, a, bin_off, b, c0, 0, tid);

  build_bits<kScatter>(a, bin_off, adj, node_bits, src_s, dst_s, ok_s, tid);

  // 2. mW[:, c0:c0+64] = relu(h_in[b]) @ W[:, c0:c0+64]; thread (tx, ty)
  //    owns columns 4tx..4tx+3 of rows ty + 16r
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kKTile) {
    __syncthreads();  // the previous tiles are consumed (and step 1 is done)
    store_tile<R>(tile, hs, ws, E, tid);
    __syncthreads();
    if (k0 + kKTile < d) load_tile<R, kGather>(tile, a, bin_off, b, c0, k0 + kKTile, tid);
#pragma unroll 4
    for (int k = 0; k < kKTile; ++k) {
      const float4 bv = reinterpret_cast<const float4*>(ws + k * kCols)[tx];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = ty + 16 * r;
        const float av = e < E ? hs[e * (kKTile + 1) + k] : 0.f;
        acc[r][0] = fmaf(av, bv.x, acc[r][0]);
        acc[r][1] = fmaf(av, bv.y, acc[r][1]);
        acc[r][2] = fmaf(av, bv.z, acc[r][2]);
        acc[r][3] = fmaf(av, bv.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = ty + 16 * r;
    if (e < E)
      reinterpret_cast<float4*>(mw + e * kCols)[tx] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  write_rows<kGather, kScatter>(a, bin_off, b, c0, mw, adj, outs, tid);
  if constexpr (kScatter) {
    __syncthreads();
    scatter_nodes(a, b, c0, outs, node_bits, tid);
  }
}

// ---- the double-buffered layer ----------------------------------------------

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of the k-tile at k0 into one stage: E rows of 8 vectors of
// h and 32 rows of 16 vectors of W.
__device__ inline void issue_tile(const LayerArgs& a, size_t bin_off, int c0, int k0, float* hs,
                                  float* ws, int tid) {
  const float* hb = a.h_in + bin_off * a.d + k0;
  for (int idx = tid; idx < a.E * 8; idx += kThreads) {
    const int e = idx >> 3, q = idx & 7;
    cp_async16(hs + e * kHStride + 4 * q, hb + (size_t)e * a.d + 4 * q);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i, k = idx >> 4, q = idx & 15;
    cp_async16(ws + k * kCols + 4 * q, a.W + (size_t)(k0 + k) * a.d + c0 + 4 * q);
  }
  cp_async_commit();
}

template <int R>
__global__ void __launch_bounds__(kThreads)
dense_mpnn_dbuf_kernel(const float* __restrict__ h_in, float* __restrict__ h_out,
                       const int* __restrict__ src, const int* __restrict__ dst,
                       const uint8_t* __restrict__ emask, const float* __restrict__ W,
                       const float* __restrict__ bias, int E, int d, int residual, int mean) {
  const LayerArgs a{h_in, h_out, nullptr, nullptr, src, dst, emask, W, bias, E, 1, d,
                    residual, mean};
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* ws0 = reinterpret_cast<float*>(smem4);                      // [kKTile][kCols] x 2
  float* mw = ws0 + 2 * kKTile * kCols;                              // [E][kCols]
  float* hs0 = mw + (size_t)E * kCols;                               // [E][kHStride] x 2
  uint32_t* adj = reinterpret_cast<uint32_t*>(hs0 + 2 * (size_t)E * kHStride);
  int* src_s = reinterpret_cast<int*>(adj + (size_t)E * words);
  int* dst_s = src_s + E;
  int* ok_s = dst_s + E;

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;
  const int n_tiles = d / kKTile;

  issue_tile(a, bin_off, c0, 0, hs0, ws0, tid);  // stage 0 fills while step 1 runs
  build_bits<false>(a, bin_off, adj, nullptr, src_s, dst_s, ok_s, tid);

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int nx = st ^ 1;
      issue_tile(a, bin_off, c0, (t + 1) * kKTile, hs0 + nx * (size_t)E * kHStride,
                 ws0 + nx * kKTile * kCols, tid);
      cp_async_wait<1>();  // this tile's group has landed; the next one is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile (and step 1) are visible
    float* hs = hs0 + st * (size_t)E * kHStride;
    const float* ws = ws0 + st * kKTile * kCols;
    for (int i = tid; i < E * kKTile; i += kThreads) {
      float* v = hs + (i / kKTile) * kHStride + i % kKTile;
      *v = relu(*v);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKTile; ++k) {
      const float4 bv = reinterpret_cast<const float4*>(ws + k * kCols)[tx];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = ty + 16 * r;
        const float av = e < E ? hs[e * kHStride + k] : 0.f;
        acc[r][0] = fmaf(av, bv.x, acc[r][0]);
        acc[r][1] = fmaf(av, bv.y, acc[r][1]);
        acc[r][2] = fmaf(av, bv.z, acc[r][2]);
        acc[r][3] = fmaf(av, bv.w, acc[r][3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = ty + 16 * r;
    if (e < E)
      reinterpret_cast<float4*>(mw + e * kCols)[tx] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  write_rows<false, false>(a, bin_off, b, c0, mw, adj, nullptr, tid);
}

template <int R>
cudaError_t launch_plain(const LayerArgs& a, int B, cudaStream_t stream) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)dense_mpnn_plain_kernel<R>,
                               (int)smem_bytes(16 * R, 0, false), configured);
  if (err != cudaSuccess) return err;
  dense_mpnn_plain_kernel<R><<<dim3(B, a.d / kCols), kThreads, smem_bytes(a.E, 0, false), stream>>>(
      a.h_in, a.h_out, a.src, a.dst, a.emask, a.W, a.bias, a.E, a.d, a.residual, a.mean);
  return cudaGetLastError();
}

template <int R, bool kGather, bool kScatter>
cudaError_t launch_ends(const LayerArgs& a, int B, cudaStream_t stream) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)dense_mpnn_ends_kernel<R, kGather, kScatter>,
                               (int)smem_bytes(16 * R, kMaxNodes, kScatter), configured);
  if (err != cudaSuccess) return err;
  dense_mpnn_ends_kernel<R, kGather, kScatter>
      <<<dim3(B, a.d / kCols), kThreads, smem_bytes(a.E, a.V, kScatter), stream>>>(
          a.h_in, a.h_out, a.nf, a.nh, a.src, a.dst, a.emask, a.W, a.bias, a.E, a.V, a.d,
          a.residual, a.mean);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_layer(const LayerArgs& a, int B, bool gather, bool scatter, cudaStream_t s) {
  if (gather && scatter) return launch_ends<R, true, true>(a, B, s);
  if (gather) return launch_ends<R, true, false>(a, B, s);
  if (scatter) return launch_ends<R, false, true>(a, B, s);
  return launch_plain<R>(a, B, s);
}

template <int R>
cudaError_t launch_dbuf(const LayerArgs& a, int B, cudaStream_t stream) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)dense_mpnn_dbuf_kernel<R>,
                               (int)dbuf_smem_bytes(16 * R), configured);
  if (err != cudaSuccess) return err;
  dense_mpnn_dbuf_kernel<R><<<dim3(B, a.d / kCols), kThreads, dbuf_smem_bytes(a.E), stream>>>(
      a.h_in, a.h_out, a.src, a.dst, a.emask, a.W, a.bias, a.E, a.d, a.residual, a.mean);
  return cudaGetLastError();
}

bool bad_shape(int B, int E, int d) {
  return B <= 0 || E <= 0 || E % 2 != 0 || E > kMaxEdges || d <= 0 || d % kCols != 0;
}

}  // namespace

extern "C" {

int dense_mpnn_max_edges() { return kMaxEdges; }

int dense_mpnn_max_nodes() { return kMaxNodes; }

int dense_mpnn_cols() { return kCols; }

// One layer: h_out[B,E,d] from h_in[B,E,d], src/dst[B,E] int32, emask[B,E]
// bytes, W[d,d] ([in, out], row-major), bias[d]. With gather != 0, h_in is
// ef[B,E,d] and the layer's input is nf[src] + ef, nf[B,V,d]; with scatter
// != 0 the layer also writes nh[B,V,d] (see the top of the file). All
// pointers are device pointers of contiguous arrays; h_in, h_out, W and nf
// start 16-byte aligned. The stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
int dense_mpnn_layer(const float* h_in, float* h_out, const float* nf, float* nh, const int* src,
                     const int* dst, const uint8_t* emask, const float* W, const float* bias, int B,
                     int V, int E, int d, int residual, int mean, int gather, int scatter,
                     void* stream) {
  if (bad_shape(B, E, d)) return (int)cudaErrorInvalidValue;
  if ((gather || scatter) && (V <= 0 || V > kMaxNodes || (gather && !nf) || (scatter && !nh)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)h_in | (uintptr_t)h_out | (uintptr_t)W | (uintptr_t)nf) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const LayerArgs a{h_in, h_out, nf, nh, src, dst, emask, W, bias, E, V, d, residual, mean};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 128) return (int)launch_layer<8>(a, B, gather != 0, scatter != 0, s);
  return (int)launch_layer<16>(a, B, gather != 0, scatter != 0, s);
}

// One layer of the double-buffered forward: the arguments and result of
// dense_mpnn_layer without the encoder's ends.
int dense_mpnn_dbuf_layer(const float* h_in, float* h_out, const int* src, const int* dst,
                          const uint8_t* emask, const float* W, const float* bias, int B, int E,
                          int d, int residual, int mean, void* stream) {
  if (bad_shape(B, E, d)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)h_in | (uintptr_t)h_out | (uintptr_t)W) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const LayerArgs a{h_in, h_out, nullptr, nullptr, src, dst, emask, W, bias, E, 1, d,
                    residual, mean};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 128) return (int)launch_dbuf<8>(a, B, s);
  return (int)launch_dbuf<16>(a, B, s);
}

const char* dense_mpnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
