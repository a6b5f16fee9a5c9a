// The reverse sweep of one layer of the folded dense D-MPNN block, in CUDA
// C++ for sm_90a, with the ends of the whole-encoder backward folded into
// the sweep's first and last layer.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_mpnn.py:
//   - fused_dense_mpnn_block_bwd_stash / _bwd_kernel_stash (the training
//     backward that reads the stashed layer inputs) and the reverse sweep of
//     fused_dense_mpnn_block_bwd / _bwd_kernel (the recompute backward, whose
//     replay of the forward runs the layer kernel of dense_mpnn.cu);
//   - fused_dense_encoder_bwd / _encoder_bwd_kernel(_d1): the same sweep with
//     the scatter's VJP in front of the last layer's launches and h0's
//     recompute and the gather's VJP in layer 0's.
// The Python wrapper (notorch_tpu_torch/kernels/dense_mpnn.py) calls
// dense_mpnn_bwd_layer once per layer, last layer first.
//
// The forward layer is h_out = (h_in +) bias + A @ (relu(h_in) @ W), with A
// the folded edge operator of dense_mpnn.cu (per bin, rev(e) = e ^ 1):
//   sum:  A[e,e'] = keep[e,e'] && e' != rev(e)
//   mean: A[e,e'] = keep[e,e'] / max(indeg(e), 1) - [e' == rev(e)]
//   keep[e,e'] = src[e] == dst[e'] && emask[e'],  indeg(e) = sum_e' keep[e,e']
// Given g, the cotangent of h_out, and m = relu(h_in), one layer of the
// sweep computes
//   g_mW   = A^T g                          (adjoint_kernel)
//   g_W    = m^T g_mW,  g_b = sum_rows g    (weight_grad_partial_kernel, then
//                                            reduce_chunks_kernel)
//   g_in   = [h_in > 0] * (g_mW @ W^T) (+ g when residual)   (input_grad_kernel)
// over every bin and lane. A^T g is exact for any g; that g is zero on
// padded lanes (the masked scatter drops them) is what makes it the
// gradient of the unfolded block too, as in the TPU kernel.
//
// The encoder (h0 = nf[src] + ef; nh = masked scatter of the last output)
// adds, per bin:
//   prologue (the last layer's adjoint_kernel): the cotangent of the block's
//     output is g = ge + S^T gn, g[e] = ge[e] + emask[e] * gn[dst[e]] (times
//     1 / max(indeg(dst[e]), 1) for mean: the forward scatter's operator);
//     the kernel stages it for A^T g and writes it for the layer's other two
//     kernels;
//   recompute (layer 0): the weight gradient's m and the ReLU mask read
//     h0 = nf[src] + ef, recomputed where they load it, as the TPU kernel
//     recomputes it rather than stash it;
//   epilogue (layer 0's input_grad_kernel): g_ef = g_h0, and g_nf[v] =
//     sum_e [src[e] == v] * g_h0[e] (unmasked), summed in ascending edge
//     order from the block's own output slice, kept in shared memory.
// A src or dst outside [0, V) touches no node, as a one-hot would.
//
// What bounds it: the work is exact f32, so the floor is the CUDA-core f32
// rate (67 TFLOP/s on an H100 SXM at 700 W). A layer needs 4 * B * E * d^2
// operations for the two W-sized products and 2 * nnz(A) * d for A^T g (the
// encoder's ends add about 3 * B * E * d); the bytes (h0 or nf and ef, the
// stash, W, the cotangents read once; the gradients written once) take about
// a fifth as long at the training shape. So it is bound by operations.
// The design:
//   - A^T g on a (bin, 64-column) grid: the block stages its bin's g slice
//     and builds bit rows of A^T in shared memory, then walks the set bits,
//     so the operator costs operations only where it is nonzero;
//   - g_mW @ W^T by k-tiled shared-memory FMA, as the forward's product
//     phase, with W's tile transposed on its way into shared memory and the
//     next tile's loads in flight during the current tile's FMAs;
//   - m^T g_mW is a sum over all B * E rows. On the TPU the grid runs in
//     order and carries it in the output block; here blocks run in no
//     order, and float atomics would make g_W differ from call to call. So
//     each block sums one 256-row chunk into its own 64 x 64 partial, and
//     a second kernel adds the chunks in a fixed order: two calls on the
//     same inputs give the same bits. g_b takes the same route. The only
//     atomics are integer counts of in-degrees, whose result has no order.
// It does not reach the floor: plain FMA from shared memory, four launches
// a layer, g_mW round-trips device memory (it stays in the 50 MB L2 at the
// training shape), and every column slice of a bin rebuilds the bit rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCols = 64;         // output columns per block
constexpr int kKTile = 32;        // k depth of one staged tile
constexpr int kThreads = 256;
constexpr int kMaxEdges = 256;    // edge lanes per bin this kernel takes
constexpr int kMaxNodes = 256;    // node slots per bin the encoder's ends take
constexpr int kChunkRows = 256;   // rows of the B * E sum per weight-gradient partial
constexpr int kWStride = kCols + 4;  // padded row of the transposed W tile

// The pointers and sizes of one layer's launches. The kernels take the
// pointers they use as __restrict__ parameters: no two of them alias, so the
// compiler may load the read-only ones through the non-coherent path.
struct BwdArgs {
  const float* h_in;     // [B, E, d] the layer's input; ef when recomputing h0
  const float* g;        // [B, E, d] cotangent of the layer's output
  float* g_in;           // [B, E, d] cotangent of its input
  float* g_mw;           // scratch [B, E, d]
  float* gw_part;        // scratch [chunks, d, d]
  float* gb_part;        // scratch [chunks, d]
  float* gw;             // [d, d]
  float* gb;             // [d]
  const int* src;        // [B, E]
  const int* dst;        // [B, E]
  const uint8_t* emask;  // [B, E]
  const float* W;        // [d, d], [in, out]
  // the encoder's ends
  const float* nf;       // [B, V, d] node features (recompute)
  const float* ge;       // [B, E, d] cotangent of the edge hiddens (prologue)
  const float* gn;       // [B, V, d] cotangent of the node hiddens (prologue)
  float* g_nf;           // [B, V, d] (epilogue)
  int E, V, d, residual, mean;
};

// ---- g_mW = A^T g (with the prologue: g = ge + S^T gn first) ---------------

__host__ inline size_t adjoint_smem_bytes(int E, int V, bool prologue) {
  return sizeof(float) * ((size_t)E * kCols + E)        // g slice, 1 / max(indeg, 1)
         + sizeof(uint32_t) * (size_t)E * adj_words(E)  // bit rows of A^T
         + sizeof(int) * 3 * (size_t)E                  // src, dst, emask
         + (prologue ? sizeof(int) * (size_t)V : 0);    // node in-degrees
}

// Grid (bin, 64-column slice of d). Row e' of A^T has bit e set where
// A[e, e'] has a keep entry: emask[e'] && src[e] == dst[e'] (and, for sum,
// e != rev(e')). Mean scales each term by 1 / max(indeg(e), 1) and
// subtracts g[rev(e')], the rev diagonal of A, on every row.
template <bool kPrologue>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(const float* __restrict__ g, const float* __restrict__ ge,
               const float* __restrict__ gn, float* __restrict__ g_full,
               float* __restrict__ g_mw, const int* __restrict__ src, const int* __restrict__ dst,
               const uint8_t* __restrict__ emask, int E, int V, int d, int mean) {
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* gs = reinterpret_cast<float*>(smem4);                // [E][kCols]
  float* inv = gs + (size_t)E * kCols;                        // [E]
  uint32_t* adj = reinterpret_cast<uint32_t*>(inv + E);       // [E][words]
  int* src_s = reinterpret_cast<int*>(adj + (size_t)E * words);
  int* dst_s = src_s + E;
  int* ok_s = dst_s + E;
  int* cnt = ok_s + E;                                        // [V] (prologue)

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;

  for (int e = tid; e < E; e += kThreads) {
    src_s[e] = src[bin_off + e];
    dst_s[e] = dst[bin_off + e];
    ok_s[e] = emask[bin_off + e] != 0;
  }
  constexpr int kVecs = kCols / 4;
  if constexpr (kPrologue) {
    if (mean) {
      for (int v = tid; v < V; v += kThreads) cnt[v] = 0;
      __syncthreads();
      for (int e = tid; e < E; e += kThreads) {
        const int v = dst_s[e];
        if (ok_s[e] && v >= 0 && v < V) atomicAdd(&cnt[v], 1);
      }
    }
    __syncthreads();
    for (int i = tid; i < E * kVecs; i += kThreads) {
      const int e = i / kVecs, q = i % kVecs;
      const size_t off = (bin_off + e) * d + c0;
      float4 v = reinterpret_cast<const float4*>(ge + off)[q];
      const int node = dst_s[e];
      if (ok_s[e] && node >= 0 && node < V) {
        float4 n = reinterpret_cast<const float4*>(gn + ((size_t)b * V + node) * d + c0)[q];
        if (mean) {
          const float sc = 1.f / fmaxf((float)cnt[node], 1.f);
          n = make_float4(n.x * sc, n.y * sc, n.z * sc, n.w * sc);
        }
        v = add4(v, n);
      }
      reinterpret_cast<float4*>(gs + (size_t)e * kCols)[q] = v;
      reinterpret_cast<float4*>(g_full + off)[q] = v;
    }
  } else {
    for (int i = tid; i < E * kVecs; i += kThreads) {
      const int e = i / kVecs, q = i % kVecs;
      reinterpret_cast<float4*>(gs + (size_t)e * kCols)[q] =
          reinterpret_cast<const float4*>(g + (bin_off + e) * d + c0)[q];
    }
  }
  __syncthreads();

  for (int i = tid; i < E * words; i += kThreads) {
    const int e2 = i / words;
    const int base = (i % words) * 32;
    uint32_t bits = 0u;
    if (ok_s[e2]) {
      const int de2 = dst_s[e2];
      const int rev = e2 ^ 1;
      for (int t = 0; t < 32; ++t) {
        const int e = base + t;
        if (e < E && src_s[e] == de2 && (mean || e != rev)) bits |= 1u << t;
      }
    }
    adj[i] = bits;
  }
  if (mean) {
    for (int e = tid; e < E; e += kThreads) {
      const int se = src_s[e];
      int deg = 0;
      for (int e2 = 0; e2 < E; ++e2) deg += ok_s[e2] && dst_s[e2] == se;
      inv[e] = 1.f / fmaxf((float)deg, 1.f);
    }
  }
  __syncthreads();

  const int c = tid % kCols;
  for (int e2 = tid / kCols; e2 < E; e2 += kThreads / kCols) {
    const uint32_t* row = adj + (size_t)e2 * words;
    float s = 0.f;
    for (int w = 0; w < words; ++w) {
      uint32_t bits = row[w];
      while (bits) {
        const int e = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        s += mean ? gs[e * kCols + c] * inv[e] : gs[e * kCols + c];
      }
    }
    if (mean) s -= gs[(e2 ^ 1) * kCols + c];
    g_mw[(bin_off + e2) * d + c0 + c] = s;
  }
}

// ---- g_in = [h_in > 0] * (g_mW @ W^T) (+ g) ---------------------------------

__host__ inline size_t input_grad_smem_bytes(int E, int V, bool epilogue) {
  size_t floats = (size_t)kKTile * kWStride          // W^T tile (first: 16-byte aligned)
                  + (size_t)E * (kKTile + 1);        // g_mW tile, padded rows
  size_t words = 0;
  if (epilogue) {
    floats += (size_t)E * kCols;                     // the output slice (after the W^T tile)
    words += (size_t)E + (size_t)V * adj_words(E);   // src; node bit rows
  }
  return sizeof(float) * floats + sizeof(uint32_t) * words;
}

// One thread's share of a k-tile in registers: R / 2 vectors of g_mW (a
// block covers 16 * R rows of 8 vectors) and 2 of W (64 rows of 8 vectors).
template <int R>
struct TileRegs {
  float4 a[R / 2];
  float4 w[2];
};

template <int R>
__device__ inline void load_tile(TileRegs<R>& t, const float* gb, const float* W, int E, int d,
                                 int c0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int idx = tid + kThreads * i, e = idx >> 3, q = idx & 7;
    t.a[i] = e < E ? reinterpret_cast<const float4*>(gb + (size_t)e * d + k0)[q]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i, c = idx >> 3, q = idx & 7;
    t.w[i] = reinterpret_cast<const float4*>(W + (size_t)(c0 + c) * d + k0)[q];
  }
}

template <int R>
__device__ inline void store_tile(const TileRegs<R>& t, float* as, float* ws, int E, int tid) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int idx = tid + kThreads * i, e = idx >> 3, q = idx & 7;
    if (e < E) {
      float* row = as + e * (kKTile + 1) + 4 * q;
      row[0] = t.a[i].x;
      row[1] = t.a[i].y;
      row[2] = t.a[i].z;
      row[3] = t.a[i].w;
    }
  }
  // W[c0 + c][k0 + 4q .. 4q + 3] goes to ws[4q .. 4q + 3][c]: W^T's tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i, c = idx >> 3, q = idx & 7;
    ws[(4 * q + 0) * kWStride + c] = t.w[i].x;
    ws[(4 * q + 1) * kWStride + c] = t.w[i].y;
    ws[(4 * q + 2) * kWStride + c] = t.w[i].z;
    ws[(4 * q + 3) * kWStride + c] = t.w[i].w;
  }
}

// Grid (bin, 64-column slice of d); thread (tx, ty) owns columns
// 4tx..4tx+3 of rows ty + 16r. kEnc: layer 0 of the encoder (h0 recomputed
// for the ReLU mask, then the gather's VJP into g_nf).
template <int R, bool kEnc>
__global__ void __launch_bounds__(kThreads)
input_grad_kernel(const float* __restrict__ g_mw, const float* __restrict__ W,
                  const float* __restrict__ h_in, const float* __restrict__ nf,
                  const int* __restrict__ src, const float* __restrict__ g,
                  float* __restrict__ g_in, float* __restrict__ g_nf, int E, int V, int d,
                  int residual) {
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* ws = reinterpret_cast<float*>(smem4);   // [kKTile][kWStride]
  float* outs = ws + kKTile * kWStride;          // [E][kCols] (kEnc)
  float* as = outs + (kEnc ? (size_t)E * kCols : 0);  // [E][kKTile + 1]
  int* src_s = reinterpret_cast<int*>(as + (size_t)E * (kKTile + 1));  // [E] (kEnc)
  uint32_t* node_bits = reinterpret_cast<uint32_t*>(src_s + E);        // [V][words] (kEnc)

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;
  const float* gb = g_mw + bin_off * d;

  TileRegs<R> tile;
  load_tile<R>(tile, gb, W, E, d, c0, 0, tid);

  if constexpr (kEnc) {
    // bit e of node row v: src[e] == v (unmasked, as the gather reads)
    for (int e = tid; e < E; e += kThreads) src_s[e] = src[bin_off + e];
    __syncthreads();
    for (int i = tid; i < V * words; i += kThreads) {
      const int v = i / words;
      const int base = (i % words) * 32;
      uint32_t bits = 0u;
      for (int t = 0; t < 32; ++t) {
        const int e = base + t;
        if (e < E && src_s[e] == v) bits |= 1u << t;
      }
      node_bits[i] = bits;
    }
  }

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kKTile) {
    __syncthreads();  // the previous tiles are consumed
    store_tile<R>(tile, as, ws, E, tid);
    __syncthreads();
    if (k0 + kKTile < d) load_tile<R>(tile, gb, W, E, d, c0, k0 + kKTile, tid);
#pragma unroll 4
    for (int k = 0; k < kKTile; ++k) {
      const float4 bv = reinterpret_cast<const float4*>(ws + k * kWStride)[tx];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = ty + 16 * r;
        const float av = e < E ? as[e * (kKTile + 1) + k] : 0.f;
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
    if (e >= E) continue;
    const size_t off = (bin_off + e) * d + c0 + 4 * tx;
    const float4 h = input_vec<kEnc>(h_in, nf, src, bin_off + e, b, V, d, c0, tx);
    float4 o = make_float4(acc[r][0] * (h.x > 0.f ? 1.f : 0.f), acc[r][1] * (h.y > 0.f ? 1.f : 0.f),
                           acc[r][2] * (h.z > 0.f ? 1.f : 0.f), acc[r][3] * (h.w > 0.f ? 1.f : 0.f));
    if (residual) o = add4(o, *reinterpret_cast<const float4*>(g + off));
    *reinterpret_cast<float4*>(g_in + off) = o;
    if constexpr (kEnc) reinterpret_cast<float4*>(outs + (size_t)e * kCols)[tx] = o;
  }

  if constexpr (kEnc) {
    // g_nf[b, v, c] = sum over node v's set bits of g_h0[e, c], ascending e
    __syncthreads();
    const int c = tid % kCols;
    for (int v = tid / kCols; v < V; v += kThreads / kCols) {
      const uint32_t* row = node_bits + (size_t)v * words;
      float s = 0.f;
      for (int w = 0; w < words; ++w) {
        uint32_t bits = row[w];
        while (bits) {
          const int e = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
          s += outs[e * kCols + c];
        }
      }
      g_nf[((size_t)b * V + v) * d + c0 + c] = s;
    }
  }
}

// ---- g_W = relu(h_in)^T g_mW and g_b = sum g, in fixed-order chunks ----------

// Grid (chunk of kChunkRows rows, 64-row tile of g_W, 64-column tile of
// g_W). Thread (tx, ty) owns g_W rows 4ty..4ty+3 and columns 4tx..4tx+3 of
// the block's tile. The blocks of the first row tile also sum g over the
// chunk for g_b. kGather: the layer input is h0, recomputed from nf and ef.
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
weight_grad_partial_kernel(const float* __restrict__ h_in, const float* __restrict__ nf,
                           const int* __restrict__ src, const float* __restrict__ g_mw,
                           const float* __restrict__ g, float* __restrict__ gw_part,
                           float* __restrict__ gb_part, int rows, int E, int V, int d) {
  __shared__ float4 ms4[kKTile * kCols / 4];   // relu(h_in) rows x g_W rows
  __shared__ float4 gs4[kKTile * kCols / 4];   // g_mW rows x g_W columns
  __shared__ float red[kThreads / kCols][kCols];
  float* ms = reinterpret_cast<float*>(ms4);
  float* gs = reinterpret_cast<float*>(gs4);

  const int chunk = blockIdx.x;
  const int i0 = blockIdx.y * kCols;
  const int j0 = blockIdx.z * kCols;
  const int tid = threadIdx.x;
  const int r_begin = chunk * kChunkRows;
  const int r_end = min(r_begin + kChunkRows, rows);
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  // two 16-byte vectors of each operand per thread per 32-row tile
  float4 mv[2], gv[2];
  auto load = [&](int r0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + kThreads * i, r = r0 + (idx >> 4), q = idx & 15;
      const bool in = r < r_end;
      mv[i] = in ? input_vec<kGather>(h_in, nf, src, r, r / E, V, d, i0, q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      gv[i] = in ? reinterpret_cast<const float4*>(g_mw + (size_t)r * d + j0)[q]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += kKTile) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + kThreads * i;
      ms4[idx] = make_float4(fmaxf(mv[i].x, 0.f), fmaxf(mv[i].y, 0.f), fmaxf(mv[i].z, 0.f),
                             fmaxf(mv[i].w, 0.f));
      gs4[idx] = gv[i];
    }
    __syncthreads();
    if (r0 + kKTile < r_end) load(r0 + kKTile);
#pragma unroll 8
    for (int k = 0; k < kKTile; ++k) {
      const float4 m = reinterpret_cast<const float4*>(ms + k * kCols)[ty];
      const float4 q = reinterpret_cast<const float4*>(gs + k * kCols)[tx];
      const float mr[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(mr[i], q.x, acc[i][0]);
        acc[i][1] = fmaf(mr[i], q.y, acc[i][1]);
        acc[i][2] = fmaf(mr[i], q.z, acc[i][2]);
        acc[i][3] = fmaf(mr[i], q.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t off = ((size_t)chunk * d + i0 + 4 * ty + i) * d + j0 + 4 * tx;
    *reinterpret_cast<float4*>(gw_part + off) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  if (blockIdx.y == 0) {
    const int c = tid % kCols, phase = tid / kCols;
    float s = 0.f;
    for (int r = r_begin + phase; r < r_end; r += kThreads / kCols) s += g[(size_t)r * d + j0 + c];
    red[phase][c] = s;
    __syncthreads();
    if (tid < kCols) {
      float t = red[0][tid];
#pragma unroll
      for (int p = 1; p < kThreads / kCols; ++p) t += red[p][tid];
      gb_part[(size_t)chunk * d + j0 + tid] = t;
    }
  }
}

// out[i] = sum over chunks c = 0, 1, ... of part[c][i], in that order; the
// first n_w entries are g_W's, the next n_b g_b's.
__global__ void __launch_bounds__(kThreads)
reduce_chunks_kernel(const float* __restrict__ gw_part, const float* __restrict__ gb_part,
                     float* __restrict__ gw, float* __restrict__ gb, int n_w, int n_b,
                     int chunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_w) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += gw_part[(size_t)c * n_w + i];
    gw[i] = s;
  } else if (i < n_w + n_b) {
    const int j = i - n_w;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += gb_part[(size_t)c * n_b + j];
    gb[j] = s;
  }
}

template <bool kPrologue>
cudaError_t launch_adjoint(const BwdArgs& a, int B, const float* g, float* g_full,
                           cudaStream_t s) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)adjoint_kernel<kPrologue>,
                               (int)adjoint_smem_bytes(kMaxEdges, kMaxNodes, kPrologue), configured);
  if (err != cudaSuccess) return err;
  adjoint_kernel<kPrologue><<<dim3(B, a.d / kCols), kThreads,
                              adjoint_smem_bytes(a.E, a.V, kPrologue), s>>>(
      g, a.ge, a.gn, g_full, a.g_mw, a.src, a.dst, a.emask, a.E, a.V, a.d, a.mean);
  return cudaGetLastError();
}

template <int R, bool kEnc>
cudaError_t launch_input_grad(const BwdArgs& a, int B, const float* g, cudaStream_t s) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)input_grad_kernel<R, kEnc>,
                               (int)input_grad_smem_bytes(16 * R, kMaxNodes, kEnc), configured);
  if (err != cudaSuccess) return err;
  input_grad_kernel<R, kEnc><<<dim3(B, a.d / kCols), kThreads,
                               input_grad_smem_bytes(a.E, a.V, kEnc), s>>>(
      a.g_mw, a.W, a.h_in, a.nf, a.src, g, a.g_in, a.g_nf, a.E, a.V, a.d, a.residual);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_mpnn_bwd_max_edges() { return kMaxEdges; }

int dense_mpnn_bwd_max_nodes() { return kMaxNodes; }

int dense_mpnn_bwd_cols() { return kCols; }

int dense_mpnn_bwd_chunk_rows() { return kChunkRows; }

// One layer of the reverse sweep. Inputs: h_in[B,E,d] (the layer's input),
// g[B,E,d] (cotangent of its output), src/dst[B,E] int32, emask[B,E] bytes,
// W[d,d] ([in, out], row-major). Outputs: g_in[B,E,d] (cotangent of h_in),
// gw[d,d] and gb[d] (this layer's weight and bias gradients, overwritten).
// Scratch: g_mw[B,E,d], gw_part[chunks,d,d], gb_part[chunks,d] with chunks
// = ceil(B * E / dense_mpnn_bwd_chunk_rows()).
// The encoder's ends: with prologue != 0 (its last layer) g is not read:
// the layer's cotangent is ge[B,E,d] + S^T gn (gn[B,V,d]), written to
// g_full[B,E,d]; with gather != 0 (its layer 0) h_in is ef[B,E,d], the
// layer's input is nf[src] + ef (nf[B,V,d]), and the gather's VJP is
// written to g_nf[B,V,d]. All pointers are device pointers of contiguous
// arrays; every float array but gb and gb_part starts 16-byte aligned, and
// g_in differs from g. The stream is a cudaStream_t. Returns the cudaError_t
// of the launches (0 on success).
int dense_mpnn_bwd_layer(const float* h_in, const float* g, float* g_in, float* g_mw,
                         float* gw_part, float* gb_part, float* gw, float* gb, const int* src,
                         const int* dst, const uint8_t* emask, const float* W, const float* nf,
                         const float* ge, const float* gn, float* g_full, float* g_nf, int B,
                         int V, int E, int d, int residual, int mean, int prologue, int gather,
                         void* stream) {
  if (B <= 0 || E <= 0 || E % 2 != 0 || E > kMaxEdges || d <= 0 || d % kCols != 0)
    return (int)cudaErrorInvalidValue;
  if ((prologue || gather) && (V <= 0 || V > kMaxNodes)) return (int)cudaErrorInvalidValue;
  if ((prologue && (!ge || !gn || !g_full)) || (gather && (!nf || !g_nf)))
    return (int)cudaErrorInvalidValue;
  if (prologue) g = g_full;
  if (((uintptr_t)h_in | (uintptr_t)g | (uintptr_t)g_in | (uintptr_t)g_mw | (uintptr_t)W |
       (uintptr_t)gw | (uintptr_t)gw_part | (uintptr_t)nf | (uintptr_t)ge | (uintptr_t)gn |
       (uintptr_t)g_nf) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (g_in == g) return (int)cudaErrorInvalidValue;
  const BwdArgs a{h_in, g, g_in, g_mw, gw_part, gb_part, gw, gb, src, dst, emask, W,
                  nf, ge, gn, g_nf, E, V, d, residual, mean};
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err = prologue ? launch_adjoint<true>(a, B, nullptr, g_full, s)
                             : launch_adjoint<false>(a, B, g, nullptr, s);
  if (err != cudaSuccess) return (int)err;

  const int rows = B * E;
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  const dim3 wgrid(chunks, d / kCols, d / kCols);
  if (gather)
    weight_grad_partial_kernel<true><<<wgrid, kThreads, 0, s>>>(h_in, nf, src, g_mw, g, gw_part,
                                                                 gb_part, rows, E, V, d);
  else
    weight_grad_partial_kernel<false><<<wgrid, kThreads, 0, s>>>(h_in, nf, src, g_mw, g, gw_part,
                                                                  gb_part, rows, E, V, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n = d * d + d;
  reduce_chunks_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      gw_part, gb_part, gw, gb, d * d, d, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (E <= 128)
    err = gather ? launch_input_grad<8, true>(a, B, g, s) : launch_input_grad<8, false>(a, B, g, s);
  else
    err = gather ? launch_input_grad<16, true>(a, B, g, s) : launch_input_grad<16, false>(a, B, g, s);
  return (int)err;
}

const char* dense_mpnn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
