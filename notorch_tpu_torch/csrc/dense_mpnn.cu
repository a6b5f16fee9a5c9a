// The forward of the folded dense D-MPNN block, in CUDA C++ for sm_90a: a
// prep once a call, then per layer one tiled product over all B * E rows and
// one pass of the edge operator, with the whole encoder's gather folded into
// the prep and its masked scatter into the last layer's pass; and a layer
// kernel of its own that double-buffers its tiles.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_mpnn.py:
//   - fused_dense_mpnn_block / _block_kernel (with its operator
//     _edge_adjacency) and fused_dense_mpnn_block_stash /
//     _block_kernel_stash: dense_mpnn_forward;
//   - fused_dense_encoder_fwd / _encoder_kernel(_stash): dense_mpnn_forward
//     with the V->E gather and the masked E->V scatter;
//   - fused_dense_mpnn_block_dbuf / _dbuf_kernel: dense_mpnn_dbuf_layer.
// The Python wrapper (notorch_tpu_torch/kernels/dense_mpnn.py) calls
// dense_mpnn_forward once a block call: it launches the prep and every layer
// from C++, layer l writing outs[l] (two buffers in turn, or the stash). It
// calls dense_mpnn_dbuf_layer once a layer.
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
// What bounds it: the work is exact f32 (no TF32, no bf16), so the floor is
// the CUDA-core f32 rate (67 TFLOP/s on an H100 SXM at 700 W). The W products
// need depth * 2 * B * E * d^2 operations and A @ mW only 2 * nnz(A) * d per
// layer, a few per row for molecules; the gather and scatter add B * E * d
// each; the bytes (read h0 or nf and ef, W, b and the index arrays once,
// write the outputs once) take about a tenth as long. So it is bound by
// operations, nearly all of them in the products. The design (kernel names
// start with mpnn_fwd_):
//   - mpnn_fwd_prep_kernel, once a call, each bin spread over kPrepSplit
//     blocks: the bit rows of A's pattern of every bin (sum: keep without
//     rev; mean: keep), which every layer and column slice reads, so no block
//     rebuilds them, a word a thread by branch-free compares whose loads go
//     out together; for the encoder also the scatter's node bit rows, and h0
//     = nf[src] + ef into scratch, written once (gathering in the products'
//     loaders made the reverse sweep's layer-0 products 0.13 ms against 0.09,
//     PERF.md §6);
//   - mpnn_fwd_gemm_kernel, once a layer: mW = relu(h_in) @ W over all B * E
//     rows into a [B * E, d] scratch that stays in the 50 MB L2, as 64 x 64
//     tiles of 128 threads, 8 x 4 outputs a thread, k-slabs of 16 of both
//     operands staged in shared memory in two stages (the reverse sweep's
//     tile, dense_mpnn_bwd.cu): at B = 32, E = 128, d = 256 that is 256
//     blocks of 4 warps, where a (bin, 64-column) grid gives 128 blocks that
//     each run their phases between barriers;
//   - mpnn_fwd_apply_kernel, once a layer, on a (bin, 64-column) grid of
//     1,024-thread blocks: the block stages its bin's mW slice (16-byte
//     loads) and bit rows in shared memory and walks each row's set bits, so
//     A costs operations only where it is nonzero and is never stored. A walk
//     is a chain of dependent shared-memory loads, so a block has many
//     threads, each with few rows. In the encoder's last layer the block also
//     keeps its output slice and writes the masked scatter: it owns every
//     edge of its bin for its columns, so the sum needs no atomics.
// Every sum runs in one fixed order, which row 7's kernel below shares: each
// output of mW is one fmaf chain over k in ascending order; then s over A's
// set bits in ascending e', bias + s, and h_in + that; the scatter over
// ascending e. So row 7 gives row 1's bits, two calls give the same bits, and
// rows 1, 2, 4 and 5 keep the bits of the one-kernel-a-layer forward they
// replaced (PERF.md §6). No float atomics. What it leaves: plain FMA from
// shared memory with no tensor cores (wgmma needs TF32 or bf16 operands,
// which changes the numbers), and mW and each layer's output go through L2
// between the launches.
//
// The double-buffered layer (dense_mpnn_dbuf_layer) runs on a (bin, 64-column
// slice of d) grid of 256 threads a block. 1. The block builds A's bit rows
// in shared memory (build_bits). 2. mW[:, slice] = relu(h_in[b]) @ W[:,
// slice] by k-tiled shared-memory f32 FMA: the 32-deep tiles of h and W go
// from device memory to shared memory by cp.async in a two-stage pipeline
// (the next tile's copies in flight while the block computes on this one,
// cp.async.wait_group between stages), and relu is applied in shared memory
// once a tile has landed (a copy cannot transform what it moves). 3. Each
// output row walks the set bits of its A row and sums the mW rows they name
// (write_rows), the residual reads issued eight rows at a time.
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
constexpr int kMaxWords = kMaxEdges / 32;   // words of a bit row
constexpr int kVecs = kCols / 4;            // 16-byte vectors of a 64-column slice row

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

// ---- the forward: once a call, the prep --------------------------------------

constexpr int kPrepSplit = 4;    // blocks a bin's prep is spread over
constexpr int kGatherBatch = 8;  // h0 vectors a thread has in flight

// Word w of a bit row over the bin's staged lanes: bit t set where lane e2 =
// 32 w + t is below E, kept (ok_s) and has dst_s[e2] == key, and e2 != skip.
// Branch-free, so the 32 pairs of shared-memory loads go out together (the
// staged arrays hold kMaxEdges lanes, so no load leaves them).
__device__ inline uint32_t match_word(const int* dst_s, const int* ok_s, int E, int w, int key,
                                      int skip) {
  uint32_t bits = 0u;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const int e2 = w * 32 + t;
    bits |= (uint32_t)((e2 < E) & (ok_s[e2] != 0) & (dst_s[e2] == key) & (e2 != skip)) << t;
  }
  return bits;
}

// Grid (bin, kPrepSplit); block (b, p) takes every kPrepSplit-th word of bin
// b's bit rows from word p on: A's rows into adj[b, E, words] (sum: keep
// without rev; mean: keep) and, with node_bits non-null, the scatter's node
// rows into node_bits[b, V, words] (bit e of row v: dst[e] == v and
// emask[e]). With h0 non-null it also writes the 64-column slices p, p +
// kPrepSplit, ... of bin b's layer-0 input h0 = nf[src] + ef (input_vec's
// order of the add).
__global__ void __launch_bounds__(kThreads)
mpnn_fwd_prep_kernel(const float* __restrict__ ef, const float* __restrict__ nf,
                     float* __restrict__ h0, const int* __restrict__ src,
                     const int* __restrict__ dst, const uint8_t* __restrict__ emask,
                     uint32_t* __restrict__ adj, uint32_t* __restrict__ node_bits, int E, int V,
                     int d, int mean) {
  __shared__ int src_s[kMaxEdges], dst_s[kMaxEdges], ok_s[kMaxEdges];
  const int b = blockIdx.x, part = blockIdx.y, tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;
  for (int e = tid; e < E; e += kThreads) {
    src_s[e] = src[bin_off + e];
    dst_s[e] = dst[bin_off + e];
    ok_s[e] = emask[bin_off + e] != 0;
  }
  if (h0)
    for (int c0 = part * kCols; c0 < d; c0 += kPrepSplit * kCols)
      for (int i0 = tid; i0 < E * kVecs; i0 += kGatherBatch * kThreads) {
        float4 v[kGatherBatch];
#pragma unroll
        for (int t = 0; t < kGatherBatch; ++t) {
          const int i = i0 + t * kThreads;
          if (i < E * kVecs)
            v[t] = input_vec<true>(ef, nf, src, bin_off + i / kVecs, b, V, d, c0, i % kVecs);
        }
#pragma unroll
        for (int t = 0; t < kGatherBatch; ++t) {
          const int i = i0 + t * kThreads;
          if (i < E * kVecs)
            reinterpret_cast<float4*>(h0 + (bin_off + i / kVecs) * d + c0)[i % kVecs] = v[t];
        }
      }
  __syncthreads();
  const int words = adj_words(E);
  for (int i = tid * kPrepSplit + part; i < E * words; i += kThreads * kPrepSplit) {
    const int e = i / words;
    adj[bin_off * words + i] = match_word(dst_s, ok_s, E, i % words, src_s[e], mean ? -1 : e ^ 1);
  }
  if (node_bits)
    for (int i = tid * kPrepSplit + part; i < V * words; i += kThreads * kPrepSplit)
      node_bits[(size_t)b * V * words + i] = match_word(dst_s, ok_s, E, i % words, i / words, -1);
}

// ---- per layer: mW = relu(h_in) @ W over all B * E rows -----------------------

// A kGemmRows x 64 tile of mW: 128 threads, thread (ty, tx) owns rows
// kTM ty .. kTM ty + kTM - 1 and columns 4 tx .. 4 tx + 3. Both operands'
// k-slabs land k-major in shared memory (relu(h)^T as As[k][m], W as
// Bs[k][n]); each thread loads its share of the next slab into registers
// while the block computes on this one, then stores it, one barrier a slab.
// Each output is one fmaf chain over k in ascending order. (32-row tiles, twice
// the blocks, were slower: PERF.md §6.)
constexpr int kGemmRows = 64;
constexpr int kBN = kCols;
constexpr int kBK = 16;  // k depth of a slab
constexpr int kTN = 4;   // columns a thread
constexpr int kGemmThreads = 128;
constexpr int kGemmMinBlocks = 1;  // blocks an SM's registers must hold
constexpr int kTM = kGemmRows * kBN / (kTN * kGemmThreads);  // rows a thread
constexpr int kLdA = kGemmRows + 4, kLdB = kBN + 4;
constexpr int kSlabA = kBK * kLdA, kSlabB = kBK * kLdB;  // floats of one stage's slabs
constexpr int kGroupsA = kGemmRows * kBK / 4 / kGemmThreads;  // 16-byte groups a thread loads
constexpr int kGroupsB = kBK * kBN / 4 / kGemmThreads;
static_assert(kTM * kTN * kGemmThreads == kGemmRows * kBN && kTM % 4 == 0 && kGroupsA >= 1 &&
                  kGroupsB >= 1, "tile shape");

__device__ inline void gemm_compute(const float* As, const float* Bs, float (&acc)[kTM][kTN]) {
  const int ty = threadIdx.x / (kBN / kTN), tx = threadIdx.x % (kBN / kTN);
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * kLdB + tx * kTN);
    float a[kTM];
#pragma unroll
    for (int i = 0; i < kTM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(As + kk * kLdA + ty * kTM + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
    const float b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Grid: ceil(R / kGemmRows) * (d / 64) blocks, the column tiles of a row
// tile next to each other. h is the layer's input [R, d], W [d, d] row-major
// [in, out], mw [R, d].
__global__ void __launch_bounds__(kGemmThreads, kGemmMinBlocks)
mpnn_fwd_gemm_kernel(const float* __restrict__ h, const float* __restrict__ W,
                     float* __restrict__ mw, int R, int d) {
  __shared__ __align__(16) float S[2 * (kSlabA + kSlabB)];
  const int tn = d / kBN;
  const int m0 = blockIdx.x / tn * kGemmRows, n0 = blockIdx.x % tn * kBN;
  const int ty = threadIdx.x / (kBN / kTN), tx = threadIdx.x % (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float4 ra[kGroupsA], rb[kGroupsB];
  auto load = [&](int k0) {
#pragma unroll
    for (int t = 0; t < kGroupsA; ++t) {  // relu(h) rows m0.. along k
      const int g = threadIdx.x + t * kGemmThreads;
      const int m = m0 + g / (kBK / 4), k = k0 + g % (kBK / 4) * 4;
      ra[t] = m < R ? *reinterpret_cast<const float4*>(h + (size_t)m * d + k)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < kGroupsB; ++t) {  // W rows k0.. along n
      const int g = threadIdx.x + t * kGemmThreads;
      const int k = k0 + g / (kBN / 4), n = n0 + g % (kBN / 4) * 4;
      rb[t] = *reinterpret_cast<const float4*>(W + (size_t)k * d + n);
    }
  };
  auto store = [&](float* stage) {
#pragma unroll
    for (int t = 0; t < kGroupsA; ++t) {
      const int g = threadIdx.x + t * kGemmThreads;
      float* s = stage + g % (kBK / 4) * 4 * kLdA + g / (kBK / 4);
      s[0] = relu(ra[t].x);
      s[kLdA] = relu(ra[t].y);
      s[2 * kLdA] = relu(ra[t].z);
      s[3 * kLdA] = relu(ra[t].w);
    }
    float* bs = stage + kSlabA;
#pragma unroll
    for (int t = 0; t < kGroupsB; ++t) {
      const int g = threadIdx.x + t * kGemmThreads;
      *reinterpret_cast<float4*>(bs + g / (kBN / 4) * kLdB + g % (kBN / 4) * 4) = rb[t];
    }
  };
  load(0);
  store(S);
  __syncthreads();
  int s = 0;
  for (int k = 0; k < d; k += kBK) {
    const bool more = k + kBK < d;
    if (more) load(k + kBK);
    float* stage = S + s * (kSlabA + kSlabB);
    gemm_compute(stage, stage + kSlabA, acc);
    if (more) store(S + (s ^ 1) * (kSlabA + kSlabB));
    __syncthreads();
    s ^= 1;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty * kTM + i;
    if (r >= R) break;
    *reinterpret_cast<float4*>(mw + (size_t)r * d + n0 + tx * kTN) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---- per layer: h_out = (h_in +) bias + A @ mW, and the scatter ---------------

constexpr int kApplyThreads = 1024;  // 512 was slower on rows 1 and 2 (PERF.md §6)
// blocks an SM's registers must hold (2, which caps a thread at 32, was slower: PERF.md §6)
constexpr int kApplyMinBlocks = 1;
constexpr int kPhases = kApplyThreads / kCols;  // rows a block pass covers

__host__ inline size_t apply_smem_bytes(int E, int V, bool scatter) {
  return sizeof(float) * (size_t)E * kCols * (scatter ? 2 : 1)             // mW slice (outputs)
         + sizeof(uint32_t) * (size_t)(E + (scatter ? V : 0)) * adj_words(E);  // bit rows
}

// The sum over the set bits e of a bit row of `words` words, in ascending e,
// of term(e), the row's words loaded together; deg gets the count of bits.
template <typename Term>
__device__ inline float walk_row(const uint32_t* row, int words, int& deg, const Term& term) {
  uint32_t wb[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) wb[w] = w < words ? row[w] : 0u;
  float s = 0.f;
  deg = 0;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    uint32_t bits = wb[w];
    deg += __popc(bits);
    while (bits) {
      const int e = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1u;
      s += term(e);
    }
  }
  return s;
}

// Grid (bin, 64-column slice of d), kApplyThreads a block. mw_g is the
// layer's product [B * E, d], h_in its input (read for the residual), adj_g
// and node_bits_g the prep's bit rows. With kScatter (the encoder's last
// layer) the block also writes nh[b, :, slice].
template <bool kScatter>
__global__ void __launch_bounds__(kApplyThreads, kApplyMinBlocks)
mpnn_fwd_apply_kernel(const float* __restrict__ mw_g, const float* __restrict__ h_in,
                      float* __restrict__ h_out, float* __restrict__ nh,
                      const uint32_t* __restrict__ adj_g, const uint32_t* __restrict__ node_bits_g,
                      const float* __restrict__ bias, int E, int V, int d, int residual,
                      int mean) {
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* mw = reinterpret_cast<float*>(smem4);                            // [E][kCols]
  float* outs = mw + (size_t)E * kCols;                                   // [E][kCols] (scatter)
  uint32_t* adj = reinterpret_cast<uint32_t*>(outs + (kScatter ? (size_t)E * kCols : 0));  // [E][words]
  uint32_t* node_bits = adj + (size_t)E * words;                          // [V][words] (scatter)

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;

  {  // the mW slice, every thread's loads in flight before it stores the first
    constexpr int kPer = kMaxEdges * kVecs / kApplyThreads;
    float4 v[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * kApplyThreads;
      if (i < E * kVecs)
        v[t] = reinterpret_cast<const float4*>(mw_g + (bin_off + i / kVecs) * d + c0)[i % kVecs];
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * kApplyThreads;
      if (i < E * kVecs)
        reinterpret_cast<float4*>(mw + (size_t)(i / kVecs) * kCols)[i % kVecs] = v[t];
    }
  }
  for (int i = tid; i < E * words; i += kApplyThreads) adj[i] = adj_g[bin_off * words + i];
  if constexpr (kScatter)
    for (int i = tid; i < V * words; i += kApplyThreads)
      node_bits[i] = node_bits_g[(size_t)b * V * words + i];
  __syncthreads();

  const int c = tid % kCols;
  const float bc = bias[c0 + c];
  for (int e0 = tid / kCols; e0 < E; e0 += kPhases * kResGroup) {
    float res[kResGroup];
#pragma unroll
    for (int u = 0; u < kResGroup; ++u) {
      const int e = e0 + u * kPhases;
      res[u] = residual && e < E ? h_in[(bin_off + e) * d + c0 + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kResGroup; ++u) {
      const int e = e0 + u * kPhases;
      if (e >= E) break;
      int deg;
      float s = walk_row(adj + (size_t)e * words, words, deg,
                         [&](int e2) { return mw[e2 * kCols + c]; });
      if (mean) s = s / fmaxf((float)deg, 1.f) - mw[(e ^ 1) * kCols + c];
      const float o = bc + s;
      const float hv = residual ? res[u] + o : o;
      h_out[(bin_off + e) * d + c0 + c] = hv;
      if constexpr (kScatter) outs[e * kCols + c] = hv;
    }
  }
  if constexpr (kScatter) {
    __syncthreads();
    for (int v = tid / kCols; v < V; v += kPhases) {
      int deg;
      float s = walk_row(node_bits + (size_t)v * words, words, deg,
                         [&](int e) { return outs[e * kCols + c]; });
      if (mean) s = s / fmaxf((float)deg, 1.f);
      nh[((size_t)b * V + v) * d + c0 + c] = s;
    }
  }
}

template <bool kScatter>
cudaError_t launch_apply(const float* mw, const float* h_in, float* h_out, float* nh,
                         const uint32_t* adj, const uint32_t* node_bits, const float* bias, int B,
                         int E, int V, int d, int residual, int mean, cudaStream_t s) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)mpnn_fwd_apply_kernel<kScatter>,
                               (int)apply_smem_bytes(kMaxEdges, kMaxNodes, kScatter), configured);
  if (err != cudaSuccess) return err;
  mpnn_fwd_apply_kernel<kScatter><<<dim3(B, d / kCols), kApplyThreads,
                                    apply_smem_bytes(E, V, kScatter), s>>>(
      mw, h_in, h_out, nh, adj, node_bits, bias, E, V, d, residual, mean);
  return cudaGetLastError();
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

// The whole forward of one block call: layers 0 .. layers - 1, layer l
// reading the previous output (h_in first) and writing outs[l] (a host array
// of `layers` device pointers, none of them a layer's own input), with
// W[l] = W + l * d * d ([in, out], row-major) and bias[l] = bias + l * d.
// h_in, outs[l] [B,E,d]; src/dst[B,E] int32, emask[B,E] bytes. With gather
// != 0, h_in is ef[B,E,d] and layer 0's input is nf[src] + ef, nf[B,V,d];
// with scatter != 0 the last layer also writes nh[B,V,d] (see the top of the
// file). Scratch: adj[B,E,ceil(E/32)] and, with scatter, node_bits[B,V,
// ceil(E/32)] (uint32); with gather, h0[B,E,d]; mw[B,E,d]. All pointers but
// outs are device pointers of contiguous arrays; h_in, every outs[l], W, nf,
// h0 and mw start 16-byte aligned. The stream is a cudaStream_t. Returns the
// cudaError_t of the launches (0 on success).
int dense_mpnn_forward(const float* h_in, float* const* outs, const float* nf, float* nh,
                       const int* src, const int* dst, const uint8_t* emask, const float* W,
                       const float* bias, uint32_t* adj, uint32_t* node_bits, float* h0, float* mw,
                       int B, int V, int E, int d, int layers, int residual, int mean, int gather,
                       int scatter, void* stream) {
  if (bad_shape(B, E, d) || layers <= 0 || !outs) return (int)cudaErrorInvalidValue;
  if ((gather || scatter) && (V <= 0 || V > kMaxNodes || (gather && (!nf || !h0)) ||
                              (scatter && (!nh || !node_bits))))
    return (int)cudaErrorInvalidValue;
  uintptr_t addr = (uintptr_t)h_in | (uintptr_t)W | (uintptr_t)nf | (uintptr_t)h0 | (uintptr_t)mw;
  for (int l = 0; l < layers; ++l) addr |= (uintptr_t)outs[l];
  if (addr % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  mpnn_fwd_prep_kernel<<<dim3(B, kPrepSplit), kThreads, 0, s>>>(
      h_in, nf, gather ? h0 : nullptr, src, dst, emask, adj, scatter ? node_bits : nullptr, E, V,
      d, mean);
  cudaError_t err = cudaGetLastError();
  const int R = B * E;
  const float* x = gather ? h0 : h_in;
  for (int l = 0; l < layers && err == cudaSuccess; ++l) {
    mpnn_fwd_gemm_kernel<<<(R + kGemmRows - 1) / kGemmRows * (d / kBN), kGemmThreads, 0, s>>>(
        x, W + (size_t)l * d * d, mw, R, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    const float* b = bias + (size_t)l * d;
    err = scatter && l == layers - 1
              ? launch_apply<true>(mw, x, outs[l], nh, adj, node_bits, b, B, E, V, d, residual,
                                   mean, s)
              : launch_apply<false>(mw, x, outs[l], nullptr, adj, nullptr, b, B, E, V, d,
                                    residual, mean, s);
    x = outs[l];
  }
  return (int)err;
}

// One layer of the double-buffered forward: h_out[B,E,d] from h_in[B,E,d],
// src/dst[B,E] int32, emask[B,E] bytes, W[d,d] ([in, out], row-major),
// bias[d]; h_in, h_out and W start 16-byte aligned. The stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
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
