// The forward of the folded dense D-MPNN block, in CUDA C++ for sm_90a: a
// prep once a call, then per layer one tiled product over all B * E rows and
// one pass of the edge operator, with the whole encoder's gather folded into
// the prep and its masked scatter into the last layer's pass; and row 7's
// whole call in one launch, a group of blocks a bin.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_mpnn.py:
//   - fused_dense_mpnn_block / _block_kernel (with its operator
//     _edge_adjacency) and fused_dense_mpnn_block_stash /
//     _block_kernel_stash: dense_mpnn_forward;
//   - fused_dense_encoder_fwd / _encoder_kernel(_stash): dense_mpnn_forward
//     with the V->E gather and the masked E->V scatter;
//   - fused_dense_mpnn_block_dbuf / _dbuf_kernel: dense_mpnn_dbuf_forward.
// The Python wrapper (notorch_tpu_torch/kernels/dense_mpnn.py) calls
// dense_mpnn_forward once a block call: it launches the prep and every layer
// from C++, layer l writing outs[l] (two buffers in turn, or the stash). It
// calls dense_mpnn_dbuf_forward once a call: one launch.
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
// matmul_dtype="bfloat16" (the TPU kernels' mm_dtype) is the kBf16
// instantiation of the prep and operator kernels, and mpnn_fwd_gemm_mma_kernel
// for the product: every operand the TPU kernel casts with .astype(bfloat16)
// is rounded to bf16 (nearest, ties to even) where it is staged, and the sums
// stay f32, so each product of two operands is exact and only the sums round:
// relu(h) and W into the product, which multiplies them on the tensor cores
// (bf16_mma.cuh: mma.sync m16n8k16, f32 accumulate; the TPU kernel's
// relu(h).astype(mm) @ W.astype(mm) with preferred_element_type=f32) and
// writes mW rounded to bf16, the operand the operator takes; the mean's
// coefficients as bf16(1 / indeg) and, on a kept rev lane, bf16(1 / indeg - 1)
// (the TPU kernel rounds keep / indeg - rev as a whole); for the encoder nf
// into the gather, and the last output and the mean's 1 / count into the
// scatter. The operator and the encoder's ends keep the orders above; the
// product's sums run in the tensor cores' order, not by ascending k, so they
// differ from an f32 FMA chain by f32 roundings (two calls give the same
// bits). At the tensor cores' bf16 rate the product takes a fraction of the
// time its operands take to arrive: it is bound by the bytes of relu(h) and
// W through L2 (each kMmaRows x kMmaCols tile reads its rows of h and its
// columns of W, f32, rounded as staged), and writes mW in bf16, half the f32
// bytes, as the operator pass then reads it. The layer state h stays f32. A
// bf16 stash (stash_dtype) is a second output of the operator pass, h
// rounded as it is written.
//
// Row 7 (dense_mpnn_dbuf_forward, dense_mpnn_dbuf_kernel) keeps the TPU
// kernel's contract in Hopper's terms: the TPU kernel holds a tile of bins in
// VMEM through all depth layers while DMA streams the next tile in and the
// last one out. Here one launch runs the whole call, depth-fused: a group of
// d / 64 blocks owns a bin, block r keeping columns [64 r, 64 r + 64) of the
// bin's h and of each layer's mW in its shared memory through every layer
// (the packed batch's 32 bins are 128 blocks, one an SM, one wave). The
// product relu(h) @ W[:, slice] reads the whole of the layer's input through
// L2 (layer 0's from h_in, later ones from what the group's blocks wrote) and
// streams W's 16-deep k-slabs: half the block's threads compute on a slab
// while the other half load the next one (all threads computing and loading
// in turn took 0.080 ms against 0.069, PERF.md §6); the operator pass
// needs only the block's own mW columns, writes h in place and its slice to
// device memory for the others' next product; a barrier of the group's blocks separates one pass
// from the next product. The launch is cooperative, so every block is
// resident and the barrier (an arrival count in device memory and a
// generation the last arrival advances) cannot wait on a block that never
// runs; a batch of more bins than the card holds groups at once is taken by
// each group in turn. The bit rows are built once a bin, layer 0's input is
// read once and the last layer's output written once. Each computing thread
// owns TM rows x 4 columns (TM = 8 at E <= 128, row 1's tile; 16 at E <= 256),
// each output one fmaf chain over ascending k as in row 1's product, and the
// walk is row 1's, so row 7 gives row 1's bits. Row 7b (matmul_dtype=
// "bfloat16", dense_mpnn_dbuf_mma_kernel) keeps the launch, the groups, the
// slices and the barrier, and takes row 1b's product and roundings: every
// thread of the block multiplies on the tensor cores (bf16_mma.cuh, the bin's
// rows x the block's 64 columns, 16 warps), each output summed k16 by k16 in
// ascending k from zero as row 1b's tiles sum it (the sum of one k16 step does
// not depend on where the output sits in a tile), from bf16(relu(h)) and W
// rounded as staged, mW rounded to bf16 and kept so in shared memory, and the
// mean's coefficients rounded (walk_pair, in mean_row_bf16's order); so row 7b
// gives row 1b's bits.
// Its blocks exchange bf16(relu(h)), the operand the next product takes,
// instead of f32 h: half the bytes through L2, copied by cp.async straight
// into the slabs; h stays f32 in shared memory for the residual, and only
// the last layer writes out.
// (A cluster a bin, the slices read through distributed shared memory, was
// the first design: the card holds 30 clusters of 4 blocks at once, so the
// packed batch's 32 bins ran in two waves, 0.153 ms, PERF.md §6.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kCols = 64;       // output columns per block
constexpr int kThreads = 256;
constexpr int kMaxEdges = 256;  // edge lanes per bin these kernels take
constexpr int kMaxNodes = 256;  // node slots per bin the scatter takes
constexpr int kResGroup = 8;    // residual reads in flight per thread in the operator pass
constexpr int kMaxWords = kMaxEdges / 32;   // words of a bit row
constexpr int kVecs = kCols / 4;            // 16-byte vectors of a 64-column slice row

__device__ inline float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN passes, as in torch

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
// order of the add; with kBf16 nf rounded to bf16 first).
template <bool kBf16>
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
            v[t] = input_vec<true, kBf16>(ef, nf, src, bin_off + i / kVecs, b, V, d, c0, i % kVecs);
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

// One k-slab of a thread's TM x kTN outputs: As is the slab of relu(h), k-major
// with rows LdA apart, Bs W's, k-major with rows kLdB apart.
template <int TM, int LdA>
__device__ inline void gemm_compute(const float* As, const float* Bs, float (&acc)[TM][kTN]) {
  const int ty = threadIdx.x / (kBN / kTN), tx = threadIdx.x % (kBN / kTN);
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * kLdB + tx * kTN);
    float a[TM];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(As + kk * LdA + ty * TM + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
    const float b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Grid: ceil(R / kGemmRows) * (d / 64) blocks, the column tiles of a row
// tile next to each other. h is the layer's input [R, d], W [d, d] row-major
// [in, out], mw [R, d]. Exact f32 (the bf16 product is
// mpnn_fwd_gemm_mma_kernel below).
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
    gemm_compute<kTM, kLdA>(stage, stage + kSlabA, acc);
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

// The bf16 product's tiles: kMmaRows x kMmaCols of kMmaWarpsM x kMmaWarpsN
// warps where d is a multiple of kMmaCols, else kMmaRows x 64 (d is a
// multiple of 64), k-slabs of 32; kMmaMinBlocks blocks an SM at least (the
// register cap: at 3, 170 registers, the 64 x 128 tile spilled). Timed
// against 128 x 128 of 8 warps, 64 x 256, 128 x 64, and W rounded to bf16
// once a call and copied by cp.async, all at the same bits (PERF.md §6).
constexpr int kMmaRows = 64;
constexpr int kMmaCols = 128;
constexpr int kMmaWarpsM = 2;
constexpr int kMmaWarpsN = 2;
constexpr int kMmaMinBlocks = 2;
using MmaWide = mma::Shape<kMmaRows, kMmaCols, kMmaWarpsM, kMmaWarpsN, 32>;
using MmaNarrow = mma::Shape<kMmaRows, kCols, kMmaWarpsM, kMmaWarpsN, 32>;

// mW = relu(h) @ W on the tensor cores, rounded to bf16: the tile's rows of
// h (f32, m-major, the ReLU taken and the values rounded to bf16 as staged)
// and columns of W (f32, k-major, rounded as staged), f32 sums, each pair of
// neighbouring outputs written as one bf16 pair. Grid: ceil(R / S::kM) *
// (d / S::kN) blocks, the column tiles of a row tile next to each other (so
// its rows of h are read from L2 while they are there).
template <typename S>
__global__ void __launch_bounds__(S::kThreads, kMmaMinBlocks)
mpnn_fwd_gemm_mma_kernel(const float* __restrict__ h, const float* __restrict__ W,
                         __nv_bfloat16* __restrict__ mw, int R, int d) {
  __shared__ __align__(16) __nv_bfloat16 smem[S::kSmemHalfs];
  const int tn = d / S::kN;
  const int m0 = blockIdx.x / tn * S::kM, n0 = blockIdx.x % tn * S::kN;
  mma::RowsF32<S, true> la{h, d, m0, R};
  mma::ColsF32<S, S::kN, S::kLdB, false> lb{W, d, n0, d};
  typename S::Tile acc;
  mma::tile_products<S>(0, d, smem, la, lb, acc);
  const int r0 = m0 + S::row0(), c0 = n0 + S::col0();
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + i * 16 + 8 * hf;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
        *reinterpret_cast<unsigned*>(mw + (size_t)r * d + c0 + j * 8) =
            mma::pack_bf16x2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
    }
}

template <typename S>
cudaError_t launch_gemm_mma(const float* h, const float* W, __nv_bfloat16* mw, int R, int d, cudaStream_t s) {
  mpnn_fwd_gemm_mma_kernel<S><<<(R + S::kM - 1) / S::kM * (d / S::kN), S::kThreads, 0, s>>>(h, W, mw, R, d);
  return cudaGetLastError();
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

// The count of set bits of a bit row of `words` words.
__device__ inline int row_bits(const uint32_t* row, int words) {
  int deg = 0;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) deg += w < words ? __popc(row[w]) : 0;
  return deg;
}

// Row e's sum of the mean operator with bf16 coefficients, the TPU kernel's
// A.astype(bfloat16): bf16(1 / indeg) on every kept lane but rev(e), and on
// rev(e) bf16(1 / indeg - 1) where it is kept, else -1 (A's rev diagonal).
// x(e2) is the (already rounded) operand of lane e2; each product is exact
// in f32 and the sum runs in ascending e2, then the unkept rev term.
template <typename X>
__device__ inline float mean_row_bf16(const uint32_t* row, int words, int e, const X& x) {
  const float inv = 1.f / fmaxf((float)row_bits(row, words), 1.f);
  const float c = operand<true>(inv), c_rev = operand<true>(inv - 1.f);
  const int rev = e ^ 1;
  int deg;
  float s = walk_row(row, words, deg, [&](int e2) { return (e2 == rev ? c_rev : c) * x(e2); });
  if (!(row[rev >> 5] >> (rev & 31) & 1u)) s -= x(rev);
  return s;
}

// Grid (bin, 64-column slice of d), kApplyThreads a block. mw_g is the
// layer's product [B * E, d] (f32; with kBf16 bf16, as the bf16 product
// writes it), h_in its input (read for the residual), adj_g
// and node_bits_g the prep's bit rows. With kScatter (the encoder's last
// layer) the block also writes nh[b, :, slice]. With hs_out non-null the
// block also writes h_out rounded to bf16 there (the bf16 stash; h_out, the
// next layer's input, stays f32). With kBf16 the operator's operands are
// rounded to bf16, as the TPU kernel rounds them: mW (rounded by the
// product), the mean's coefficients (mean_row_bf16), and for the scatter
// the layer's output and the mean's 1 / count.
template <bool kScatter, bool kBf16>
__global__ void __launch_bounds__(kApplyThreads, kApplyMinBlocks)
mpnn_fwd_apply_kernel(const void* __restrict__ mw_g, const float* __restrict__ h_in,
                      float* __restrict__ h_out, __nv_bfloat16* __restrict__ hs_out,
                      float* __restrict__ nh, const uint32_t* __restrict__ adj_g,
                      const uint32_t* __restrict__ node_bits_g, const float* __restrict__ bias,
                      int E, int V, int d, int residual, int mean) {
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
      if (i < E * kVecs) {
        const size_t at = (bin_off + i / kVecs) * d + c0 + i % kVecs * 4;
        if constexpr (kBf16) v[t] = load_bf16x4(static_cast<const __nv_bfloat16*>(mw_g), at);
        else v[t] = *reinterpret_cast<const float4*>(static_cast<const float*>(mw_g) + at);
      }
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * kApplyThreads;
      if (i < E * kVecs) reinterpret_cast<float4*>(mw + (size_t)(i / kVecs) * kCols)[i % kVecs] = v[t];
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
      const uint32_t* row = adj + (size_t)e * words;
      const auto x = [&](int e2) { return mw[e2 * kCols + c]; };
      float s;
      if (kBf16 && mean) {
        s = mean_row_bf16(row, words, e, x);
      } else {
        int deg;
        s = walk_row(row, words, deg, x);
        if (mean) s = s / fmaxf((float)deg, 1.f) - mw[(e ^ 1) * kCols + c];
      }
      const float o = bc + s;
      const float hv = residual ? res[u] + o : o;
      h_out[(bin_off + e) * d + c0 + c] = hv;
      if (hs_out) hs_out[(bin_off + e) * d + c0 + c] = __float2bfloat16_rn(hv);
      if constexpr (kScatter) outs[e * kCols + c] = operand<kBf16>(hv);
    }
  }
  if constexpr (kScatter) {
    __syncthreads();
    for (int v = tid / kCols; v < V; v += kPhases) {
      const uint32_t* row = node_bits + (size_t)v * words;
      int deg;
      float s;
      if (kBf16 && mean) {  // sum of bf16(1 / count) * bf16(h), each product exact
        const float scale = operand<true>(1.f / fmaxf((float)row_bits(row, words), 1.f));
        s = walk_row(row, words, deg, [&](int e) { return scale * outs[e * kCols + c]; });
      } else {
        s = walk_row(row, words, deg, [&](int e) { return outs[e * kCols + c]; });
        if (mean) s = s / fmaxf((float)deg, 1.f);
      }
      nh[((size_t)b * V + v) * d + c0 + c] = s;
    }
  }
}

template <bool kScatter, bool kBf16>
cudaError_t launch_apply(const void* mw, const float* h_in, float* h_out, __nv_bfloat16* hs_out,
                         float* nh, const uint32_t* adj, const uint32_t* node_bits,
                         const float* bias, int B, int E, int V, int d, int residual, int mean,
                         cudaStream_t s) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)mpnn_fwd_apply_kernel<kScatter, kBf16>,
                               (int)apply_smem_bytes(kMaxEdges, kMaxNodes, kScatter), configured);
  if (err != cudaSuccess) return err;
  mpnn_fwd_apply_kernel<kScatter, kBf16><<<dim3(B, d / kCols), kApplyThreads,
                                           apply_smem_bytes(E, V, kScatter), s>>>(
      mw, h_in, h_out, hs_out, nh, adj, node_bits, bias, E, V, d, residual, mean);
  return cudaGetLastError();
}

// ---- row 7: the whole block call in one launch ------------------------------

constexpr int kDbufThreads = 512;
constexpr int kDbufMaxSlices = 16;  // d <= 1024
constexpr int kDbufMinBlocks = 1;  // blocks an SM's registers must hold
constexpr int kHLd = kCols + 4;    // row of a block's h slice
constexpr int kDbufGroupsB = kBK * kBN / 4;  // 16-byte groups of a W slab (threads below load one)
constexpr int kMaxGroups = 2048;   // bin groups a launch may hold (each has its barrier)
// a bin group's barrier: arrivals (back to 0 after every barrier) and the
// generation its last arrival advances; zero when the library loads
__device__ unsigned dbuf_arrivals[kMaxGroups];
__device__ unsigned dbuf_generation[kMaxGroups];

// The product's threads: the first kDbufCompute of a block compute TM x 4
// outputs each (16 column groups of 4, kDbufCompute / 16 row groups), the
// others load the next slabs meanwhile. Rows a block's product covers:
constexpr int kDbufCompute = 256;
template <int TM>
__host__ __device__ constexpr int dbuf_rows() {
  return TM * (kDbufCompute / (kBN / kTN));
}

// Row 7b's product: a dbuf_rows<TM>() x 64 tile (the bin's rows, those past
// E staged as zeros) of the block's 16 warps, each 32 rows x the columns that
// leaves (32 x 16 at E <= 128, 32 x 32 at E <= 256; 16-row warps timed the
// same), k-slabs of kDbufMmaK (64 was slower, PERF.md §6); mW kept in bf16,
// its rows kMwLd halves apart (the 8 rows a warp's accumulators store lie in
// distinct banks).
constexpr int kDbufMmaK = 32;
constexpr int kMwLd = kCols + 8;
template <int TM>
using DbufMma = mma::Shape<dbuf_rows<TM>(), kCols, dbuf_rows<TM>() / 32, kDbufThreads / 32 / (dbuf_rows<TM>() / 32),
                           kDbufMmaK>;
static_assert(DbufMma<8>::kThreads == kDbufThreads && DbufMma<16>::kThreads == kDbufThreads, "all threads multiply");

// A block's shared memory: its h slice [E][kHLd] and mW slice [E][kCols],
// two stages of the relu(h) k-slab ([kBK][dbuf_rows + 4]) and of W's
// ([kBK][kLdB]), then A's bit rows [E][words] and the bin's src, dst and mask
// over 32 words lanes each. Row 7b (kBf16): the h slice, the product's two
// stages (DbufMma), mW in bf16 [E][kMwLd], then the same bit rows and arrays.
template <int TM, bool kBf16>
__host__ __device__ inline size_t dbuf_smem_bytes(int E) {
  const int words = adj_words(E);
  const size_t tail = sizeof(uint32_t) * ((size_t)E * words + 3 * 32 * (size_t)words);
  if constexpr (kBf16)
    return sizeof(float) * (size_t)E * kHLd +
           sizeof(__nv_bfloat16) * ((size_t)DbufMma<TM>::kSmemHalfs + (size_t)E * kMwLd) + tail;
  return sizeof(float) * ((size_t)E * kHLd + (size_t)E * kCols +
                          2 * (size_t)kBK * (dbuf_rows<TM>() + 4) + 2 * (size_t)kBK * kLdB) +
         tail;
}

__device__ inline unsigned long long dbuf_clock_ns() {
  unsigned long long t = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 1 builds the stage stamps of rows 7 and 7b (the timing script's --define
// kDbufStages=1): thread 0 of each of the first kStampBlocks blocks writes
// %globaltimer, in its first bin, at the bin's start (slot 0), with the
// prologue done (1), and for each layer l < kStampLayers with the product's
// mW in place (2 + 3 l), the operator pass done (3 + 3 l) and the group's
// barrier passed (4 + 3 l). The stamps after the prologue and the pass wait
// for the whole block first (a barrier the default build does not have).
constexpr int kDbufStages = 0;
constexpr int kStampBlocks = kDbufStages != 0 ? 1024 : 1, kStampLayers = 8;
constexpr int kStampSlots = 2 + 3 * kStampLayers;
__device__ unsigned long long dbuf_at[kStampBlocks][kStampSlots];

__device__ inline void dbuf_stamp(bool first_bin, int slot, bool whole_block = false) {
  if constexpr (kDbufStages != 0) {
    if (whole_block) __syncthreads();
    if (!first_bin || threadIdx.x != 0 || blockIdx.x >= kStampBlocks || slot >= kStampSlots) return;
    dbuf_at[blockIdx.x][slot] = dbuf_clock_ns();
  }
}

// The barrier of the C blocks of bin group g (all of them resident: the
// launch is cooperative). Every block's writes before it are visible to
// every block after it (the fences around thread 0's arrival). A wait of
// over a second traps instead of hanging the card.
__device__ inline void group_barrier(int g, int C) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = dbuf_generation + g;
    const unsigned seen = *gen;
    __threadfence();
    if (atomicAdd(dbuf_arrivals + g, 1u) == (unsigned)C - 1) {
      atomicExch(dbuf_arrivals + g, 0u);
      __threadfence();
      atomicAdd(dbuf_generation + g, 1u);
    } else {
      const unsigned long long t0 = dbuf_clock_ns();
      while (*gen == seen)
        if (dbuf_clock_ns() - t0 > 1000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The start of a bin in row 7b's kernel: layer 0's input slice (columns
// [c0, c0 + 64) of h_in's rows bin_off..) into hs [E][kHLd] and the bin's
// index arrays, every load in flight first; then A's bit rows into adj (read
// after the product's barriers). Row 7's kernel keeps the same lines inline:
// called there, ptxas spilled 120 bytes in its E <= 128 instantiation (32
// inline), and row 7 took 0.087 ms against 0.069 (PERF.md §6).
__device__ inline void dbuf_stage_bin(const float* __restrict__ h_in, const int* __restrict__ src,
                                      const int* __restrict__ dst, const uint8_t* __restrict__ emask,
                                      float* hs, uint32_t* adj, int* src_s, int* dst_s, int* ok_s,
                                      size_t bin_off, int E, int d, int c0, int mean) {
  const int tid = threadIdx.x, words = adj_words(E);
  {
    constexpr int kPer = kMaxEdges * kVecs / kDbufThreads;
    float4 v[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * kDbufThreads;
      if (i < E * kVecs)
        v[t] = reinterpret_cast<const float4*>(h_in + (bin_off + i / kVecs) * d + c0)[i % kVecs];
    }
    for (int e = tid; e < 32 * words; e += kDbufThreads) {
      const bool in = e < E;
      src_s[e] = in ? src[bin_off + e] : -1;
      dst_s[e] = in ? dst[bin_off + e] : -1;
      ok_s[e] = in && emask[bin_off + e] != 0;
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * kDbufThreads;
      if (i < E * kVecs)
        reinterpret_cast<float4*>(hs + (size_t)(i / kVecs) * kHLd)[i % kVecs] = v[t];
    }
  }
  __syncthreads();
  for (int i = tid; i < E * words; i += kDbufThreads) {
    const int e = i / words;
    adj[i] = match_word(dst_s, ok_s, E, i % words, src_s[e], mean ? -1 : e ^ 1);
  }
}

// Row 7, exact f32. Grid G * C blocks, C = d / 64, all resident at once (a
// cooperative launch): block j is slice r = j % C (columns [64 r, 64 r + 64))
// of bin group g = j / C, which takes bins g, g + G, ... in turn. For each
// bin the block keeps its slice of h and of each layer's mW in shared memory
// and runs every layer: mW[:, slice] = relu(h) @ W[:, slice] over the bin's E
// rows (threads below kDbufCompute computing TM x 4 outputs each, one fmaf
// chain over ascending k an output as in row 1's product, on a 16-deep k-slab
// of relu(h) and of W, while the other threads load the next slab and store
// it to the other stage), then the operator pass over its own columns by
// every thread (h_out = (h +) bias + A @ mW, row 1's walk over the bit rows),
// which writes h in place and, for the other slices' next product, to device
// memory (out where layers - 1 - l is even, else scratch, so that the last
// layer writes out); then the group's barrier. Layer 0 reads h_in, later
// layers the other slices through L2 (ld.global.cg: written in this launch).
template <int TM>
__global__ void __launch_bounds__(kDbufThreads, kDbufMinBlocks)
    dense_mpnn_dbuf_kernel(const float* __restrict__ h_in, float* out, float* scratch,
                           const int* __restrict__ src, const int* __restrict__ dst,
                           const uint8_t* __restrict__ emask, const float* __restrict__ W,
                           const float* __restrict__ bias, int B, int E, int d, int layers,
                           int residual, int mean) {
  constexpr int kLdA = dbuf_rows<TM>() + 4;
  constexpr int kSlabA = kBK * kLdA, kSlabB = kBK * kLdB;
  constexpr int kLoaders = kDbufThreads - kDbufCompute;
  constexpr int kGroupsA = kBK * dbuf_rows<TM>() / 4 / kLoaders;  // a loader's relu(h) groups
  static_assert(kGroupsA * 4 * kLoaders == kBK * dbuf_rows<TM>() && kDbufGroupsB == kLoaders,
                "slab shape");
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* hs = reinterpret_cast<float*>(smem4);        // [E][kHLd]
  float* mw = hs + (size_t)E * kHLd;                  // [E][kCols]
  float* S = mw + (size_t)E * kCols;                  // 2 x ([kBK][kLdA], [kBK][kLdB])
  uint32_t* adj = reinterpret_cast<uint32_t*>(S + 2 * (kSlabA + kSlabB));  // [E][words]
  int* src_s = reinterpret_cast<int*>(adj + (size_t)E * words);           // [32 words] x 3
  int* dst_s = src_s + 32 * words;
  int* ok_s = dst_s + 32 * words;

  const int tid = threadIdx.x, C = d / kCols;
  const int g = blockIdx.x / C, G = gridDim.x / C;
  const int c0 = blockIdx.x % C * kCols;
  const int ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);

  for (int b = g; b < B; b += G) {
    const size_t bin_off = (size_t)b * E;
    dbuf_stamp(b == g, 0);
    {  // layer 0's input slice and the bin's index arrays, every load in flight first
      constexpr int kPer = kMaxEdges * kVecs / kDbufThreads;
      float4 v[kPer];
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int i = tid + t * kDbufThreads;
        if (i < E * kVecs)
          v[t] = reinterpret_cast<const float4*>(h_in + (bin_off + i / kVecs) * d + c0)[i % kVecs];
      }
      for (int e = tid; e < 32 * words; e += kDbufThreads) {
        const bool in = e < E;
        src_s[e] = in ? src[bin_off + e] : -1;
        dst_s[e] = in ? dst[bin_off + e] : -1;
        ok_s[e] = in && emask[bin_off + e] != 0;
      }
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int i = tid + t * kDbufThreads;
        if (i < E * kVecs)
          reinterpret_cast<float4*>(hs + (size_t)(i / kVecs) * kHLd)[i % kVecs] = v[t];
      }
    }
    __syncthreads();
    for (int i = tid; i < E * words; i += kDbufThreads) {
      const int e = i / words;
      adj[i] = match_word(dst_s, ok_s, E, i % words, src_s[e], mean ? -1 : e ^ 1);
    }
    // (the bit rows are read after the product's barriers)
    dbuf_stamp(b == g, 1, true);

    for (int l = 0; l < layers; ++l) {
      // the layer's input, all columns: what layer l - 1 wrote
      const float* x = l == 0 ? h_in : (layers - l) % 2 == 0 ? out : scratch;
      const float* Wl = W + (size_t)l * d * d;
      float acc[TM][kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
      float4 ra[kGroupsA], rb;
      const int li = tid - kDbufCompute;  // a loader's index
      auto load = [&](int k0) {  // a loader's share of the slabs at k0, into registers
#pragma unroll
        for (int t = 0; t < kGroupsA; ++t) {  // relu(h) rows along k
          const int q = li + t * kLoaders;
          const int m = q / (kBK / 4), k = k0 + q % (kBK / 4) * 4;
          ra[t] = m < E ? __ldcg(reinterpret_cast<const float4*>(x + (bin_off + m) * d + k))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        // W rows k0.. along this block's columns
        rb = *reinterpret_cast<const float4*>(Wl + (size_t)(k0 + li / (kBN / 4)) * d + c0 +
                                              li % (kBN / 4) * 4);
      };
      auto store = [&](float* stage) {
#pragma unroll
        for (int t = 0; t < kGroupsA; ++t) {
          const int q = li + t * kLoaders;
          float* s = stage + q % (kBK / 4) * 4 * kLdA + q / (kBK / 4);
          s[0] = relu(ra[t].x);
          s[kLdA] = relu(ra[t].y);
          s[2 * kLdA] = relu(ra[t].z);
          s[3 * kLdA] = relu(ra[t].w);
        }
        float* bs = stage + kSlabA;
        *reinterpret_cast<float4*>(bs + li / (kBN / 4) * kLdB + li % (kBN / 4) * 4) = rb;
      };
      const bool computes = tid < kDbufCompute;
      if (!computes) {
        load(0);
        store(S);
      }
      __syncthreads();
      int s = 0;
      for (int k = 0; k < d; k += kBK) {
        if (computes) {
          const float* stage = S + s * (kSlabA + kSlabB);
          gemm_compute<TM, kLdA>(stage, stage + kSlabA, acc);
        } else if (k + kBK < d) {
          load(k + kBK);
          store(S + (s ^ 1) * (kSlabA + kSlabB));
        }
        __syncthreads();
        s ^= 1;
      }
      if (computes)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = ty * TM + i;
          if (r < E)
            *reinterpret_cast<float4*>(mw + (size_t)r * kCols + tx * kTN) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      __syncthreads();  // this block's mW slice is in place
      dbuf_stamp(b == g, 2 + 3 * l);

      float* y = (layers - 1 - l) % 2 == 0 ? out : scratch;
      const int c = tid % kCols;
      const float bc = bias[(size_t)l * d + c0 + c];
      for (int e = tid / kCols; e < E; e += kDbufThreads / kCols) {
        const uint32_t* row = adj + (size_t)e * words;
        int deg;
        float sum = walk_row(row, words, deg, [&](int e2) { return mw[e2 * kCols + c]; });
        if (mean) sum = sum / fmaxf((float)deg, 1.f) - mw[(e ^ 1) * kCols + c];
        const float o = bc + sum;
        const float hv = residual ? hs[e * kHLd + c] + o : o;
        hs[e * kHLd + c] = hv;
        y[(bin_off + e) * d + c0 + c] = hv;
      }
      dbuf_stamp(b == g, 3 + 3 * l, true);
      if (l + 1 < layers) group_barrier(g, C);  // every slice of the new h is in place
      dbuf_stamp(b == g, 4 + 3 * l);
    }
    __syncthreads();  // the pass is done with this bin's shared memory
  }
}

// Row e's sums of the operator at a column pair, x(e2) giving lane e2's pair
// of mW as floats, each column's in its one-column order: sum, walk_row's (the
// set bits in ascending e2); mean, mean_row_bf16's (its bf16 coefficients, then
// the unkept rev term). So each column has the bits of those walks, with one
// walk of the bits for two columns.
template <typename X>
__device__ inline float2 walk_pair(const uint32_t* row, int words, int e, int mean, const X& x) {
  uint32_t wb[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) wb[w] = w < words ? row[w] : 0u;
  float k = 1.f, k_rev = 1.f;
  const int rev = e ^ 1;
  if (mean) {
    int deg = 0;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) deg += __popc(wb[w]);
    const float inv = 1.f / fmaxf((float)deg, 1.f);
    k = operand<true>(inv);
    k_rev = operand<true>(inv - 1.f);
  }
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    uint32_t bits = wb[w];
    while (bits) {
      const int e2 = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1u;
      const float2 v = x(e2);
      if (mean) {
        const float kk = e2 == rev ? k_rev : k;
        s.x += kk * v.x;
        s.y += kk * v.y;
      } else {
        s.x += v.x;
        s.y += v.y;
      }
    }
  }
  if (mean && !(row[rev >> 5] >> (rev & 31) & 1u)) {
    const float2 v = x(rev);
    s.x -= v.x;
    s.y -= v.y;
  }
  return s;
}

// Row 7b (matmul_dtype="bfloat16"): row 7's launch, groups, slices and
// barrier, with row 1b's product and roundings. Each layer's product
// mW[:, slice] = relu(h) @ W[:, slice] runs on the tensor cores over all the
// block's threads (DbufMma, mma::tile_products: the bin's rows, the block's
// 64 columns, k16 steps in ascending k from a zero accumulator, as row 1b's
// tiles sum every output), rounded to bf16 into shared memory. Its A operand
// is bf16(relu(h)): layer 0's staged from h_in (f32, the ReLU taken, then
// rounded: row 1b's RowsF32), later layers' copied by cp.async from the
// exchange the group's blocks wrote in the pass before (two bf16 [B, E, d]
// halves of scratch in turn: layer l's pass writes half l % 2, so a block
// that runs ahead never overwrites what another still reads); W's slab is
// rounded as staged (ColsF32). The operator pass has row 1b's sums and
// roundings (mW in bf16, the mean's bf16 coefficients, in walk_row's and
// mean_row_bf16's orders), h stays f32 in shared memory for the residual, and only the last layer writes f32 to out; the others write
// bf16(relu(h)) for the next product (the ReLU taken before the rounding, as
// row 1b stages it: a tiny negative gives +0, not -0). In the pass a warp
// takes a row and a lane a column pair (walk_pair: one walk of the bits for
// two outputs).
template <int TM>
__global__ void __launch_bounds__(kDbufThreads, kDbufMinBlocks)
    dense_mpnn_dbuf_mma_kernel(const float* __restrict__ h_in, float* __restrict__ out,
                               __nv_bfloat16* xch, const int* __restrict__ src,
                               const int* __restrict__ dst, const uint8_t* __restrict__ emask,
                               const float* __restrict__ W, const float* __restrict__ bias, int B,
                               int E, int d, int layers, int residual, int mean) {
  using S = DbufMma<TM>;
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* hs = reinterpret_cast<float*>(smem4);                                        // [E][kHLd]
  __nv_bfloat16* slabs = reinterpret_cast<__nv_bfloat16*>(hs + (size_t)E * kHLd);   // S::kSmemHalfs
  __nv_bfloat16* mw = slabs + S::kSmemHalfs;                                          // [E][kMwLd]
  uint32_t* adj = reinterpret_cast<uint32_t*>(mw + (size_t)E * kMwLd);               // [E][words]
  int* src_s = reinterpret_cast<int*>(adj + (size_t)E * words);                      // [32 words] x 3
  int* dst_s = src_s + 32 * words;
  int* ok_s = dst_s + 32 * words;

  const int tid = threadIdx.x, C = d / kCols;
  const int g = blockIdx.x / C, G = gridDim.x / C;
  const int c0 = blockIdx.x % C * kCols;
  const size_t xch_len = (size_t)B * E * d;  // bf16 values of an exchange half

  for (int b = g; b < B; b += G) {
    const size_t bin_off = (size_t)b * E;
    dbuf_stamp(b == g, 0);
    dbuf_stage_bin(h_in, src, dst, emask, hs, adj, src_s, dst_s, ok_s, bin_off, E, d, c0, mean);
    dbuf_stamp(b == g, 1, true);

    for (int l = 0; l < layers; ++l) {
      mma::ColsF32<S, kCols, S::kLdB, false> lw{W + (size_t)l * d * d, d, c0, d};
      typename S::Tile acc;
      if (l == 0) {
        mma::RowsF32<S, true> lx{h_in + bin_off * d, d, 0, E};
        mma::tile_products<S>(0, d, slabs, lx, lw, acc);
      } else {
        mma::RowsBf16<S> lx{xch + (l - 1) % 2 * xch_len + bin_off * d, d, 0, E};
        mma::tile_products<S>(0, d, slabs, lx, lw, acc);
      }
      const int r0 = S::row0(), cc = S::col0();
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + i * 16 + 8 * hf;
          if (r >= E) continue;
#pragma unroll
          for (int j = 0; j < S::kNT; ++j)
            *reinterpret_cast<unsigned*>(mw + (size_t)r * kMwLd + cc + j * 8) =
                mma::pack_bf16x2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
        }
      __syncthreads();  // this block's mW slice is in place
      dbuf_stamp(b == g, 2 + 3 * l);

      const bool last = l + 1 == layers;
      __nv_bfloat16* xo = xch + l % 2 * xch_len;
      const int c = 2 * (tid % (kCols / 2));  // a warp a row, a lane a column pair
      const float bc0 = bias[(size_t)l * d + c0 + c], bc1 = bias[(size_t)l * d + c0 + c + 1];
      for (int e = tid / (kCols / 2); e < E; e += kDbufThreads / (kCols / 2)) {
        const float2 sum = walk_pair(adj + (size_t)e * words, words, e, mean, [&](int e2) {
          return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mw + e2 * kMwLd + c));
        });
        float2 hv = make_float2(bc0 + sum.x, bc1 + sum.y);
        float2* h = reinterpret_cast<float2*>(hs + e * kHLd + c);
        if (residual) hv = make_float2(h->x + hv.x, h->y + hv.y);
        *h = hv;
        const size_t at = (bin_off + e) * d + c0 + c;
        if (last) *reinterpret_cast<float2*>(out + at) = hv;
        else *reinterpret_cast<unsigned*>(xo + at) = mma::pack_bf16x2(relu(hv.x), relu(hv.y));
      }
      dbuf_stamp(b == g, 3 + 3 * l, true);
      if (!last) group_barrier(g, C);  // every slice of the exchange is in place
      dbuf_stamp(b == g, 4 + 3 * l);
    }
    __syncthreads();  // the pass is done with this bin's shared memory
  }
}

// (one instantiation, and so one opt-in record, per kernel)
template <int TM, bool kBf16>
cudaError_t dbuf_config(const void* kernel, int B, int E, int d, cudaLaunchConfig_t& config,
                        cudaLaunchAttribute& coop) {
  static uint64_t smem_configured = 0;
  cudaError_t err = allow_smem(kernel, (int)dbuf_smem_bytes<TM, kBf16>(kMaxEdges), smem_configured);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDbufThreads,
                                                        dbuf_smem_bytes<TM, kBf16>(E));
  if (err != cudaSuccess) return err;
  const int C = d / kCols, resident = sms * per_sm / C;
  int groups = B < resident ? B : resident;
  if (groups > kMaxGroups) groups = kMaxGroups;
  if (groups < 1) return cudaErrorCooperativeLaunchTooLarge;
  config = {};
  config.gridDim = dim3(groups * C);
  config.blockDim = dim3(kDbufThreads);
  config.dynamicSmemBytes = dbuf_smem_bytes<TM, kBf16>(E);
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  config.attrs = &coop;
  config.numAttrs = 1;
  return cudaSuccess;
}

// The bin groups row 7's launch runs at once at this shape (through
// `groups`): min(B, the blocks the card holds at once / (d / 64)).
template <int TM>
cudaError_t dbuf_groups(int B, int E, int d, int* groups) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute coop;
  const cudaError_t err =
      dbuf_config<TM, false>((const void*)dense_mpnn_dbuf_kernel<TM>, B, E, d, config, coop);
  *groups = err == cudaSuccess ? (int)config.gridDim.x / (d / kCols) : 0;
  return err;
}

// Row 7 (kBf16 false) or 7b; scratch is row 7's every other layer's output,
// or row 7b's two bf16 exchange halves.
template <int TM, bool kBf16>
cudaError_t launch_dbuf(const float* h_in, float* out, float* scratch, const int* src,
                        const int* dst, const uint8_t* emask, const float* W, const float* bias,
                        int B, int E, int d, int layers, int residual, int mean,
                        cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute coop;
  cudaError_t err;
  if constexpr (kBf16) {
    err = dbuf_config<TM, true>((const void*)dense_mpnn_dbuf_mma_kernel<TM>, B, E, d, config, coop);
    config.stream = stream;
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&config, dense_mpnn_dbuf_mma_kernel<TM>, h_in, out,
                               reinterpret_cast<__nv_bfloat16*>(scratch), src, dst, emask, W, bias, B, E,
                               d, layers, residual, mean);
  } else {
    err = dbuf_config<TM, false>((const void*)dense_mpnn_dbuf_kernel<TM>, B, E, d, config, coop);
    config.stream = stream;
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&config, dense_mpnn_dbuf_kernel<TM>, h_in, out, scratch, src, dst, emask, W,
                               bias, B, E, d, layers, residual, mean);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool bad_shape(int B, int E, int d) {
  return B <= 0 || E <= 0 || E % 2 != 0 || E > kMaxEdges || d <= 0 || d % kCols != 0;
}

// One layer's product and operator pass (the scatter too when `scatter`);
// mw is f32, or bf16 with kBf16.
template <bool kBf16>
cudaError_t launch_layer(const float* x, const float* W, void* mw, float* h_out,
                         __nv_bfloat16* hs_out, float* nh, const uint32_t* adj,
                         const uint32_t* node_bits, const float* bias, int B, int E, int V, int d,
                         int residual, int mean, bool scatter, cudaStream_t s) {
  const int R = B * E;
  cudaError_t err;
  if constexpr (kBf16) {
    auto* mwb = static_cast<__nv_bfloat16*>(mw);
    err = d % MmaWide::kN == 0 ? launch_gemm_mma<MmaWide>(x, W, mwb, R, d, s)
                               : launch_gemm_mma<MmaNarrow>(x, W, mwb, R, d, s);
  } else {
    mpnn_fwd_gemm_kernel<<<(R + kGemmRows - 1) / kGemmRows * (d / kBN), kGemmThreads, 0, s>>>(
        x, W, static_cast<float*>(mw), R, d);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return scatter ? launch_apply<true, kBf16>(mw, x, h_out, hs_out, nh, adj, node_bits, bias, B, E, V,
                                             d, residual, mean, s)
                 : launch_apply<false, kBf16>(mw, x, h_out, hs_out, nullptr, adj, nullptr, bias, B,
                                              E, V, d, residual, mean, s);
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
// With stash non-null (a host array of `layers` pointers, null or a bf16
// [B,E,d] array each, 8-byte aligned) layer l also writes its output rounded
// to bf16 into stash[l]. With bf16 != 0 every operand of the products, the
// operator and the encoder's ends is rounded to bf16 where the TPU kernel
// rounds it (matmul_dtype="bfloat16"; the products on the tensor cores);
// sums stay f32.
// h_in, outs[l] [B,E,d]; src/dst[B,E] int32, emask[B,E] bytes. With gather
// != 0, h_in is ef[B,E,d] and layer 0's input is nf[src] + ef, nf[B,V,d];
// with scatter != 0 the last layer also writes nh[B,V,d] (see the top of the
// file). Scratch: adj[B,E,ceil(E/32)] and, with scatter, node_bits[B,V,
// ceil(E/32)] (uint32); with gather, h0[B,E,d]; mw[B,E,d] (f32, or bf16 with
// bf16 != 0). All pointers but outs are device pointers of contiguous arrays;
// h_in, every outs[l], W, nf, h0 and mw start 16-byte aligned. The stream is
// a cudaStream_t. Returns the cudaError_t of the launches (0 on success).
int dense_mpnn_forward(const float* h_in, float* const* outs, __nv_bfloat16* const* stash,
                       const float* nf, float* nh, const int* src, const int* dst,
                       const uint8_t* emask, const float* W, const float* bias, uint32_t* adj,
                       uint32_t* node_bits, float* h0, void* mw, int B, int V, int E, int d,
                       int layers, int residual, int mean, int gather, int scatter, int bf16,
                       void* stream) {
  if (bad_shape(B, E, d) || layers <= 0 || !outs) return (int)cudaErrorInvalidValue;
  if ((gather || scatter) && (V <= 0 || V > kMaxNodes || (gather && (!nf || !h0)) ||
                              (scatter && (!nh || !node_bits))))
    return (int)cudaErrorInvalidValue;
  uintptr_t addr = (uintptr_t)h_in | (uintptr_t)W | (uintptr_t)nf | (uintptr_t)h0 | (uintptr_t)mw;
  for (int l = 0; l < layers; ++l) addr |= (uintptr_t)outs[l];
  if (addr % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (stash)
    for (int l = 0; l < layers; ++l)
      if ((uintptr_t)stash[l] % 8 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  auto prep = bf16 ? mpnn_fwd_prep_kernel<true> : mpnn_fwd_prep_kernel<false>;
  prep<<<dim3(B, kPrepSplit), kThreads, 0, s>>>(h_in, nf, gather ? h0 : nullptr, src, dst, emask,
                                                adj, scatter ? node_bits : nullptr, E, V, d, mean);
  cudaError_t err = cudaGetLastError();
  const float* x = gather ? h0 : h_in;
  for (int l = 0; l < layers && err == cudaSuccess; ++l) {
    const bool last = scatter && l == layers - 1;
    __nv_bfloat16* hs_out = stash ? stash[l] : nullptr;
    const float* b = bias + (size_t)l * d;
    err = bf16 ? launch_layer<true>(x, W + (size_t)l * d * d, mw, outs[l], hs_out, nh, adj,
                                    node_bits, b, B, E, V, d, residual, mean, last, s)
               : launch_layer<false>(x, W + (size_t)l * d * d, mw, outs[l], hs_out, nh, adj,
                                     node_bits, b, B, E, V, d, residual, mean, last, s);
    x = outs[l];
  }
  return (int)err;
}

// Row 7's whole forward in one launch: layers 0 .. layers - 1 from h_in[B,E,d]
// into out[B,E,d], W[l] = W + l * d * d ([in, out], row-major), bias[l] =
// bias + l * d; src/dst[B,E] int32, emask[B,E] bytes; scratch[B,E,d] holds
// every other layer's output (layers >= 2; else unused). d / 64 <= 16; h_in,
// out, scratch and W start 16-byte aligned. The stream is a cudaStream_t.
// Calls on one device run one at a time (they share the bin groups'
// barriers). bf16 nonzero runs row 7b (matmul_dtype="bfloat16"), whose
// scratch holds two bf16 [B,E,d] halves, each hidden layer's bf16(relu(h))
// in turn. Returns the cudaError_t of the launch (0 on success).
int dense_mpnn_dbuf_forward(const float* h_in, float* out, float* scratch, const int* src,
                            const int* dst, const uint8_t* emask, const float* W,
                            const float* bias, int B, int E, int d, int layers, int residual,
                            int mean, int bf16, void* stream) {
  if (bad_shape(B, E, d) || d / kCols > kDbufMaxSlices || E > dbuf_rows<16>() || layers <= 0 ||
      (layers > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)h_in | (uintptr_t)out | (uintptr_t)scratch | (uintptr_t)W) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = E <= dbuf_rows<8>() ? (bf16 ? launch_dbuf<8, true> : launch_dbuf<8, false>)
                                           : (bf16 ? launch_dbuf<16, true> : launch_dbuf<16, false>);
  return (int)launch(h_in, out, scratch, src, dst, emask, W, bias, B, E, d, layers, residual, mean, s);
}

// Row 7's widest width in 64-column slices (d <= 64 * this).
int dense_mpnn_dbuf_max_slices() { return kDbufMaxSlices; }

// Row 7's bin groups at once for B bins of E lanes at width d (each d / 64
// blocks; fewer groups than bins means a group takes several bins in turn),
// or -1 on an error. The timing script prints it.
int dense_mpnn_dbuf_groups(int B, int E, int d) {
  if (bad_shape(B, E, d) || d / kCols > kDbufMaxSlices) return -1;
  int groups = 0;
  const cudaError_t err = E <= dbuf_rows<8>() ? dbuf_groups<8>(B, E, d, &groups)
                                              : dbuf_groups<16>(B, E, d, &groups);
  return err == cudaSuccess ? groups : -1;
}

// The stage stamps of rows 7 and 7b in a build with kDbufStages = 1 (see
// dbuf_stamp): `built` is kDbufStages; `reset` zeroes them; `read` copies
// kStampSlots values (ns, 0 where a block wrote none) of each of the first
// `blocks` blocks into out, after the launches so far. Each returns 0 or a
// cudaError_t.
int dense_mpnn_dbuf_stages_built() { return kDbufStages; }

int dense_mpnn_dbuf_stamp_slots() { return kStampSlots; }

int dense_mpnn_dbuf_stamps_reset() {
  void* at = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&at, dbuf_at);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(dbuf_at));
  return (int)err;
}

int dense_mpnn_dbuf_stamps_read(unsigned long long* out, int blocks) {
  if (blocks < 0 || blocks > kStampBlocks) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, dbuf_at, sizeof(unsigned long long) * kStampSlots * blocks);
  return (int)err;
}

const char* dense_mpnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
