// The reverse sweep of the folded dense D-MPNN block, in CUDA C++ for
// sm_90a, with the ends of the whole-encoder backward folded into the
// sweep's first and last layer.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_mpnn.py:
//   - fused_dense_mpnn_block_bwd_stash / _bwd_kernel_stash (the training
//     backward that reads the stashed layer inputs) and the reverse sweep of
//     fused_dense_mpnn_block_bwd / _bwd_kernel (the recompute backward, whose
//     replay of the forward runs the layer kernel of dense_mpnn.cu);
//   - fused_dense_encoder_bwd / _encoder_bwd_kernel(_d1): the same sweep with
//     the scatter's VJP in front of the last layer's products and h0's
//     recompute and the gather's VJP after layer 0's.
// The Python wrapper (notorch_tpu_torch/kernels/dense_mpnn.py) calls
// dense_mpnn_bwd_prep once a call, then dense_mpnn_bwd_layer once per layer,
// last layer first.
//
// The forward layer is h_out = (h_in +) bias + A @ (relu(h_in) @ W), with A
// the folded edge operator of dense_mpnn.cu (per bin, rev(e) = e ^ 1):
//   sum:  A[e,e'] = keep[e,e'] && e' != rev(e)
//   mean: A[e,e'] = keep[e,e'] / max(indeg(e), 1) - [e' == rev(e)]
//   keep[e,e'] = src[e] == dst[e'] && emask[e'],  indeg(e) = sum_e' keep[e,e']
// Given g, the cotangent of h_out, and m = relu(h_in), one layer of the
// sweep computes, over the R = B * E rows of every bin and lane,
//   g_mW   = A^T g,  g_b = sum_rows g        (bwd_adjoint_kernel)
//   g_in   = [h_in > 0] * (g_mW @ W^T) (+ g when residual)
//   g_W    = m^T g_mW                        (both in bwd_gemm_kernel)
// A^T g is exact for any g; that g is zero on padded lanes (the masked
// scatter drops them) is what makes it the gradient of the unfolded block
// too, as in the TPU kernel.
//
// The encoder (h0 = nf[src] + ef; nh = masked scatter of the last output)
// adds, per bin:
//   prologue (the last layer's adjoint): the cotangent of the block's output
//     is g = ge + S^T gn, g[e] = ge[e] + emask[e] * gn[dst[e]] (times
//     1 / max(indeg(dst[e]), 1) for mean: the forward scatter's operator);
//     the kernel stages it for A^T g and writes it for the layer's products;
//   recompute (layer 0's adjoint): h0 = nf[src] + ef into scratch, which the
//     layer's products read, as the TPU kernel recomputes h0 rather than
//     stash it;
//   epilogue (bwd_node_grad_kernel, after layer 0): g_ef = g_h0, and g_nf[v]
//     = sum_e [src[e] == v] * g_h0[e] (unmasked), summed in ascending edge
//     order.
// A src or dst outside [0, V) touches no node, as a one-hot would.
//
// What bounds it: the work is exact f32, so the floor is the CUDA-core f32
// rate (67 TFLOP/s on an H100 SXM at 700 W). A layer needs 4 * R * d^2
// operations for the two W-sized products and 2 * nnz(A) * d for A^T g (the
// encoder's ends add about 3 * R * d); the bytes (h0 or nf and ef, the stash,
// W, the cotangents read once; the gradients written once) take about a
// fifth as long at the training shape. So it is bound by operations, nearly
// all of them in the two products. The design (kernel names carry the
// stage, bwd_):
//   - bwd_prep_kernel, once a call: the bit rows of A^T of every bin (and
//     the mean's 1 / max(indeg, 1), the scatter's scales, the gather's node
//     bit rows), which every layer and column slice reads, and a row-major
//     copy of each layer's W^T, so that each product reads row-major
//     operands only;
//   - bwd_adjoint_kernel on a (bin, 64-column) grid of 1,024-thread blocks:
//     the block stages its bin's g slice in shared memory and walks the set
//     bits of A^T's rows, so the operator costs operations only where it is
//     nonzero; it also sums g over the bin's rows for g_b's per-bin partial.
//     A walk is a chain of dependent shared-memory loads, so a block has
//     many threads, each with few rows (at 256 threads the adjoint and the
//     gather's VJP took twice as long);
//   - bwd_gemm_kernel, one grid of jobs: relu(h_in)^T g_mW split over fixed
//     chunks of kChunkRows rows (M = N = d, K = R), then g_mW W^T over all R
//     rows (M = R, N = K = d) with the ReLU mask and the residual in the
//     epilogue. Each job is a 64 x 64 tile of 128 threads, 8 x 4 outputs a
//     thread, k-slabs of 16 of both operands staged in shared memory in two
//     stages (the pattern of gvp_conv.cu's products). A chunk of 256 rows
//     makes every job as long as an input-gradient job (K = d at d = 256):
//     chunks of 1,024 rows left the long jobs to finish alone, 0.36 ms for
//     row 6 against 0.29 (H100, 700 W). Exact f32 FMA, no TF32.
//   - The chunks of g_W are added in ascending chunk order, and g_b's bins in
//     ascending bin order, by the last block to finish each 64 x 64 tile of
//     g_W (an integer arrival count, zeroed by the layer's adjoint): the
//     order of every sum is fixed, not the order of arrival, so two calls on
//     the same inputs give the same bits. No float atomics: the only atomics
//     are the integer arrival counts and in-degrees.
//
// matmul_dtype="bfloat16" is the kBf16 instantiation of the adjoint and the
// gather's VJP, and bwd_gemm_mma_kernel for the products: the operands the
// TPU kernel casts with .astype(bfloat16) are rounded to bf16 where they are
// read or staged (g into A^T g; A^T's mean coefficients; relu(h_in) and g_mW
// into g_W; g_mW and W into g_in; gn and the mean's scatter scale in the
// prologue; nf in h0's recompute; g_h0 into the gather's VJP), and the sums
// stay f32. The adjoint and the gather's VJP keep the orders above. The
// products' operands are then bf16, so they multiply on the tensor cores
// (bf16_mma.cuh: mma.sync m16n8k16, f32 accumulate), in the f32 kernel's
// jobs, chunks and epilogues (64 x 64 tiles). At the tensor cores' bf16 rate
// the products take a fraction of the time their operands take to arrive, so
// the jobs are bound by their operands' bytes through L2 (their k-slabs of
// 32 staged two at a time, f32 rounded to bf16 as staged, the stash copied
// as it is). The epilogue's loads are all in flight before its stores; a
// g_W chunk is kMmaChunkRows rows, and the last block of a g_W tile keeps
// kSumAhead chunks' loads in flight: the chunk sum is the sweep's tail.
// The sum of each output runs in the tensor cores' order, not by ascending k,
// so it differs from the f32 FMA chain by f32 roundings; the chunks of g_W
// are still added in ascending chunk order, and two calls give the same bits.
// stash_dtype="bfloat16" is the kHalfIn instantiation of the products: the
// layer input is read from the bf16 stash, for the ReLU mask and for g_W's
// operand alike (with matmul_dtype, its k-slabs copied as they are by
// cp.async and the ReLU taken on the fragments).
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "bf16_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kCols = 64;         // output columns per adjoint block; the g_W tile
constexpr int kThreads = 256;     // the prep blocks
constexpr int kSliceThreads = 1024;  // the adjoint and node-gradient blocks
constexpr int kMaxEdges = 256;    // edge lanes per bin this kernel takes
constexpr int kMaxNodes = 256;    // node slots per bin the encoder's ends take
constexpr int kChunkRows = 256;   // rows of the R-row sum per weight-gradient partial
// the bf16 products' (bwd_gemm_mma_kernel): rows of a weight-gradient chunk (a
// multiple of kChunkRows, so that the scratch sized by it suffices), and the
// chunks whose loads a thread has in flight at once in the sum of the chunks
constexpr int kMmaChunkRows = 512;
constexpr int kSumAhead = 4;
static_assert(kMmaChunkRows % kChunkRows == 0, "the scratch holds kChunkRows chunks");
constexpr int kTT = 32;           // the side of a transposed tile of W
constexpr int kMaxWords = kMaxEdges / 32;  // of a bit row

// ---- once a call: A^T's bit rows, the scales, W^T --------------------------

// Blocks [0, B): bin b's bit rows of A^T (row e' has bit e set where A[e, e']
// has a keep entry: emask[e'] && src[e] == dst[e'], and, for sum, e !=
// rev(e')), into adj[b, e', words]; for mean inv[b, e] = 1 / max(indeg(e),
// 1); for the encoder scat[b, e], the scale of the scatter's VJP on edge e
// (0 for a masked edge or a dst outside [0, V)), and the gather's node bit
// rows node_bits[b, v, words]. Blocks from B on: a kTT x kTT tile of one
// layer's W into wt = W^T ([depth, out, in]).
__global__ void __launch_bounds__(kThreads)
bwd_prep_kernel(const float* __restrict__ W, float* __restrict__ wt, const int* __restrict__ src,
                const int* __restrict__ dst, const uint8_t* __restrict__ emask,
                uint32_t* __restrict__ adj, float* __restrict__ inv, float* __restrict__ scat,
                uint32_t* __restrict__ node_bits, int B, int E, int V, int d, int mean) {
  __shared__ int src_s[kMaxEdges], dst_s[kMaxEdges], ok_s[kMaxEdges], cnt[kMaxNodes];
  __shared__ float tile[kTT][kTT + 1];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= B) {
    const int t = d / kTT;
    const int j = blockIdx.x - B, l = j / (t * t), tr = j % (t * t) / t, tc = j % t;
    const float* w = W + (size_t)l * d * d;
    float* o = wt + (size_t)l * d * d;
    const int x = tid % kTT;
    for (int y = tid / kTT; y < kTT; y += kThreads / kTT)
      tile[y][x] = w[(size_t)(tr * kTT + y) * d + tc * kTT + x];
    __syncthreads();
    for (int y = tid / kTT; y < kTT; y += kThreads / kTT)
      o[(size_t)(tc * kTT + y) * d + tr * kTT + x] = tile[x][y];
    return;
  }
  const int b = blockIdx.x;
  const size_t bin_off = (size_t)b * E;
  const int words = adj_words(E);
  for (int e = tid; e < E; e += kThreads) {
    src_s[e] = src[bin_off + e];
    dst_s[e] = dst[bin_off + e];
    ok_s[e] = emask[bin_off + e] != 0;
  }
  if (scat && mean)
    for (int v = tid; v < V; v += kThreads) cnt[v] = 0;
  __syncthreads();
  if (scat && mean) {
    for (int e = tid; e < E; e += kThreads) {
      const int v = dst_s[e];
      if (ok_s[e] && v >= 0 && v < V) atomicAdd(&cnt[v], 1);
    }
    __syncthreads();
  }
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
    adj[bin_off * words + i] = bits;
  }
  if (node_bits) {  // bit e of node row v: src[e] == v (unmasked, as the gather reads)
    for (int i = tid; i < V * words; i += kThreads) {
      const int v = i / words;
      const int base = (i % words) * 32;
      uint32_t bits = 0u;
      for (int t = 0; t < 32; ++t) {
        const int e = base + t;
        if (e < E && src_s[e] == v) bits |= 1u << t;
      }
      node_bits[(size_t)b * V * words + i] = bits;
    }
  }
  for (int e = tid; e < E; e += kThreads) {
    if (mean) {
      const int se = src_s[e];
      int deg = 0;
      for (int e2 = 0; e2 < E; ++e2) deg += ok_s[e2] && dst_s[e2] == se;
      inv[bin_off + e] = 1.f / fmaxf((float)deg, 1.f);
    }
    if (scat) {
      const int v = dst_s[e];
      const bool live = ok_s[e] && v >= 0 && v < V;
      scat[bin_off + e] = !live ? 0.f : mean ? 1.f / fmaxf((float)cnt[v], 1.f) : 1.f;
    }
  }
}

// ---- per layer: g_mW = A^T g and g_b's per-bin partial ----------------------

__host__ inline size_t adjoint_smem_bytes(int E) {
  return sizeof(float) * ((size_t)E * kCols + E)          // g slice, 1 / max(indeg, 1)
         + sizeof(uint32_t) * (size_t)E * adj_words(E);   // bit rows of A^T
}

constexpr int kVecs = kCols / 4;                           // 16-byte vectors of a slice row
constexpr int kSliceVecs = kMaxEdges * kVecs / kSliceThreads;  // of a bin's slice, a thread at most

// The 16-byte vectors (e, q) of a bin's slice (rows e < E, vectors q <
// kVecs of 64 columns): store(e, q, load(e, q)) for each, every thread's
// loads in flight before it stores the first.
template <typename Load, typename Store>
__device__ inline void copy_slice(int E, const Load& load, const Store& store) {
  float4 v[kSliceVecs];
#pragma unroll
  for (int t = 0; t < kSliceVecs; ++t) {
    const int i = threadIdx.x + t * kSliceThreads;
    if (i < E * kVecs) v[t] = load(i / kVecs, i % kVecs);
  }
#pragma unroll
  for (int t = 0; t < kSliceVecs; ++t) {
    const int i = threadIdx.x + t * kSliceThreads;
    if (i < E * kVecs) store(i / kVecs, i % kVecs, v[t]);
  }
}

// ... into gs[E][kCols]
template <typename Load>
__device__ inline void stage_slice(float* gs, int E, const Load& load) {
  copy_slice(E, load, [&](int e, int q, float4 v) { reinterpret_cast<float4*>(gs + (size_t)e * kCols)[q] = v; });
}

// The sum over the set bits e of a bit row of `words` words, in ascending e,
// of term(e); the row's words are loaded together.
template <typename Term>
__device__ inline float walk_bits(const uint32_t* row, int words, const Term& term) {
  uint32_t wb[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) wb[w] = w < words ? row[w] : 0u;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    uint32_t bits = wb[w];
    while (bits) {
      const int e = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1u;
      s += term(e);
    }
  }
  return s;
}

// Grid (bin, 64-column slice of d), kSliceThreads a block. With kPrologue the layer's cotangent is
// g = ge + scat * gn[dst], staged and written to g_full. Mean scales each
// term by 1 / max(indeg(e), 1) and subtracts g[rev(e')], the rev diagonal
// of A, on every row. gb_part[b, c] = sum over the bin's rows of g[., c].
// With h0 non-null (layer 0 of the encoder) the block also writes its slice
// of the layer's input, h0 = nf[src] + ef, recomputed for the products.
// Block (0, 0) zeroes the layer's products' arrival counts. With kBf16 the
// operands the TPU kernel rounds to bf16 are rounded where they are read: g
// into A^T g (g itself, for g_b and the residual, stays f32), A^T's mean
// coefficients (bf16(1 / indeg(e)), and bf16(1 / indeg(e) - 1) on a kept
// rev lane, else -1), gn and the mean's scatter scale in the prologue, and nf
// in h0's recompute.
template <bool kPrologue, bool kBf16>
__global__ void __launch_bounds__(kSliceThreads)
bwd_adjoint_kernel(const float* __restrict__ g, const float* __restrict__ ge,
                   const float* __restrict__ gn, const float* __restrict__ scat,
                   const int* __restrict__ dst, float* __restrict__ g_full,
                   float* __restrict__ g_mw, float* __restrict__ gb_part,
                   const uint32_t* __restrict__ adj_g, const float* __restrict__ inv_g,
                   const float* __restrict__ ef, const float* __restrict__ nf,
                   const int* __restrict__ src, float* __restrict__ h0, int* __restrict__ counts,
                   int n_counts, int E, int V, int d, int mean) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kSliceThreads / kCols][kCols];
  const int words = adj_words(E);
  float* gs = reinterpret_cast<float*>(smem4);                // [E][kCols]
  float* inv = gs + (size_t)E * kCols;                        // [E]
  uint32_t* adj = reinterpret_cast<uint32_t*>(inv + E);       // [E][words]

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;
  if (b == 0 && blockIdx.y == 0)
    for (int i = tid; i < n_counts; i += kSliceThreads) counts[i] = 0;

#pragma unroll
  for (int t = 0; t < kMaxEdges * kMaxWords / kSliceThreads; ++t) {
    const int i = tid + t * kSliceThreads;
    if (i < E * words) adj[i] = adj_g[bin_off * words + i];
  }
  if (mean)
    for (int e = tid; e < E; e += kSliceThreads) inv[e] = inv_g[bin_off + e];
  if constexpr (kPrologue) {
    stage_slice(gs, E, [&](int e, int q) {
      const size_t off = (bin_off + e) * d + c0;
      float4 v = reinterpret_cast<const float4*>(ge + off)[q];
      const float sc = operand<kBf16>(scat[bin_off + e]);
      if (sc != 0.f) {
        float4 n = operand4<kBf16>(
            reinterpret_cast<const float4*>(gn + ((size_t)b * V + dst[bin_off + e]) * d + c0)[q]);
        if (mean) n = make_float4(n.x * sc, n.y * sc, n.z * sc, n.w * sc);
        v = add4(v, n);
      }
      return v;
    });
  } else {
    stage_slice(gs, E, [&](int e, int q) {
      return reinterpret_cast<const float4*>(g + (bin_off + e) * d + c0)[q];
    });
  }
  if (h0)
    copy_slice(
        E, [&](int e, int q) { return input_vec<true, kBf16>(ef, nf, src, bin_off + e, b, V, d, c0, q); },
        [&](int e, int q, float4 v) { reinterpret_cast<float4*>(h0 + (bin_off + e) * d + c0)[q] = v; });
  __syncthreads();
  if constexpr (kPrologue) {
    for (int i = tid; i < E * kVecs; i += kSliceThreads)
      reinterpret_cast<float4*>(g_full + (bin_off + i / kVecs) * d + c0)[i % kVecs] =
          reinterpret_cast<const float4*>(gs + (size_t)(i / kVecs) * kCols)[i % kVecs];
  }

  const int c = tid % kCols, phase = tid / kCols;
  constexpr int kPhases = kSliceThreads / kCols;
  float sum = 0.f;  // g_b: rows phase, phase + kPhases, ... then the phases in order
  for (int e2 = phase; e2 < E; e2 += kPhases) {
    const uint32_t* row = adj + (size_t)e2 * words;
    const auto x = [&](int e) { return operand<kBf16>(gs[e * kCols + c]); };
    float s;
    if (kBf16 && mean) {
      const int rev = e2 ^ 1;
      s = walk_bits(row, words, [&](int e) {
        return operand<true>(e == rev ? inv[e] - 1.f : inv[e]) * x(e);
      });
      if (!(row[rev >> 5] >> (rev & 31) & 1u)) s -= x(rev);
    } else {
      s = walk_bits(row, words, [&](int e) { return mean ? x(e) * inv[e] : x(e); });
      if (mean) s -= x(e2 ^ 1);
    }
    g_mw[(bin_off + e2) * d + c0 + c] = s;
    sum += gs[e2 * kCols + c];
  }
  red[phase][c] = sum;
  __syncthreads();
  if (tid < kCols) {
    float t = red[0][tid];
#pragma unroll
    for (int p = 1; p < kPhases; ++p) t += red[p][tid];
    gb_part[(size_t)b * d + c0 + tid] = t;
  }
}

// ---- per layer: the two W-sized products ------------------------------------

// A 64 x 64 tile of C = A B over k in [k0, k1): 128 threads, thread (ty, tx)
// owns rows 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx + 3. Both operands'
// k-slabs land k-major in shared memory ([kBK][kLd]); each thread loads its
// share of the next slab into registers while the block computes on this
// one, then stores it, one barrier a slab. Each output's sum runs over k in
// ascending order by fmaf.
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 8, kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);
constexpr int kLd = kBM + 4;
constexpr int kSlab = kBK * kLd;  // floats of one operand's slab
constexpr int kGroups = kBM * kBK / 4 / kGemmThreads;  // 16-byte groups a thread loads of each
static_assert(kBM == kBN && kBN == kCols && kGroups == 2, "tile shape");

// The operands of the two products; the A loaders fill As[k][m], the B
// loader Bs[k][n], one 16-byte group g < kBM * kBK / 4 at a time.
struct Operands {
  const float* g_mw;  // [R, d]
  const float* wt;    // [d, d] W^T, row-major: [out, in]
  const void* h_in;   // [R, d] the layer input: float, or bf16 (a bf16 stash) with kHalfIn
  int R, d;
};

// 4 values of the layer input from element i (i % 4 == 0), as floats.
template <bool kHalfIn>
__device__ inline float4 load_input4(const void* h_in, size_t i) {
  if constexpr (kHalfIn) return load_bf16x4(static_cast<const __nv_bfloat16*>(h_in), i);
  return *reinterpret_cast<const float4*>(static_cast<const float*>(h_in) + i);
}

// g_mW W^T: A = g_mW rows m0.. along k, stored transposed
__device__ inline float4 load_a_rows(const Operands& o, int m0, int k0, int g) {
  const int m = m0 + g / (kBK / 4), k = k0 + g % (kBK / 4) * 4;
  return m < o.R ? *reinterpret_cast<const float4*>(o.g_mw + (size_t)m * o.d + k)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ inline void store_a_rows(float* As, int g, float4 x) {
  float* s = As + g % (kBK / 4) * 4 * kLd + g / (kBK / 4);
  s[0] = x.x;
  s[kLd] = x.y;
  s[2 * kLd] = x.z;
  s[3 * kLd] = x.w;
}
// relu(h_in)^T g_mW: A = relu(layer input) rows k0.. (the sum's rows) along m
template <bool kHalfIn>
__device__ inline float4 load_a_cols(const Operands& o, int m0, int k0, int k1, int g) {
  const int r = k0 + g / (kBM / 4), m = m0 + g % (kBM / 4) * 4;
  if (r >= k1) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 v = load_input4<kHalfIn>(o.h_in, (size_t)r * o.d + m);
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}
// B: rows k0.. of a row-major [rows, d] operand along n (W^T, or g_mW)
__device__ inline float4 load_b(const float* p, int d, int n0, int k0, int k1, int g) {
  const int k = k0 + g / (kBN / 4), n = n0 + g % (kBN / 4) * 4;
  return k < k1 ? *reinterpret_cast<const float4*>(p + (size_t)k * d + n) : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ inline void store_k_major(float* S, int g, float4 x) {
  *reinterpret_cast<float4*>(S + g / (kBM / 4) * kLd + g % (kBM / 4) * 4) = x;
}

__device__ inline void tile_compute(const float* As, const float* Bs, float (&acc)[kTM][kTN]) {
  const int ty = threadIdx.x / (kBN / kTN), tx = threadIdx.x % (kBN / kTN);
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * kLd + tx * kTN);
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kLd + ty * kTM);
    const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kLd + ty * kTM + 4);
    const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The k-loop of one tile, kInput: g_mW W^T (k over d), else relu(h)^T g_mW
// (k over the rows [k0, k1)). S holds two stages of both slabs.
template <bool kInput, bool kHalfIn>
__device__ inline void tile_run(const Operands& o, int m0, int n0, int k0, int k1, float* S,
                                float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float4 ra[kGroups], rb[kGroups];
  auto load = [&](int k) {
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      const int g = threadIdx.x + t * kGemmThreads;
      if constexpr (kInput) {
        ra[t] = load_a_rows(o, m0, k, g);
        rb[t] = load_b(o.wt, o.d, n0, k, k1, g);
      } else {
        ra[t] = load_a_cols<kHalfIn>(o, m0, k, k1, g);
        rb[t] = load_b(o.g_mw, o.d, n0, k, k1, g);
      }
    }
  };
  auto store = [&](float* stage) {
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      const int g = threadIdx.x + t * kGemmThreads;
      if constexpr (kInput)
        store_a_rows(stage, g, ra[t]);
      else
        store_k_major(stage, g, ra[t]);
      store_k_major(stage + kSlab, g, rb[t]);
    }
  };
  load(k0);
  store(S);
  __syncthreads();
  int s = 0;
  for (int k = k0; k < k1; k += kBK) {
    const bool more = k + kBK < k1;
    if (more) load(k + kBK);
    tile_compute(S + s * 2 * kSlab, S + s * 2 * kSlab + kSlab, acc);
    if (more) store(S + (s ^ 1) * 2 * kSlab);
    __syncthreads();
    s ^= 1;
  }
}

struct GemmArgs {
  Operands o;
  const float* g;        // [R, d] the layer's cotangent (residual)
  float* g_in;           // [R, d]
  float* gw_part;        // [chunks, d, d]
  const float* gb_part;  // [B, d]
  float* gw;             // [d, d]
  float* gb;             // [d]
  int* counts;           // [(d / kBN)^2] arrival counts, zero at launch
  int B, chunks, w_jobs, residual;
};

// The end of a weight-gradient job, after its chunk's partial is written:
// the last of the tile's chunks to arrive adds the partials in ascending
// chunk order into g_W (and, for the first row of tiles, g_b's per-bin
// partials in ascending bin order into g_b). 128 threads; `last` is a
// __shared__ int of the caller.
__device__ inline void add_chunks(const GemmArgs& a, int tile, int m0, int n0, int& last) {
  const int d = a.o.d;
  const int ty = threadIdx.x / (kBN / kTN), tx = threadIdx.x % (kBN / kTN);
  // the partial is visible to every block before this one's arrival counts
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&a.counts[tile], 1) == a.chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (a.chunks > 1) {  // a chunk's loads of the thread's rows in flight together
    const float* own = a.gw_part + (size_t)(m0 + ty * kTM) * d + n0 + tx * kTN;
    float4 s[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) s[i] = __ldcg(reinterpret_cast<const float4*>(own + (size_t)i * d));
    for (int c = 1; c < a.chunks; ++c)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        s[i] = add4(s[i], __ldcg(reinterpret_cast<const float4*>(own + ((size_t)c * d + i) * d)));
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      *reinterpret_cast<float4*>(a.gw + (size_t)(m0 + ty * kTM + i) * d + n0 + tx * kTN) = s[i];
  }
  if (m0 == 0 && threadIdx.x < kBN) {
    const int j = n0 + threadIdx.x;
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < a.B; ++b) s += a.gb_part[(size_t)b * d + j];
    a.gb[j] = s;
  }
}

// One grid of jobs: blocks [0, w_jobs) the weight gradient's (tile t =
// job / chunks, chunk job % chunks), then the input gradient's 64 x 64
// tiles, row tile by row tile. A weight-gradient block writes its chunk's
// partial, then add_chunks. Exact f32 FMA; kHalfIn: the layer input is the
// bf16 stash.
template <bool kHalfIn>
__global__ void __launch_bounds__(kGemmThreads, 3) bwd_gemm_kernel(const __grid_constant__ GemmArgs a) {
  __shared__ __align__(16) float S[4 * kSlab];
  __shared__ int last;
  const Operands& o = a.o;
  const int d = o.d, tn = d / kBN;
  const int ty = threadIdx.x / (kBN / kTN), tx = threadIdx.x % (kBN / kTN);
  float acc[kTM][kTN];

  if ((int)blockIdx.x >= a.w_jobs) {
    const int job = blockIdx.x - a.w_jobs;
    const int m0 = job / tn * kBM, n0 = job % tn * kBN;
    tile_run<true, kHalfIn>(o, m0, n0, 0, d, S, acc);
    const int n = n0 + tx * kTN;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = m0 + ty * kTM + i;
      if (r >= o.R) break;
      const size_t off = (size_t)r * d + n;
      const float4 h = load_input4<kHalfIn>(o.h_in, off);
      float4 v = make_float4(acc[i][0] * (h.x > 0.f ? 1.f : 0.f), acc[i][1] * (h.y > 0.f ? 1.f : 0.f),
                             acc[i][2] * (h.z > 0.f ? 1.f : 0.f), acc[i][3] * (h.w > 0.f ? 1.f : 0.f));
      if (a.residual) v = add4(v, *reinterpret_cast<const float4*>(a.g + off));
      *reinterpret_cast<float4*>(a.g_in + off) = v;
    }
    return;
  }

  const int tile = blockIdx.x / a.chunks, chunk = blockIdx.x % a.chunks;
  const int m0 = tile / tn * kBM, n0 = tile % tn * kBN;
  const int r0 = chunk * kChunkRows, r1 = min(o.R, r0 + kChunkRows);
  tile_run<false, kHalfIn>(o, m0, n0, r0, r1, S, acc);
  float* part = a.chunks == 1 ? a.gw : a.gw_part + (size_t)chunk * d * d;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    *reinterpret_cast<float4*>(part + (size_t)(m0 + ty * kTM + i) * d + n0 + tx * kTN) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  add_chunks(a, tile, m0, n0, last);
}

// ---- the two products with matmul_dtype="bfloat16" (rows 3b, 4b, 6b) ------

// The tile of the bf16 products: 64 x 64 of 4 warps (the f32 kernel's jobs),
// k-slabs of 32; the operands (bf16_mma.cuh): g_mW's rows (A of g_mW W^T),
// W^T's and g_mW's k-rows (B), relu(h_in)'s k-rows (A of g_W: f32, or the
// bf16 stash).
using MmaTile = mma::Shape<kBM, kBN, 2, 2, 32>;
using GmwRows = mma::RowsF32<MmaTile>;
using ColsB = mma::ColsF32<MmaTile, kBN, MmaTile::kLdB, false>;
using ReluCols = mma::ColsF32<MmaTile, kBM, MmaTile::kLdA, true>;
using StashCols = mma::ColsBf16<MmaTile>;

// 1 builds the job stamps of the bf16 products (the timing script's --stages
// build): thread 0 of each of the first kStampJobs blocks of a launch writes
// %globaltimer at its start, with its products summed, with its output (or
// chunk partial) written, and at its end (after the chunk sum in the last
// block of a g_W tile).
constexpr int kStages = 0;
constexpr int kStampJobs = kStages != 0 ? 4096 : 1, kJobStamps = 4;
__device__ unsigned long long job_at[kStampJobs][kJobStamps];

__device__ inline void job_stamp(int slot) {
  if constexpr (kStages != 0) {
    if (threadIdx.x != 0 || blockIdx.x >= kStampJobs) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    job_at[blockIdx.x][slot] = t;
  }
}

// 2 values of the layer input from element i (i even), as floats.
template <bool kHalfIn>
__device__ inline float2 load_input2(const void* h_in, size_t i) {
  if constexpr (kHalfIn)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(h_in) + i));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(h_in) + i);
}

// add_chunks for a tile of S: the last of the tile's chunks to arrive adds
// the partials in ascending chunk order into g_W, each thread's float4s of
// the tile in groups of 4, with kSumAhead chunks' loads in flight at once;
// and, for the first row of tiles, g_b's per-bin partials in ascending bin
// order into g_b.
template <typename S>
__device__ inline void sum_chunks(const GemmArgs& a, int tile, int m0, int n0, int& last) {
  constexpr int kVecs = S::kM * S::kN / 4 / S::kThreads, kGroup = 4, kQ = S::kN / 4;
  static_assert(kVecs % kGroup == 0, "whole groups");
  const int d = a.o.d;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&a.counts[tile], 1) == a.chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (a.chunks > 1) {
    for (int g0 = 0; g0 < kVecs; g0 += kGroup) {
      size_t at[kGroup];
      float4 s[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int v = threadIdx.x + (g0 + u) * S::kThreads;
        at[u] = (size_t)(m0 + v / kQ) * d + n0 + v % kQ * 4;
        s[u] = __ldcg(reinterpret_cast<const float4*>(a.gw_part + at[u]));
      }
      for (int c0 = 1; c0 < a.chunks; c0 += kSumAhead) {
        float4 x[kSumAhead][kGroup];
#pragma unroll
        for (int c = 0; c < kSumAhead; ++c)
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            if (c0 + c < a.chunks)
              x[c][u] = __ldcg(reinterpret_cast<const float4*>(a.gw_part + (size_t)(c0 + c) * d * d + at[u]));
#pragma unroll
        for (int c = 0; c < kSumAhead; ++c)
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            if (c0 + c < a.chunks) s[u] = add4(s[u], x[c][u]);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) *reinterpret_cast<float4*>(a.gw + at[u]) = s[u];
    }
  }
  if (m0 == 0)
    for (int j = threadIdx.x; j < S::kN; j += S::kThreads) {
      float s = 0.f;
#pragma unroll 8
      for (int b = 0; b < a.B; ++b) s += a.gb_part[(size_t)b * d + n0 + j];
      a.gb[n0 + j] = s;
    }
}

// bwd_gemm_kernel's jobs (on tiles of S), epilogues and chunk sums with both
// products on the tensor cores (bf16_mma.cuh), their operands rounded to
// bf16 as staged.
template <typename S, bool kHalfIn>
__global__ void __launch_bounds__(S::kThreads, 4) bwd_gemm_mma_kernel(const __grid_constant__ GemmArgs a) {
  __shared__ __align__(16) __nv_bfloat16 smem[S::kSmemHalfs];
  __shared__ int last;
  const Operands& o = a.o;
  const int d = o.d, tn = d / S::kN;
  const int row0 = S::row0(), col0 = S::col0();
  typename S::Tile acc;
  job_stamp(0);

  if ((int)blockIdx.x >= a.w_jobs) {
    const int job = blockIdx.x - a.w_jobs;
    const int m0 = job / tn * S::kM, n0 = job % tn * S::kN;
    GmwRows la{o.g_mw, d, m0, o.R};
    ColsB lb{o.wt, d, n0, d};
    mma::tile_products<S>(0, d, smem, la, lb, acc);
    job_stamp(1);
    // an m16 tile's mask and residual values all in flight before its stores
#pragma unroll
    for (int i = 0; i < S::kMT; ++i) {
      float2 x[2][S::kNT], g[2][S::kNT];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + row0 + i * 16 + 8 * h;
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
          const size_t off = (size_t)r * d + n0 + col0 + j * 8;
          x[h][j] = r < o.R ? load_input2<kHalfIn>(o.h_in, off) : make_float2(0.f, 0.f);
          g[h][j] = r < o.R && a.residual ? *reinterpret_cast<const float2*>(a.g + off) : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + row0 + i * 16 + 8 * h;
        if (r >= o.R) continue;
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
          float2 v = make_float2(acc[i][j][2 * h] * (x[h][j].x > 0.f ? 1.f : 0.f),
                                 acc[i][j][2 * h + 1] * (x[h][j].y > 0.f ? 1.f : 0.f));
          if (a.residual) v = make_float2(v.x + g[h][j].x, v.y + g[h][j].y);
          *reinterpret_cast<float2*>(a.g_in + (size_t)r * d + n0 + col0 + j * 8) = v;
        }
      }
    }
    job_stamp(2);
    job_stamp(3);
    return;
  }

  const int tile = blockIdx.x / a.chunks, chunk = blockIdx.x % a.chunks;
  const int m0 = tile / tn * S::kM, n0 = tile % tn * S::kN;
  const int r0 = chunk * kMmaChunkRows, r1 = min(o.R, r0 + kMmaChunkRows);
  ColsB lb{o.g_mw, d, n0, r1};
  if constexpr (kHalfIn) {
    StashCols la{static_cast<const __nv_bfloat16*>(o.h_in), d, m0, r1};
    mma::tile_products<S>(r0, r1, smem, la, lb, acc);
  } else {
    ReluCols la{static_cast<const float*>(o.h_in), d, m0, r1};
    mma::tile_products<S>(r0, r1, smem, la, lb, acc);
  }
  job_stamp(1);
  float* part = a.chunks == 1 ? a.gw : a.gw_part + (size_t)chunk * d * d;
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
        *reinterpret_cast<float2*>(part + (size_t)(m0 + row0 + i * 16 + 8 * h) * d + n0 + col0 + j * 8) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  job_stamp(2);
  sum_chunks<S>(a, tile, m0, n0, last);
  job_stamp(3);
}

// The layer's two products on tiles of S: weight-gradient jobs first, then
// the input gradient's.
template <typename S, bool kHalfIn>
cudaError_t launch_mma(GemmArgs a, cudaStream_t s) {
  const int tn = a.o.d / S::kN;
  a.w_jobs = tn * tn * a.chunks;
  bwd_gemm_mma_kernel<S, kHalfIn><<<a.w_jobs + (a.o.R + S::kM - 1) / S::kM * tn, S::kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// ---- after layer 0 of the encoder: the gather's VJP -------------------------

__host__ inline size_t node_grad_smem_bytes(int E, int V) {
  return sizeof(float) * (size_t)E * kCols                   // the g_h0 slice
         + sizeof(uint32_t) * (size_t)V * adj_words(E);      // node bit rows
}

// Grid (bin, 64-column slice): g_nf[b, v, c] = sum over node v's set bits
// (src[e] == v, unmasked, as the gather reads) of g_h0[b, e, c], ascending e;
// with kBf16 each g_h0 rounded to bf16 as it is staged.
template <bool kBf16>
__global__ void __launch_bounds__(kSliceThreads)
bwd_node_grad_kernel(const float* __restrict__ g_h0, const uint32_t* __restrict__ node_bits_g,
                     float* __restrict__ g_nf, int E, int V, int d) {
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* outs = reinterpret_cast<float*>(smem4);                                // [E][kCols]
  uint32_t* node_bits = reinterpret_cast<uint32_t*>(outs + (size_t)E * kCols);  // [V][words]
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;
#pragma unroll
  for (int t = 0; t < kMaxNodes * kMaxWords / kSliceThreads; ++t) {
    const int i = tid + t * kSliceThreads;
    if (i < V * words) node_bits[i] = node_bits_g[(size_t)b * V * words + i];
  }
  stage_slice(outs, E, [&](int e, int q) {
    return operand4<kBf16>(reinterpret_cast<const float4*>(g_h0 + (bin_off + e) * d + c0)[q]);
  });
  __syncthreads();
  const int c = tid % kCols;
  for (int v = tid / kCols; v < V; v += kSliceThreads / kCols)
    g_nf[((size_t)b * V + v) * d + c0 + c] =
        walk_bits(node_bits + (size_t)v * words, words, [&](int e) { return outs[e * kCols + c]; });
}

// The layer's pointers, as dense_mpnn_bwd_layer takes them.
struct LayerArgs {
  const void* h_in;  // float, or bf16 (the stash)
  const float* g;
  float *g_in, *g_mw, *gw_part, *gb_part;
  int* counts;
  float *gw, *gb;
  const int *src, *dst;
  const float* wt;
  const uint32_t *adj, *node_bits;
  const float *inv, *scat, *nf, *ge, *gn;
  float *g_full, *h0, *g_nf;
};

template <bool kPrologue, bool kBf16>
cudaError_t launch_adjoint(const LayerArgs& p, bool gather, int B, int E, int V, int d, int mean,
                           cudaStream_t s) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)bwd_adjoint_kernel<kPrologue, kBf16>,
                               (int)adjoint_smem_bytes(kMaxEdges), configured);
  if (err != cudaSuccess) return err;
  const int tn = d / kCols;
  // the encoder's layer 0 reads h_in as ef (f32: layer 0's input is never stashed)
  bwd_adjoint_kernel<kPrologue, kBf16><<<dim3(B, tn), kSliceThreads, adjoint_smem_bytes(E), s>>>(
      p.g, p.ge, p.gn, p.scat, p.dst, p.g_full, p.g_mw, p.gb_part, p.adj, p.inv,
      static_cast<const float*>(p.h_in), p.nf, p.src, gather ? p.h0 : nullptr, p.counts, tn * tn, E, V,
      d, mean);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_node_grad(const float* g_h0, const uint32_t* node_bits, float* g_nf, int B, int E,
                             int V, int d, cudaStream_t s) {
  static uint64_t configured = 0;
  cudaError_t err = allow_smem((const void*)bwd_node_grad_kernel<kBf16>,
                               (int)node_grad_smem_bytes(kMaxEdges, kMaxNodes), configured);
  if (err != cudaSuccess) return err;
  bwd_node_grad_kernel<kBf16><<<dim3(B, d / kCols), kSliceThreads, node_grad_smem_bytes(E, V), s>>>(
      g_h0, node_bits, g_nf, E, V, d);
  return cudaGetLastError();
}

// The layer's launches: the adjoint, the two products, and the gather's VJP
// after the encoder's layer 0.
template <bool kBf16, bool kHalfIn>
cudaError_t launch_layer(const LayerArgs& p, bool prologue, bool gather, int B, int E, int V, int d,
                         int residual, int mean, cudaStream_t s) {
  cudaError_t err = prologue ? launch_adjoint<true, kBf16>(p, gather, B, E, V, d, mean, s)
                             : launch_adjoint<false, kBf16>(p, gather, B, E, V, d, mean, s);
  if (err != cudaSuccess) return err;
  const int R = B * E;
  const int tn = d / kBN;
  const int chunk_rows = kBf16 ? kMmaChunkRows : kChunkRows;
  const int chunks = (R + chunk_rows - 1) / chunk_rows;
  const GemmArgs a{{p.g_mw, p.wt, gather ? p.h0 : p.h_in, R, d}, p.g, p.g_in, p.gw_part, p.gb_part,
                   p.gw, p.gb, p.counts, B, chunks, tn * tn * chunks, residual};
  if constexpr (kBf16)
    err = launch_mma<MmaTile, kHalfIn>(a, s);
  else {
    bwd_gemm_kernel<kHalfIn><<<a.w_jobs + (R + kBM - 1) / kBM * tn, kGemmThreads, 0, s>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !gather) return err;
  return launch_node_grad<kBf16>(p.g_in, p.node_bits, p.g_nf, B, E, V, d, s);
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= (uintptr_t)p;
  return bits % 16 != 0;
}

}  // namespace

extern "C" {

int dense_mpnn_bwd_max_edges() { return kMaxEdges; }

int dense_mpnn_bwd_max_nodes() { return kMaxNodes; }

int dense_mpnn_bwd_cols() { return kCols; }

int dense_mpnn_bwd_chunk_rows() { return kChunkRows; }

// Once a call, before the layers: adj[B, E, ceil(E / 32)] (uint32) the bit
// rows of A^T, inv[B, E] (read for mean) and, with scat non-null (the
// encoder), scat[B, E] the scale of the scatter's VJP and node_bits[B, V,
// ceil(E / 32)] (uint32) the gather's node bit rows; wt[depth, d, d] the
// transposes of W[depth, d, d]. src/dst[B, E] int32, emask[B, E] bytes.
// Returns the cudaError_t of the launch (0 on success).
int dense_mpnn_bwd_prep(const float* W, float* wt, const int* src, const int* dst,
                        const uint8_t* emask, uint32_t* adj, float* inv, float* scat,
                        uint32_t* node_bits, int B, int V, int E, int d, int depth, int mean,
                        void* stream) {
  if (B <= 0 || E <= 0 || E % 2 != 0 || E > kMaxEdges || d <= 0 || d % kCols != 0 || depth <= 0)
    return (int)cudaErrorInvalidValue;
  if (scat && (V <= 0 || V > kMaxNodes || !node_bits)) return (int)cudaErrorInvalidValue;
  const int t = d / kTT;
  bwd_prep_kernel<<<B + depth * t * t, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      W, wt, src, dst, emask, adj, inv, scat, scat ? node_bits : nullptr, B, E, V, d, mean);
  return (int)cudaGetLastError();
}

// One layer of the reverse sweep. Inputs: h_in[B,E,d] (the layer's input),
// g[B,E,d] (cotangent of its output), src/dst[B,E] int32, wt[d,d] (this
// layer's W^T from dense_mpnn_bwd_prep) and the prep's adj, inv, scat,
// node_bits. Outputs: g_in[B,E,d] (cotangent of h_in), gw[d,d] and gb[d]
// (this layer's weight and bias gradients, overwritten). Scratch:
// g_mw[B,E,d], gw_part[chunks,d,d] with chunks = ceil(B * E /
// dense_mpnn_bwd_chunk_rows()), gb_part[B,d], counts[(d /
// dense_mpnn_bwd_cols())^2] int32.
// The encoder's ends: with prologue != 0 (its last layer) g is not read:
// the layer's cotangent is ge[B,E,d] + S^T gn (gn[B,V,d]), written to
// g_full[B,E,d]; with gather != 0 (its layer 0) h_in is ef[B,E,d], the
// layer's input nf[src] + ef (nf[B,V,d]) is recomputed into h0[B,E,d]
// (scratch), and the gather's VJP is written to g_nf[B,V,d]. All pointers
// are device pointers of contiguous arrays; every float array but gb starts
// 16-byte aligned, and g_in differs from g. With half_in != 0, h_in is the
// bf16 stash ([B,E,d] bf16, 8-byte aligned, 16 with bf16; never with
// gather). With bf16 !=
// 0 the operands are rounded to bf16 where the TPU kernel rounds them
// (matmul_dtype="bfloat16"; see the kernels). The stream is a cudaStream_t.
// Returns the cudaError_t of the launches (0 on success).
int dense_mpnn_bwd_layer(const void* h_in, const float* g, float* g_in, float* g_mw,
                         float* gw_part, float* gb_part, int* counts, float* gw, float* gb,
                         const int* src, const int* dst, const float* wt, const uint32_t* adj,
                         const uint32_t* node_bits, const float* inv, const float* scat,
                         const float* nf, const float* ge, const float* gn, float* g_full,
                         float* h0, float* g_nf, int B, int V, int E, int d, int residual,
                         int mean, int prologue, int gather, int bf16, int half_in, void* stream) {
  if (B <= 0 || E <= 0 || E % 2 != 0 || E > kMaxEdges || d <= 0 || d % kCols != 0)
    return (int)cudaErrorInvalidValue;
  if ((prologue || gather) && (V <= 0 || V > kMaxNodes)) return (int)cudaErrorInvalidValue;
  if ((prologue && (!ge || !gn || !g_full || !scat)) ||
      (gather && (!nf || !g_nf || !h0 || !node_bits)))
    return (int)cudaErrorInvalidValue;
  if (half_in && gather) return (int)cudaErrorInvalidValue;
  if (prologue) g = g_full;
  if (misaligned({g, g_in, g_mw, gw_part, gb_part, gw, wt, nf, ge, gn, g_nf, h0}) ||
      (uintptr_t)h_in % (half_in && !bf16 ? 8 : 16) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (g_in == g) return (int)cudaErrorInvalidValue;
  const LayerArgs p{h_in, g, g_in, g_mw, gw_part, gb_part, counts, gw, gb, src, dst, wt, adj,
                    node_bits, inv, scat, nf, ge, gn, g_full, h0, g_nf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pro = prologue != 0, gat = gather != 0;
  cudaError_t err;
  if (bf16)
    err = half_in ? launch_layer<true, true>(p, pro, gat, B, E, V, d, residual, mean, s)
                  : launch_layer<true, false>(p, pro, gat, B, E, V, d, residual, mean, s);
  else
    err = half_in ? launch_layer<false, true>(p, pro, gat, B, E, V, d, residual, mean, s)
                  : launch_layer<false, false>(p, pro, gat, B, E, V, d, residual, mean, s);
  return (int)err;
}

// The bf16 products' job stamps of a build with kStages = 1 (see job_stamp):
// `built` is kStages; `reset` zeroes them; `read` copies kJobStamps values
// (ns of %globaltimer) for each of the first `jobs` blocks of the last launch
// (at most kStampJobs). Both return the cudaError_t.
int dense_mpnn_bwd_stages_built() { return kStages; }

int dense_mpnn_bwd_stamps_reset() {
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, job_at);
  return (int)(err != cudaSuccess ? err : cudaMemset(at, 0, sizeof job_at));
}

int dense_mpnn_bwd_stamps_read(unsigned long long* out, int jobs) {
  if (jobs < 0 || jobs > kStampJobs) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, job_at, sizeof(unsigned long long) * kJobStamps * jobs);
}

const char* dense_mpnn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
