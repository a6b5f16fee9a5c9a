// The dense graph-attention core, forward and recompute backward, in CUDA C++
// for sm_90a.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_attention.py:
//   - _attn_kernel / fused_dense_attention_fwd (v1, row 10) and _attn_kernel_v2 /
//     fused_dense_attention_fwd_v2 (row 12), one function with one layout:
//     attn_rows_kernel<false>;
//   - _attn_bwd_kernel / fused_dense_attention_bwd (v1, row 11): the query pass
//     attn_rows_kernel<true>, then the key pass attn_cols_kernel;
//   - _attn_bwd_kernel_v2 / fused_dense_attention_bwd_v2 (row 13): both passes
//     in one launch on thread-block clusters, attn_cluster_kernel.
// All read and write JAX's layouts: q, k, v, out, the cotangent g and g_q,
// g_k, g_v [B, V, H * dh]; eb and g_eb [B, H, E]; src, dst [B, E] int32;
// edge_mask [B, E] bytes (0 = padding).
//
// What they compute, per bin b and head h (M[i, j] = number of live edges
// e with dst e = i and src e = j; a live edge has a nonzero mask and src and
// dst in [0, V)):
//   s[i, j] = q_i . k_j / sqrt(dh) + sum of eb[b, h, e] over those edges,
//             in ascending e (each pair is one lane of the softmax, however
//             many edges it has);
//   alpha[i, :] = softmax of s[i, :] over the j with M[i, j] > 0, the sum
//             floored at 1e-12; a row with none (padding nodes, the padding
//             sink, a bond-less molecule) is all zero, as the TPU kernels'
//             -1e30 mask and the jnp path's -inf mask both give;
//   out_i = sum_j alpha[i, j] v_j.
// The backward recomputes alpha and, with g_alpha[i, j] = g_i . v_j and
// g_s = alpha * (g_alpha - rowsum(alpha * g_alpha)):
//   g_q_i = sum_j g_s[i, j] k_j / sqrt(dh),  g_k_j = sum_i g_s[i, j] q_i / sqrt(dh),
//   g_v_j = sum_i alpha[i, j] g_i,           g_eb[b, h, e] = g_s[dst e, src e]
//   on a live edge and 0 on any other (the gather that the TPU kernel's
//   T = St g_s; sum_j T * G reduces to).
//
// Design: every bin and head in flight at once. The TPU's grids walk tiles of
// bins in order on one core (v1 looping over the heads, v2 a grid step per
// head) and build the one-hot operators and the [V, V] score tile in VMEM for
// the MXU; here the mask is what it is, a sparse set of pairs (a molecule's
// node has a few bonded neighbours: 3,738 live of the 16 x 128 x 128 lanes of
// the packed lipo batch), and blocks run side by side, so no block loops over
// bins or heads and nothing of size V x V exists anywhere. The (row, head)
// slots of a bin are numbered s = i * H + h; a lane group takes a slot: gsz
// lanes of up to two (row 13: four) 16-byte vectors of the head's dh columns
// each (8 lanes at dh = 64; row 13 4), so that a row's scalar work (the walk
// of its pairs, the softmax) is repeated on few lanes. The heads of one row
// sit in neighbouring groups: a neighbour's k or v row is read as one
// contiguous line of H * dh floats. A block of 128 threads first gathers,
// from the bin's src, dst and edge_mask lanes, the live edges whose dst (a
// query pass's list) or src (a key pass's) is one of its rows, in ascending
// edge id (a ballot per warp, the warps' counts added in warp order, the next
// lanes' loads in flight meanwhile), then sorts each list by (its row, the
// other end, edge id) in one step, each entry's place the count of the
// entries before it: a row's pairs are then a contiguous run, found by binary
// search, and a pair's edges follow its first, its leader. That is the index
// of its rows, built once for all their heads, 24 bytes a lane of shared
// memory a list, and no [V, dh] staging. Each group then gathers its pairs'
// head slices through L2, 16 bytes a lane, the reads of up to 4 / (vectors a
// lane) pairs issued together.
//   Forward (rows 10 and 12): a block per (bin, run of 128 / gsz slots); one
//   pass over the row's pairs in ascending src, an online softmax (the sum and
//   the combine rescaled when the running max rises). The bf16 modes (rows
//   10b, 12b) round alpha before it multiplies v_j, so they walk a row twice:
//   the first walk fetches k_j and the leader edge's bias alone, for the
//   row's max and sum, and keeps each pair's score in shared memory; the
//   second fetches v_j alone (its first batch's reads issued with the first
//   walk's) and combines the rounded alpha of each kept score.
//   The query pass of a backward: the same pass also sums, rescaled alike,
//   exp * g_alpha, exp * g_alpha * k_j and exp * k_j, so that
//   g_q_i = (sum exp g_alpha k_j - D_i sum exp k_j) / (sum exp) / sqrt(dh)
//   with D_i = sum_j alpha g_alpha, and keeps each pair's score and g_alpha
//   (at its leader edge) and each slot's max, sum and D_i.
//   The key pass: a group per (key row, head) takes its pairs in ascending
//   query row, forms alpha = exp(score - max) / sum and
//   g_s = alpha g_alpha - alpha D_i from those values, sums alpha g_i into
//   g_v_j and g_s q_i into g_k_j, and writes g_s on each of the pair's edges
//   in g_eb; the lanes that are not live are zeroed by one block of the bin.
//   Row 11 runs the two passes as two launches of blocks per (bin, run of
//   slots), the values between them in device scratch ([B, H, E] twice and
//   [B, H, V] three times). Row 13 runs them in one launch on thread-block
//   clusters, a cluster of C <= 16 blocks per bin: block r owns the query and
//   key rows [r * R, (r + 1) * R), R = ceil(V / C), all their heads, in runs
//   of 128 / gsz slots; it gathers its rows' edges by dst and by src in one
//   pass over the bin's lanes and sorts both lists side by side, runs the
//   query pass over its slots, keeping the values in its own shared memory
//   ([H, E] twice, [R, H] three times), meets the other blocks at a cluster
//   barrier, then runs the key pass, reading each pair's values from the block
//   that owns its query row through distributed shared memory; a second
//   cluster barrier keeps each block's shared memory until the others have
//   read it. The values never leave the SMs and the key pass waits for no
//   second launch.
//   What holds these latency-bound blocks is how many the card holds at once:
//   a launch that takes two waves takes twice as long. So row 13's groups are
//   4 lanes of 4 vectors at dh = 64, capped at 128 registers (the dense lipo
//   batch's 64 clusters of 6 blocks in one wave), and row 12, row 10's kernel,
//   has an instantiation of its own capped at 80 registers (768 blocks in one
//   wave); row 10 keeps its launch.
//   Every output is written once, by one group, in a fixed order, with no
//   float atomics: two calls give the same bits, and row 12 gives row 10's.
// Exact f32 on CUDA cores throughout, no TF32.
//
// What bounds them on this card. Counted at this data's live pairs, the
// products are a few operations per byte moved (4 * dh per pair and head
// forward, 10 * dh backward, against q, k, v, out rows of 4 * dh bytes):
// every body is bound by bytes, each input read once and each output written
// once over 3.35 TB/s (2.5 us forward and 4.4 us backward at the packed lipo
// batch of 16 bins, V = 128, E = 256, H = 4, dh = 64). Counted densely, as
// the TPU's MXU runs them (4 V^2 dh a head forward), they would be bound by
// operations. Each operand row goes from device memory into L2 once (2 MB an
// operand at the packed batch, far under the 50 MB L2) and only the rows a
// pair needs are gathered from there. What is left over the bytes is latency,
// paid once per launch and not per head: the launch, the block's gather (its
// loads and barriers), and a row's batches of pair reads in turn; row 11 pays
// the launch and the gather twice, row 13 once, and two cluster barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDh = 512;             // four 16-byte vectors on each lane of a warp
constexpr int kMaxV = 46340;            // node slots a bin: a list's keys row * V + other fit an int
constexpr int kMaxSmem = 232448;        // the 227 KB a block may use after the opt-in
constexpr int kListThreads = 128;
constexpr int kWarps = kListThreads / 32;
// Blocks a bin's cluster holds at most (row 13): above the portable 8 with the
// non-portable opt-in, where two blocks fit an SM's shared memory.
constexpr int kMaxCluster = 16;
// Blocks an SM must hold (the register cap: 65,536 / 128 / this): row 12's
// forward below four vectors a lane (80 registers: the dense lipo batch's 768
// blocks in one wave), row 13 at four (128 registers: its 64 clusters of 6
// blocks in one wave, where 148 registers held 62 at once).
constexpr int kV2FwdMinBlocks = 6;
constexpr int kClusterMinBlocks4 = 4;
// 1 builds the stage stamps (see stamp); the timing script's --stages build.
constexpr int kStages = 0;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* eb;               // [B, H, E] or null
  const int* src;
  const int* dst;
  const unsigned char* emask;
  const float* g;                // backward: the cotangent of out
  float* out;                    // forward
  float* gq;                     // backward
  float* gk;
  float* gv;
  float* geb;                    // backward with eb, else null
  int B, V, E, H, dh;
  float scale;                   // 1 / sqrt(dh)
  int vecs;                      // 16-byte vectors a lane at most (see list_group_size)
};

// Stage stamps of a kStages build: thread 0 of block 0 writes %globaltimer
// (ns) at each phase boundary of a kernel (stage_at[kernel][stage]), and
// thread 0 of every block takes the earliest start and the latest end over
// the launch (stage_span[kernel]). A forward stamps its start, its gather's
// first step, its sorted list and its end in slots 0-3, and in the bf16
// modes the end of its first and of its second walk in slots 4 and 5.
enum StageKernel { kFwdKernel, kRowsKernel, kColsKernel, kClusterKernel, kStageKernels };
constexpr int kStageSlots = 10;
__device__ unsigned long long stage_at[kStageKernels][kStageSlots];
__device__ unsigned long long stage_span[kStageKernels][2];

__device__ inline unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ inline void stamp(int kernel, int stage, bool start, bool end) {
  if constexpr (kStages != 0) {
    if (threadIdx.x != 0) return;
    const unsigned long long t = globaltimer_ns();
    if (blockIdx.x == 0) stage_at[kernel][stage] = t;
    if (start) atomicMin(&stage_span[kernel][0], t);
    if (end) atomicMax(&stage_span[kernel][1], t);
  }
}

// kStages builds, row 13: the latest of the blocks of bin 0's cluster at
// stage slot `slot` (their start, the end of each pass).
__device__ inline void stamp_cluster0(int slot, int size) {
  if constexpr (kStages != 0) {
    if (threadIdx.x == 0 && (int)blockIdx.x < size)
      atomicMax(&stage_at[kClusterKernel][slot], globaltimer_ns());
  }
}

__device__ inline float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ inline float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ inline float4 fma4(float s, float4 x, float4 acc) {
  return make_float4(fmaf(s, x.x, acc.x), fmaf(s, x.y, acc.y), fmaf(s, x.z, acc.z),
                     fmaf(s, x.w, acc.w));
}

__device__ inline float4 scale4(float s, float4 x) {
  return make_float4(s * x.x, s * x.y, s * x.z, s * x.w);
}

// The numeric modes of every kernel (a template argument, kMode):
//   kExact: f32 in and out, exact f32 (rows 10-13);
//   kMm:    f32 in and out, each operand of a product rounded to bf16 where
//           the TPU kernels' matmul_dtype="bfloat16" rounds it (rows 10b-13b
//           on f32 inputs);
//   kHalf:  bf16 in and out (__nv_bfloat16; the TPU kernels' dt = mm =
//           bfloat16, a bf16 model's path): the operands as kMm, and alpha
//           and g_s rounded to bf16 as dt too.
// In both bf16 modes the softmax, every sum and every product stay f32, and
// the passes round where the TPU kernel rounds, which the online softmax of
// kExact cannot: alpha = exp(s - max) / sum is formed from the row's final
// max and sum (a first pass over the row's pairs), rounded, and only then
// multiplied (a second pass). No pass fetches what it does not multiply: the
// first keeps each pair's score (and in a backward its g_alpha, which the
// key pass reads too), and what follows reads them back. The forward's first
// pass fetches k_j, its second v_j; the backward's first fetches k_j and v_j,
// D_i = sum_j alpha g_alpha is summed from the kept values alone, and the
// g_q pass fetches only k_j.
constexpr int kExact = 0, kMm = 1, kHalf = 2;

// Element `at` (a multiple of 4) of an operand, 4 values, as floats.
template <int kMode>
__device__ inline float4 load4(const float* base, size_t at) {
  if constexpr (kMode == kHalf) return load_bf16x4(reinterpret_cast<const __nv_bfloat16*>(base), at);
  else return __ldg(reinterpret_cast<const float4*>(base + at));
}

template <int kMode>
__device__ inline float load1(const float* base, size_t at) {
  if constexpr (kMode == kHalf) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[at]);
  else return __ldg(base + at);
}

template <int kMode>
__device__ inline void store4(float* base, size_t at, float4 x) {
  if constexpr (kMode == kHalf) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(base) + at) = raw;
  } else {
    *reinterpret_cast<float4*>(base + at) = x;
  }
}

template <int kMode>
__device__ inline void store1(float* base, size_t at, float x) {
  if constexpr (kMode == kHalf) reinterpret_cast<__nv_bfloat16*>(base)[at] = __float2bfloat16_rn(x);
  else base[at] = x;
}

// Edge e's bias (element `at` of eb) as a product's operand.
template <int kMode>
__device__ inline float edge_bias(const Args& a, size_t at) {
  return operand<kMode == kMm>(load1<kMode>(a.eb, at));
}

// The bf16 modes' alpha from a pair's score and its row's max and sum,
// rounded to dt (bf16 in kHalf).
template <int kMode>
__device__ inline float mode_alpha(float sc, float m, float den) {
  return operand<kMode == kHalf>(expf(sc - m) / den);
}

// The bf16 modes' g_s = alpha g_alpha - alpha D_i, each product and the
// difference rounded as the TPU kernel forms them (no fused multiply-add),
// then rounded to bf16 (dt, and the products' operand).
__device__ inline float mode_gs(float af, float ga, float dsum) {
  return operand<true>(__fsub_rn(__fmul_rn(af, ga), __fmul_rn(af, dsum)));
}

// Sum over a group by xor shuffles: every lane ends with the same bits, since
// each step adds the same two values on both lanes of a pair.
__device__ inline float group_sum(float x, unsigned mask, int gsz) {
  for (int off = gsz >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(mask, x, off, gsz);
  return x;
}

struct Group {
  int nq, gsz, lane, index, count;
  unsigned mask;
};

// The group of gsz lanes that owns a row of dh columns (dh / 4 16-byte
// vectors).
__device__ inline Group lane_group(int dh, int gsz) {
  Group g;
  g.nq = dh / 4;
  g.gsz = gsz;
  g.lane = threadIdx.x % g.gsz;
  g.index = threadIdx.x / g.gsz;
  g.count = blockDim.x / g.gsz;
  g.mask = g.gsz == 32 ? 0xffffffffu : ((1u << g.gsz) - 1u) << (threadIdx.x % 32 / g.gsz * g.gsz);
  return g;
}

bool misaligned(const Args& a) {
  const uintptr_t vecs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.g |
                         (uintptr_t)a.out | (uintptr_t)a.gq | (uintptr_t)a.gk | (uintptr_t)a.gv;
  return vecs % 16 != 0;
}

bool bad_head(const Args& a) {
  return a.B < 0 || a.V <= 0 || a.E <= 0 || a.H <= 0 || a.dh <= 0 || a.dh % 4 != 0 || a.dh > kMaxDh;
}

// Blocks an SM must hold at kC vectors a lane: a cap of 128 registers a
// thread (255 at 4 vectors), which keeps the packed lipo batch's 512 blocks
// of either pass in one wave on 132 SMs.
template <int kC>
constexpr int kMinBlocks = kC == 4 ? 2 : 4;

// Shared memory of one list: the bin's live edges whose dst (a query pass's
// list) or src (a key pass's) is one of the block's rows, keyed by that row
// and the other end, key = row * V + other, and sorted by key and edge id:
// a row's pairs are contiguous in ascending other end, and a pair's edges in
// ascending edge id from the first, its leader.
struct List {
  int* key;    // [E] ascending
  int* other;  // [E] the other end: src in a query pass's list, dst in a key pass's
  int* e;      // [E] edge ids
  int* lead;   // [E] 1 on a pair's first entry, else 0
  int* misc;   // [kWarps] the warps' counts of a gather step
  int* gkey;   // [E] the keys in gather order (ascending edge id), until sorted
  int* ge;     // [E] the edge ids in gather order, until sorted
};

// Words of a sorted list, and of its gather order (free once sorted).
__host__ __device__ inline size_t list_words(int E) { return 4 * (size_t)E + kWarps; }

__host__ __device__ inline size_t list_smem_bytes(int E) { return sizeof(int) * (list_words(E) + 2 * (size_t)E); }

// A forward's shared memory: its list and, in the bf16 modes, each pair's
// score for each head ([E, H] floats at most) where the gather order was.
__host__ __device__ inline size_t fwd_smem_bytes(int E, int H, int mode) {
  const size_t kept = mode == kExact ? 0 : (size_t)H * E, gather = 2 * (size_t)E;
  return sizeof(int) * (list_words(E) + (kept > gather ? kept : gather));
}

__device__ inline List carve_list(int* w, int E, int* gather) {
  List l;
  l.key = w;    w += E;
  l.other = w;  w += E;
  l.e = w;      w += E;
  l.lead = w;   w += E;
  l.misc = w;
  l.gkey = gather;
  l.ge = gather + E;
  return l;
}

// Lanes a (row, head) slot spans: its dh / 4 16-byte vectors at up to `vecs`
// a lane, rounded up to a power of two, at most a warp (8 lanes at dh = 64
// and 2 vectors). Fewer lanes a slot repeat a row's scalar work (the walk of
// its pairs, the softmax) on fewer lanes and hold fewer registers a slot.
// The forwards and row 11 take kVecs; row 13 kV2BwdVecs (4 lanes at dh = 64:
// 512 registers a slot where 8 lanes hold 992, so that a bin's slots fit).
constexpr int kVecs = 2;
constexpr int kV2BwdVecs = 4;

__host__ __device__ inline int list_group_size(int dh, int vecs) {
  int g = 1;
  while (g * vecs < dh / 4 && g < 32) g <<= 1;
  return g;
}

__device__ inline Group list_group(const Args& a) { return lane_group(a.dh, list_group_size(a.dh, a.vecs)); }

// (row, head) slots a block takes at once, its blocks per bin (rows 10-12),
// and the 16-byte vectors of a head row each lane holds (1, 2 or 4 at most).
__host__ __device__ inline int slots_per_block(const Args& a) {
  return kListThreads / list_group_size(a.dh, a.vecs);
}

__host__ __device__ inline int chunks_per_bin(const Args& a) {
  const int per = slots_per_block(a);
  return (int)(((long long)a.V * a.H + per - 1) / per);
}

__host__ __device__ inline int vectors_per_lane(const Args& a) {
  const int gsz = list_group_size(a.dh, a.vecs), per = (a.dh / 4 + gsz - 1) / gsz;
  return per == 1 ? 1 : per == 2 ? 2 : 4;
}

// Entry p of a gathered list (n long) to its place in key order, ties in
// gather order (ascending edge id): its rank is the count of entries with a
// smaller key or the same key gathered before it.
__device__ inline void sort_entry(const List& l, int n, int p, int V) {
  const int k = l.gkey[p];
  int less = 0, before = 0;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const int kr = l.gkey[r];
    less += kr < k;
    before += kr == k && r < p;
  }
  const int at = less + before;
  l.key[at] = k;
  l.other[at] = k - k / V * V;
  l.e[at] = l.ge[p];
  l.lead[at] = before == 0;
}

// The live edges of bin b whose dst lies in [lo, hi] (into by_dst, with kDst)
// and those whose src does (into by_src, with kSrc), each list sorted (see
// List), the two sorts side by side. With `zero_dead`, zeroes the bin's g_eb
// on every lane that is not live. Returns the two lists' lengths.
template <bool kDst, bool kSrc, int kMode>
__device__ int2 gather_lists(const Args& a, const List& by_dst, const List& by_src, int b, int lo, int hi,
                             bool zero_dead, int stage_kernel) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t base = (size_t)b * a.E;
  // each step's lanes are read while the step before is placed
  auto read = [&](int e, int& i, int& j, unsigned char& m) {
    if (e < a.E) {
      j = __ldg(a.src + base + e);
      i = __ldg(a.dst + base + e);
      m = __ldg(a.emask + base + e);
    }
  };
  int i = -1, j = -1;
  unsigned char m = 0;
  read(tid, i, j, m);
  int nd = 0, ns = 0;
  for (int e0 = 0; e0 < a.E; e0 += kListThreads) {
    const int e = e0 + tid;
    int i2 = -1, j2 = -1;
    unsigned char m2 = 0;
    read(e + kListThreads, i2, j2, m2);
    const bool live = e < a.E && m != 0 && j >= 0 && j < a.V && i >= 0 && i < a.V;
    if (zero_dead && e < a.E && !live)
      for (int h = 0; h < a.H; ++h) store1<kMode>(a.geb, ((size_t)b * a.H + h) * a.E + e, 0.f);
    const bool hit_d = kDst && live && i >= lo && i <= hi;
    const bool hit_s = kSrc && live && j >= lo && j <= hi;
    unsigned bits_d = 0, bits_s = 0;
    if constexpr (kDst) {
      bits_d = __ballot_sync(0xffffffffu, hit_d);
      if (lane == 0) by_dst.misc[warp] = __popc(bits_d);
    }
    if constexpr (kSrc) {
      bits_s = __ballot_sync(0xffffffffu, hit_s);
      if (lane == 0) by_src.misc[warp] = __popc(bits_s);
    }
    __syncthreads();
    if (e0 == 0) stamp(stage_kernel, 1, false, false);
    int at_d = nd, at_s = ns;
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) {
        at_d = nd;
        at_s = ns;
      }
      if constexpr (kDst) nd += by_dst.misc[w];
      if constexpr (kSrc) ns += by_src.misc[w];
    }
    const unsigned below = (1u << lane) - 1u;
    if (hit_d) {
      const int p = at_d + __popc(bits_d & below);
      by_dst.gkey[p] = i * a.V + j;
      by_dst.ge[p] = e;
    }
    if (hit_s) {
      const int p = at_s + __popc(bits_s & below);
      by_src.gkey[p] = j * a.V + i;
      by_src.ge[p] = e;
    }
    __syncthreads();
    i = i2;
    j = j2;
    m = m2;
  }
  const int total = (kDst ? nd : 0) + (kSrc ? ns : 0);
  for (int p = tid; p < total; p += kListThreads) {
    if (kDst && p < nd) sort_entry(by_dst, nd, p, a.V);
    else sort_entry(by_src, ns, p - (kDst ? nd : 0), a.V);
  }
  __syncthreads();
  return make_int2(nd, ns);
}

template <bool kByDst, int kMode>
__device__ inline int gather_edges(const Args& a, const List& l, int b, int lo, int hi, bool zero_dead,
                                   int stage_kernel) {
  const int2 n = gather_lists<kByDst, !kByDst, kMode>(a, l, l, b, lo, hi, zero_dead, stage_kernel);
  return kByDst ? n.x : n.y;
}

// The first entry of l (n long) whose key is at least k.
__device__ inline int lower_bound(const List& l, int n, int k) {
  int lo = 0;
  while (n > 0) {
    const int half = n / 2;
    if (l.key[lo + half] < k) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The next pair's leader after entry p of a row's run that ends at `end`.
__device__ inline int next_leader(const List& l, int p, int end) {
  while (++p < end && !l.lead[p]) {
  }
  return p;
}

// Offset of head h's slice of row r of bin b in a [B, V, H * dh] operand.
__device__ inline size_t head_row(const Args& a, int b, int r, int h) {
  return ((size_t)b * a.V + r) * a.H * a.dh + (size_t)h * a.dh;
}

// A lane's kC vectors of the head slice at element `row` of an operand (zero
// past the slice), rounded to bf16 in kMm as the products' operands are.
template <int kC, int kMode>
__device__ inline void load_slice(float4 (&x)[kC], const float* base, size_t row, const Group& g) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = g.lane + c * g.gsz;
    x[c] = col < g.nq ? operand4<kMode == kMm>(load4<kMode>(base, row + 4 * (size_t)col)) : zero4();
  }
}

template <int kC, int kMode>
__device__ inline void store_slice(float* base, size_t row, const float4 (&x)[kC], float s, const Group& g) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = g.lane + c * g.gsz;
    if (col < g.nq) store4<kMode>(base, row + 4 * (size_t)col, scale4(s, x[c]));
  }
}

// x . y over the group: every lane ends with the same bits.
template <int kC>
__device__ inline float group_dot(const float4 (&x)[kC], const float4 (&y)[kC], const Group& g) {
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) part += dot4(x[c], y[c]);
  return group_sum(part, g.mask, g.gsz);
}

// Pairs whose reads a group issues together, 4 / kC: the latency of a
// row's loads is paid once per batch, not once per pair.
template <int kC>
constexpr int kBatch = 4 / kC;

// What a query row's group reads for one pair: k_j and v_j's head slices
// and the edge bias of its leader edge (0 without eb).
template <int kC>
struct Pair {
  float4 k[kC], v[kC];
  float eb;
};

// (hb: the element of eb where bin b's head h starts.)
template <int kC, int kMode>
__device__ inline void fetch_pair(Pair<kC>& x, const Args& a, const List& l, size_t hb, int b, int h, int p,
                                  const Group& g) {
  const size_t jrow = head_row(a, b, l.other[p], h);
  load_slice<kC, kMode>(x.k, a.k, jrow, g);
  load_slice<kC, kMode>(x.v, a.v, jrow, g);
  x.eb = a.eb != nullptr ? edge_bias<kMode>(a, hb + l.e[p]) : 0.f;
}

// The score of the pair led by entry p (its run ending at `end`) from k_j's
// head slice and its leader edge's bias eb: q_i . k_j / sqrt(dh) plus the
// bias of its edges, in ascending edge id.
template <int kC, int kMode>
__device__ inline float pair_score(const Args& a, const List& l, size_t hb, const float4 (&qi)[kC],
                                   const float4 (&kj)[kC], float eb, int p, int end, const Group& g) {
  float bias = eb;
  if (a.eb != nullptr)
    for (int t = p + 1; t < end && !l.lead[t]; ++t) bias += edge_bias<kMode>(a, hb + l.e[t]);
  return group_dot(qi, kj, g) * a.scale + bias;
}

// The query pass of slot (i, h) over the pairs of a query pass's list l (n
// long) in ascending src. kExact: an online softmax, its max m and sum den
// (floored) and, rescaled when m rises, the combine (forward), or the sums of
// exp * g_alpha, of exp * g_alpha * k_j and of exp * k_j (backward); leaves
// in acc the output (forward) or sum_j g_s k_j (backward), each times den.
// The bf16 modes: a first pass for m and den, then the combine of the
// rounded alpha (forward), or D_i and then sum_j g_s(bf16) k_j (backward),
// into acc as it is (not times den). Each pair is fetched once a pass: the
// first pass (lane 0 of the group) keeps each pair's score, and what follows
// reads it back, formed in the same order from the same floats as a
// recompute would give. The forward keeps it at score[p * H + h], p the
// pair's leader entry (shared memory), so its first pass fetches k_j and its
// second v_j alone. With kBwd, D_i in dsum and each pair's score and g_alpha
// in score[e] and galpha[e], e its leader edge, and only g_q's pass fetches
// (k_j alone).
template <bool kBwd, int kC, int kMode>
__device__ inline void query_walk(const Args& a, const List& l, int n, int b, int i, int h, const Group& g,
                                  const float4 (&qi)[kC], const float4 (&gi)[kC], float* score,
                                  float* galpha, float4 (&acc)[kC], float& m, float& den, float& dsum) {
  constexpr int kB = kBatch<kC>;
  const size_t hb = ((size_t)b * a.H + h) * a.E;
  float4 ksum[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = ksum[c] = zero4();
  m = -INFINITY;
  den = 0.f;
  float tsum = 0.f;
  const int begin = lower_bound(l, n, i * a.V), end = lower_bound(l, n, (i + 1) * a.V);
  // visit(x, p, score) for each pair of the row, p its leader entry; the
  // reads of kB pairs issued together
  auto walk = [&](auto&& visit) {
    for (int p = begin; p < end;) {
      int pos[kB];
      Pair<kC> x[kB];
#pragma unroll
      for (int t = 0; t < kB; ++t) {
        pos[t] = p;
        if (p < end) {
          fetch_pair<kC, kMode>(x[t], a, l, hb, b, h, p, g);
          p = next_leader(l, p, end);
        }
      }
#pragma unroll
      for (int t = 0; t < kB; ++t) {
        if (pos[t] >= end) break;
        visit(x[t], pos[t], pair_score<kC, kMode>(a, l, hb, qi, x[t].k, x[t].eb, pos[t], end, g));
      }
    }
  };
  if constexpr (kMode == kExact) {
    walk([&](const Pair<kC>& x, int pos, float sc) {
      const float mx = fmaxf(m, sc), cor = expf(m - mx), w = expf(sc - mx);
      m = mx;
      den = fmaf(den, cor, w);
      if constexpr (kBwd) {
        const float ga = group_dot(gi, x.v, g);
        tsum = fmaf(tsum, cor, w * ga);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc[c] = fma4(w * ga, x.k[c], scale4(cor, acc[c]));
          ksum[c] = fma4(w, x.k[c], scale4(cor, ksum[c]));
        }
        if (g.lane == 0) {
          score[l.e[pos]] = sc;
          galpha[l.e[pos]] = ga;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = fma4(w, x.v[c], scale4(cor, acc[c]));
      }
    });
    den = fmaxf(den, 1e-12f);
    if constexpr (kBwd) {
      // g_q = sum_j g_s k_j / sqrt(dh) with g_s = alpha g_alpha - alpha D_i:
      // (acc - D_i ksum) / den / sqrt(dh)
      dsum = tsum / den;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = fma4(-dsum, ksum[c], acc[c]);
    }
  } else if constexpr (!kBwd) {
    // the first walk: k_j and the leader's bias alone, kB pairs' reads
    // together; lane 0 keeps each pair's score at score[p * H + h], p its
    // leader entry
    auto fetch_keys = [&](int& p, int (&pos)[kB], float4 (&kj)[kB][kC], float (&eb)[kB]) {
#pragma unroll
      for (int t = 0; t < kB; ++t) {
        pos[t] = p;
        if (p < end) {
          load_slice<kC, kMode>(kj[t], a.k, head_row(a, b, l.other[p], h), g);
          eb[t] = a.eb != nullptr ? edge_bias<kMode>(a, hb + l.e[p]) : 0.f;
          p = next_leader(l, p, end);
        }
      }
    };
    auto keep_scores = [&](const int (&pos)[kB], const float4 (&kj)[kB][kC], const float (&eb)[kB]) {
#pragma unroll
      for (int t = 0; t < kB; ++t) {
        if (pos[t] >= end) break;
        const float sc = pair_score<kC, kMode>(a, l, hb, qi, kj[t], eb[t], pos[t], end, g);
        const float mx = fmaxf(m, sc);
        den = fmaf(den, expf(m - mx), expf(sc - mx));
        m = mx;
        if (g.lane == 0) score[pos[t] * a.H + h] = sc;
      }
    };
    // the first batch's v_j, the second walk's first operands, fetched after
    // its k_j: they wait on no max or sum, so their reads overlap the walk
    int p = begin, pos0[kB];
    float4 v0[kB][kC];
    {
      float4 kj[kB][kC];
      float eb[kB];
      fetch_keys(p, pos0, kj, eb);
#pragma unroll
      for (int t = 0; t < kB; ++t)
        if (pos0[t] < end) load_slice<kC, kMode>(v0[t], a.v, head_row(a, b, l.other[pos0[t]], h), g);
      keep_scores(pos0, kj, eb);
    }
    const int rest = p;
    while (p < end) {
      int pos[kB];
      float4 kj[kB][kC];
      float eb[kB];
      fetch_keys(p, pos, kj, eb);
      keep_scores(pos, kj, eb);
    }
    stamp(kFwdKernel, 4, false, false);
    den = fmaxf(den, 1e-12f);
    __syncwarp(g.mask);  // lane 0's stores of the scores, before the group reads them
    // the second walk: the rounded alpha of each kept score times v_j, v_j
    // alone fetched, kB pairs' reads together
    auto combine = [&](const float4 (&vj)[kC], int at) {
      const float w = operand<true>(mode_alpha<kMode>(score[at * a.H + h], m, den));
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = fma4(w, vj[c], acc[c]);
    };
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      if (pos0[t] >= end) break;
      combine(v0[t], pos0[t]);
    }
    for (p = rest; p < end;) {
      int pos[kB];
      float4 vj[kB][kC];
#pragma unroll
      for (int t = 0; t < kB; ++t) {
        pos[t] = p;
        if (p < end) {
          load_slice<kC, kMode>(vj[t], a.v, head_row(a, b, l.other[p], h), g);
          p = next_leader(l, p, end);
        }
      }
#pragma unroll
      for (int t = 0; t < kB; ++t) {
        if (pos[t] >= end) break;
        combine(vj[t], pos[t]);
      }
    }
    stamp(kFwdKernel, 5, false, false);
  } else {
    walk([&](const Pair<kC>& x, int pos, float sc) {
      const float mx = fmaxf(m, sc);
      den = fmaf(den, expf(m - mx), expf(sc - mx));
      m = mx;
      const float ga = group_dot(gi, x.v, g);
      if (g.lane == 0) {
        score[l.e[pos]] = sc;
        galpha[l.e[pos]] = ga;
      }
    });
    den = fmaxf(den, 1e-12f);
    {
      __syncwarp(g.mask);  // lane 0's stores of score and galpha, before the group reads them
      float d = 0.f;
      for (int p = begin; p < end; p = next_leader(l, p, end)) {
        const int e = l.e[p];
        d = __fadd_rn(d, __fmul_rn(mode_alpha<kMode>(score[e], m, den), galpha[e]));
      }
      dsum = d;
      // g_q: only k_j is fetched, kB pairs' reads together (2 kB spilled
      // registers at four vectors a lane and was slower)
      for (int p = begin; p < end;) {
        int pos[kB];
        float4 kj[kB][kC];
#pragma unroll
        for (int t = 0; t < kB; ++t) {
          pos[t] = p;
          if (p < end) {
            load_slice<kC, kMode>(kj[t], a.k, head_row(a, b, l.other[p], h), g);
            p = next_leader(l, p, end);
          }
        }
#pragma unroll
        for (int t = 0; t < kB; ++t) {
          if (pos[t] >= end) break;
          const int e = l.e[pos[t]];
          const float gs = mode_gs(mode_alpha<kMode>(score[e], m, den), galpha[e], d);
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[c] = fma4(gs, kj[t][c], acc[c]);
        }
      }
    }
  }
}

// What the key pass reads of a pair: its score and g_alpha, and its query
// slot's softmax max, sum and D_i.
struct PairValues {
  float score, galpha, max, sum, dsum;
};

// The key pass of slot (j, h) over the pairs of a key pass's list l (n long)
// in ascending query row: `values(p)` gives the PairValues of the pair led by
// entry p. Writes g_v_j, g_k_j and, with eb, g_s on each of the pairs' edges
// in g_eb. In the bf16 modes alpha is rounded to dt, g_s to bf16, and both
// into the products with g_i and q_i (rounded as loaded).
template <int kC, int kMode, class Values>
__device__ inline void key_walk(const Args& a, const List& l, int n, int b, int j, int h, const Group& g,
                                Values values) {
  constexpr int kB = kBatch<kC>;
  const size_t hb = ((size_t)b * a.H + h) * a.E;
  const int end = lower_bound(l, n, (j + 1) * a.V);
  float4 accv[kC], acck[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) accv[c] = acck[c] = zero4();
  for (int p = lower_bound(l, n, j * a.V); p < end;) {
    int pos[kB];
    float sc[kB], ga[kB], mx[kB], den[kB], ds[kB];
    float4 gx[kB][kC], qx[kB][kC];
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      pos[t] = p;
      if (p < end) {
        const size_t irow = head_row(a, b, l.other[p], h);
        const PairValues x = values(p);
        sc[t] = x.score;
        ga[t] = x.galpha;
        mx[t] = x.max;
        den[t] = x.sum;
        ds[t] = x.dsum;
        load_slice<kC, kMode>(gx[t], a.g, irow, g);
        load_slice<kC, kMode>(qx[t], a.q, irow, g);
        p = next_leader(l, p, end);
      } else {
        sc[t] = -INFINITY;
        ga[t] = ds[t] = mx[t] = 0.f;
        den[t] = 1.f;
#pragma unroll
        for (int c = 0; c < kC; ++c) gx[t][c] = qx[t][c] = zero4();
      }
    }
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      float al, gs;
      if constexpr (kMode == kExact) {
        al = expf(sc[t] - mx[t]) / den[t];
        gs = al * ga[t] - al * ds[t];
      } else {
        const float af = mode_alpha<kMode>(sc[t], mx[t], den[t]);
        al = operand<true>(af);
        gs = mode_gs(af, ga[t], ds[t]);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        accv[c] = fma4(al, gx[t][c], accv[c]);
        acck[c] = fma4(gs, qx[t][c], acck[c]);
      }
      if (a.geb != nullptr && g.lane == 0 && pos[t] < end)
        for (int e = pos[t]; e < end && (e == pos[t] || !l.lead[e]); ++e) store1<kMode>(a.geb, hb + l.e[e], gs);
    }
  }
  const size_t row = head_row(a, b, j, h);
  store_slice<kC, kMode>(a.gv, row, accv, 1.f, g);
  store_slice<kC, kMode>(a.gk, row, acck, a.scale, g);
}

// Row 11's scratch, written by its query pass for its key pass: each pair's
// score and g_alpha at its leader edge ([B, H, E] each), and each query
// slot's softmax max, sum and D_i ([B, H, V] each).
struct Scratch {
  float *score, *galpha, *max, *sum, *dsum;
};

__device__ inline Scratch carve_scratch(float* w, const Args& a) {
  const size_t lanes = (size_t)a.B * a.H * a.E, rows = (size_t)a.B * a.H * a.V;
  return {w, w + lanes, w + 2 * lanes, w + 2 * lanes + rows, w + 2 * lanes + 2 * rows};
}

// Rows 10 and 12 (forward: out) and row 11's query pass (g_q and the
// scratch), a group per (query row, head).
template <bool kBwd, int kC, int kMin, int kMode>
__global__ void __launch_bounds__(kListThreads, kMin)
    attn_rows_kernel(const Args a, float* scratch) {
  constexpr int kStage = kBwd ? kRowsKernel : kFwdKernel;
  stamp(kStage, 0, true, false);
  extern __shared__ int list_smem[];
  const List l = carve_list(list_smem, a.E, list_smem + list_words(a.E));
  const Group g = list_group(a);
  const int slots = a.V * a.H, chunks = chunks_per_bin(a);
  const int b = blockIdx.x / chunks, first = blockIdx.x % chunks * g.count;
  const int last = min(first + g.count, slots) - 1, slot = first + g.index;
  const int i = min(slot, last) / a.H, h = min(slot, last) % a.H;
  const size_t hb = ((size_t)b * a.H + h) * a.E, row = head_row(a, b, i, h);
  float4 qi[kC], gi[kC], acc[kC];
  load_slice<kC, kMode>(qi, a.q, row, g);  // in flight during the gather
  if constexpr (kBwd) load_slice<kC, kMode>(gi, a.g, row, g);
  const bool zero_dead = kBwd && a.geb != nullptr && first == 0;
  const int n = gather_edges<true, kMode>(a, l, b, first / a.H, last / a.H, zero_dead, kStage);
  stamp(kStage, 2, false, false);
  if (slot > last) return;
  Scratch sc{};
  if constexpr (kBwd) sc = carve_scratch(scratch, a);
  // the bf16 forward's kept scores: the gather order's words, free once sorted
  float* kept = reinterpret_cast<float*>(list_smem + list_words(a.E));
  float m, den, dsum;
  query_walk<kBwd, kC, kMode>(a, l, n, b, i, h, g, qi, gi, kBwd ? sc.score + hb : kept,
                              kBwd ? sc.galpha + hb : nullptr, acc, m, den, dsum);
  if constexpr (!kBwd) {  // kExact's sums are times den
    store_slice<kC, kMode>(a.out, row, acc, kMode == kExact ? 1.f / den : 1.f, g);
  } else {
    store_slice<kC, kMode>(a.gq, row, acc, kMode == kExact ? a.scale / den : a.scale, g);
    if (g.lane == 0) {
      const size_t at = ((size_t)b * a.H + h) * a.V + i;
      sc.max[at] = m;
      sc.sum[at] = den;
      sc.dsum[at] = dsum;
    }
  }
  stamp(kStage, 3, false, true);
}

// Row 11's key pass: g_v, g_k and g_eb, a group per (key row, head), from the
// values its query pass left in scratch.
template <int kC, int kMode>
__global__ void __launch_bounds__(kListThreads, kMinBlocks<kC>)
    attn_cols_kernel(const Args a, float* scratch) {
  stamp(kColsKernel, 0, true, false);
  extern __shared__ int list_smem[];
  const List l = carve_list(list_smem, a.E, list_smem + list_words(a.E));
  const Group g = list_group(a);
  const int slots = a.V * a.H, chunks = chunks_per_bin(a);
  const int b = blockIdx.x / chunks, first = blockIdx.x % chunks * g.count;
  const int last = min(first + g.count, slots) - 1, slot = first + g.index;
  const int n = gather_edges<false, kMode>(a, l, b, first / a.H, last / a.H, false, kColsKernel);
  stamp(kColsKernel, 2, false, false);
  if (slot > last) return;
  const int j = slot / a.H, h = slot % a.H;
  const size_t hb = ((size_t)b * a.H + h) * a.E, hv = ((size_t)b * a.H + h) * a.V;
  const Scratch in = carve_scratch(scratch, a);
  key_walk<kC, kMode>(a, l, n, b, j, h, g, [&](int p) {
    const size_t at = hv + l.other[p];
    return PairValues{in.score[hb + l.e[p]], in.galpha[hb + l.e[p]], in.max[at], in.sum[at], in.dsum[at]};
  });
  stamp(kColsKernel, 3, false, true);
}

// Row 13's shared memory a block: its rows' edges by dst and by src (two
// lists), then each pair's score and g_alpha at its leader edge ([H, E]
// each; the lists' gather orders before them), and each of its slots'
// softmax max, sum and D_i ([rows, H] each).
__host__ __device__ inline size_t cluster_values_words(int E, int H) {
  return 2 * (size_t)H * E > 4 * (size_t)E ? 2 * (size_t)H * E : 4 * (size_t)E;
}

__host__ __device__ inline size_t cluster_smem_bytes(int E, int H, int rows) {
  return sizeof(int) * (2 * list_words(E) + cluster_values_words(E, H) + 3 * (size_t)rows * H);
}

// Row 13's clusters: `size` blocks a bin, each owning `rows` query and key
// rows. As many blocks as hold a bin's slots in one run each, up to
// kMaxCluster, or the portable 8 where a block takes more than half an SM's
// shared memory (a cluster's blocks must fit one GPC at once).
struct ClusterShape {
  int rows, size;
  size_t smem;
};

ClusterShape cluster_shape(const Args& a) {
  const long long want = ((long long)a.V * a.H + slots_per_block(a) - 1) / slots_per_block(a);
  ClusterShape c{};
  for (int cap = kMaxCluster;; cap = 8) {
    const int size = (int)(want < cap ? want : cap);
    c.rows = (a.V + size - 1) / size;
    c.size = (a.V + c.rows - 1) / c.rows;
    c.smem = cluster_smem_bytes(a.E, a.H, c.rows);
    if (cap == 8 || 2 * c.smem <= (size_t)kMaxSmem) return c;
  }
}

// Row 13: the recompute backward in one launch, a cluster per bin (see the
// design above); block r of bin b's cluster owns rows [r * rows, ...).
template <int kC, int kMode>
__global__ void __launch_bounds__(kListThreads, kC == 4 ? kClusterMinBlocks4 : kMinBlocks<kC>)
    attn_cluster_kernel(const Args a, int rows) {
  stamp(kClusterKernel, 0, true, false);
  cg::cluster_group cluster = cg::this_cluster();
  stamp_cluster0(7, (int)cluster.num_blocks());
  extern __shared__ int list_smem[];
  int* values = list_smem + 2 * list_words(a.E);
  const List by_dst = carve_list(list_smem, a.E, values);
  const List by_src = carve_list(list_smem + list_words(a.E), a.E, values + 2 * a.E);
  float* score = reinterpret_cast<float*>(values);
  float* galpha = score + (size_t)a.H * a.E;
  float* smax = reinterpret_cast<float*>(values + cluster_values_words(a.E, a.H));
  float* ssum = smax + (size_t)rows * a.H;
  float* sdsum = ssum + (size_t)rows * a.H;
  const Group g = list_group(a);
  const int rank = (int)cluster.block_rank(), b = blockIdx.x / (int)cluster.num_blocks();
  const int lo = rank * rows, hi = min(lo + rows, a.V) - 1;
  const int first = lo * a.H, end = (hi + 1) * a.H;  // the block's slots
  float4 qi[kC], gi[kC];
  {  // the first run's rows in flight during the gather
    const int s = min(first + g.index, end - 1);
    const size_t row = head_row(a, b, s / a.H, s % a.H);
    load_slice<kC, kMode>(qi, a.q, row, g);
    load_slice<kC, kMode>(gi, a.g, row, g);
  }
  const int2 n = gather_lists<true, true, kMode>(a, by_dst, by_src, b, lo, hi, a.geb != nullptr && rank == 0,
                                                  kClusterKernel);
  stamp(kClusterKernel, 2, false, false);
  // phase 1, the query pass: g_q, and the values the key passes read
  for (int run = first; run < end; run += g.count) {
    const int slot = run + g.index;
    if (slot >= end) break;
    const int i = slot / a.H, h = slot % a.H;
    const size_t row = head_row(a, b, i, h);
    if (run != first) {
      load_slice<kC, kMode>(qi, a.q, row, g);
      load_slice<kC, kMode>(gi, a.g, row, g);
    }
    float4 acc[kC];
    float m, den, dsum;
    query_walk<true, kC, kMode>(a, by_dst, n.x, b, i, h, g, qi, gi, score + (size_t)h * a.E,
                                galpha + (size_t)h * a.E, acc, m, den, dsum);
    store_slice<kC, kMode>(a.gq, row, acc, kMode == kExact ? a.scale / den : a.scale, g);
    if (g.lane == 0) {
      const int at = (i - lo) * a.H + h;
      smax[at] = m;
      ssum[at] = den;
      sdsum[at] = dsum;
    }
  }
  stamp(kClusterKernel, 3, false, false);
  stamp_cluster0(8, (int)cluster.num_blocks());
  cluster.sync();
  stamp(kClusterKernel, 4, false, false);
  // phase 2, the key pass: each pair's values from the block that owns its
  // query row, through distributed shared memory
  for (int run = first; run < end; run += g.count) {
    const int slot = run + g.index;
    if (slot >= end) break;
    const int j = slot / a.H, h = slot % a.H;
    key_walk<kC, kMode>(a, by_src, n.y, b, j, h, g, [&](int p) {
      const int i = by_src.other[p], owner = i / rows;
      const size_t e = (size_t)h * a.E + by_src.e[p];
      const int at = (i - owner * rows) * a.H + h;
      return PairValues{*cluster.map_shared_rank(score + e, owner), *cluster.map_shared_rank(galpha + e, owner),
                        *cluster.map_shared_rank(smax + at, owner), *cluster.map_shared_rank(ssum + at, owner),
                        *cluster.map_shared_rank(sdsum + at, owner)};
    });
  }
  stamp(kClusterKernel, 5, false, false);
  stamp_cluster0(9, (int)cluster.num_blocks());
  cluster.sync();  // no block leaves while another may read its shared memory
  stamp(kClusterKernel, 6, false, true);
}

using ListKernel = void (*)(const Args, float*);

cudaError_t launch_list(ListKernel kernel, uint64_t& configured, const Args& a, float* scratch, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem((const void*)kernel, kMaxSmem, configured);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.B * chunks_per_bin(a), kListThreads, smem, stream>>>(a, scratch);
  return cudaGetLastError();
}

template <int kC, int kMode>
cudaError_t launch_cluster(const Args& a, cudaStream_t stream) {
  static uint64_t smem_configured = 0, wide_configured = 0;
  const void* kernel = (const void*)attn_cluster_kernel<kC, kMode>;
  const ClusterShape c = cluster_shape(a);
  cudaError_t err = cudaSuccess;
  if (c.smem > 48 * 1024) err = allow_smem(kernel, kMaxSmem, smem_configured);
  if (err == cudaSuccess && c.size > 8)
    err = set_attribute_once(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1, wide_configured);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.B * c.size);
  config.blockDim = dim3(kListThreads);
  config.dynamicSmemBytes = c.smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = c.size;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, attn_cluster_kernel<kC, kMode>, a, c.rows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Which launch: a forward (row 10's or row 12's instantiation), row 11's
// two launches or row 13's clusters.
enum class Launch { kFwdV1, kFwdV2, kTwoPass, kCluster };

template <int kC, int kMode>
cudaError_t run_at(const Args& a, float* scratch, Launch launch, cudaStream_t st) {
  static uint64_t fwd_configured = 0, fwd2_configured = 0, rows_configured = 0, cols_configured = 0;
  constexpr int kFwd2Min = kC == 4 ? kMinBlocks<kC> : kV2FwdMinBlocks;
  const size_t fwd = fwd_smem_bytes(a.E, a.H, kMode), list = list_smem_bytes(a.E);
  switch (launch) {
    case Launch::kFwdV1:
      return launch_list(attn_rows_kernel<false, kC, kMinBlocks<kC>, kMode>, fwd_configured, a, nullptr, fwd, st);
    case Launch::kFwdV2:
      return launch_list(attn_rows_kernel<false, kC, kFwd2Min, kMode>, fwd2_configured, a, nullptr, fwd, st);
    case Launch::kCluster: return launch_cluster<kC, kMode>(a, st);
    default: break;
  }
  const cudaError_t err =
      launch_list(attn_rows_kernel<true, kC, kMinBlocks<kC>, kMode>, rows_configured, a, scratch, list, st);
  if (err != cudaSuccess) return err;
  return launch_list(attn_cols_kernel<kC, kMode>, cols_configured, a, scratch, list, st);
}

size_t smem_bytes(const Args& a, Launch launch, int mode) {
  switch (launch) {
    case Launch::kCluster: return cluster_shape(a).smem;
    case Launch::kTwoPass: return list_smem_bytes(a.E);
    default: return fwd_smem_bytes(a.E, a.H, mode);
  }
}

bool bad_shape(const Args& a, Launch launch, int mode) {
  return bad_head(a) || misaligned(a) || smem_bytes(a, launch, mode) > (size_t)kMaxSmem || a.V > kMaxV ||
         (long long)a.V * a.H > INT32_MAX || (long long)a.B * chunks_per_bin(a) > INT32_MAX;
}

template <int kMode>
cudaError_t run_mode(const Args& a, float* scratch, Launch launch, cudaStream_t st) {
  switch (vectors_per_lane(a)) {
    case 1: return run_at<1, kMode>(a, scratch, launch, st);
    case 2: return run_at<2, kMode>(a, scratch, launch, st);
    default: return run_at<4, kMode>(a, scratch, launch, st);
  }
}

// mode: kExact, kMm or kHalf (see above).
cudaError_t run(const Args& a, float* scratch, Launch launch, int mode, void* stream) {
  if (bad_shape(a, launch, mode) || (launch == Launch::kTwoPass && scratch == nullptr) || mode < kExact ||
      mode > kHalf)
    return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kExact: return run_mode<kExact>(a, scratch, launch, st);
    case kMm: return run_mode<kMm>(a, scratch, launch, st);
    default: return run_mode<kHalf>(a, scratch, launch, st);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes a block needs at these shapes: for the forwards (rows
// 10 and 12) in `mode`, its edge list at E lanes and, in the bf16 modes, each
// pair's score for H heads (the most a launch of row 10, 11 or 12 takes);
// for row 13, its two lists and its rows' values; and the most a block may
// have. The wrappers raise, naming the shape, above the latter.
long long dense_attention_list_smem_bytes(int E, int H, int mode) { return (long long)fwd_smem_bytes(E, H, mode); }

long long dense_attention_cluster_smem_bytes(int V, int E, int H, int dh) {
  Args a{};
  a.V = V;
  a.E = E;
  a.H = H;
  a.dh = dh;
  a.vecs = kV2BwdVecs;
  return (long long)cluster_shape(a).smem;
}

// Row 13's clusters at these shapes: blocks a cluster, and how many such
// clusters the card holds at once (cudaOccupancyMaxActiveClusters), or a
// negative cudaError_t.
int dense_attention_cluster_blocks(int V, int E, int H, int dh) {
  Args a{};
  a.V = V;
  a.E = E;
  a.H = H;
  a.dh = dh;
  a.vecs = kV2BwdVecs;
  return cluster_shape(a).size;
}

int dense_attention_active_clusters(int V, int E, int H, int dh) {
  Args a{};
  a.V = V;
  a.E = E;
  a.H = H;
  a.dh = dh;
  a.vecs = kV2BwdVecs;
  const ClusterShape c = cluster_shape(a);
  const void* kernel = vectors_per_lane(a) == 1   ? (const void*)attn_cluster_kernel<1, kExact>
                       : vectors_per_lane(a) == 2 ? (const void*)attn_cluster_kernel<2, kExact>
                                                  : (const void*)attn_cluster_kernel<4, kExact>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(c.size * 64);
  config.blockDim = dim3(kListThreads);
  config.dynamicSmemBytes = c.smem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = c.size;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &config);
  return err == cudaSuccess ? n : -(int)err;
}

int dense_attention_max_smem() { return kMaxSmem; }

int dense_attention_max_dh() { return kMaxDh; }

int dense_attention_max_v() { return kMaxV; }

// Row 12's forward: q, k, v, out [B, V, H * dh]; eb [B, H, E] or null; src,
// dst [B, E] int32; emask [B, E] bytes. The float arrays are f32, or bf16
// (__nv_bfloat16) with mode 2; mode 0 is exact f32, 1 f32 with bf16 operands
// (matmul_dtype="bfloat16"), 2 bf16 in and out (see kExact, kMm, kHalf).
// Device pointers of contiguous arrays, the float ones 16-byte aligned; dh a
// multiple of 4. The stream is a cudaStream_t. Returns the cudaError_t of the
// launch (0 on success).
int dense_attention_fwd_f32(const float* q, const float* k, const float* v, const float* eb,
                            const int* src, const int* dst, const unsigned char* emask, float* out,
                            int B, int V, int E, int H, int dh, float scale, int mode, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, nullptr, out, nullptr, nullptr, nullptr, nullptr,
               B, V, E, H, dh, scale, kVecs};
  return (int)run(a, nullptr, Launch::kFwdV2, mode, stream);
}

// Row 13's recompute backward, one launch on clusters: g (the cotangent of
// out) and g_q, g_k, g_v [B, V, H * dh]; g_eb [B, H, E], written when eb is
// not null. The rest as for the forward.
int dense_attention_bwd_f32(const float* q, const float* k, const float* v, const float* eb,
                            const int* src, const int* dst, const unsigned char* emask,
                            const float* g, float* gq, float* gk, float* gv, float* geb, int B,
                            int V, int E, int H, int dh, float scale, int mode, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, g, nullptr, gq, gk, gv, eb != nullptr ? geb : nullptr,
               B, V, E, H, dh, scale, kV2BwdVecs};
  return (int)run(a, nullptr, Launch::kCluster, mode, stream);
}

// Rows 10 and 11, the same arguments as rows 12 and 13; the backward also
// takes scratch of 2 * B * H * E + 3 * B * H * V floats, written by its query
// pass for its key pass (see Scratch), and is two launches on the stream.
int dense_attention_v1_fwd_f32(const float* q, const float* k, const float* v, const float* eb,
                               const int* src, const int* dst, const unsigned char* emask, float* out,
                               int B, int V, int E, int H, int dh, float scale, int mode, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, nullptr, out, nullptr, nullptr, nullptr, nullptr,
               B, V, E, H, dh, scale, kVecs};
  return (int)run(a, nullptr, Launch::kFwdV1, mode, stream);
}

int dense_attention_v1_bwd_f32(const float* q, const float* k, const float* v, const float* eb,
                               const int* src, const int* dst, const unsigned char* emask,
                               const float* g, float* gq, float* gk, float* gv, float* geb,
                               float* scratch, int B, int V, int E, int H, int dh, float scale,
                               int mode, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, g, nullptr, gq, gk, gv, eb != nullptr ? geb : nullptr,
               B, V, E, H, dh, scale, kVecs};
  return (int)run(a, scratch, Launch::kTwoPass, mode, stream);
}

// The stage stamps of a build with kStages = 1 (see stamp): 1 if this build
// stamps. `reset` clears them before a launch; `read` copies out
// kStageKernels x kStageSlots stamps of block 0 (the forward, row 11's query
// pass, its key pass, row 13), then each kernel's earliest block start and
// latest block end, in ns of %globaltimer. Both return the cudaError_t.
int dense_attention_stages_built() { return kStages; }

int dense_attention_stages_reset() {
  unsigned long long at[kStageKernels][kStageSlots] = {}, span[kStageKernels][2];
  for (auto& s : span) {
    s[0] = ~0ull;
    s[1] = 0;
  }
  const cudaError_t err = cudaMemcpyToSymbol(stage_at, at, sizeof at);
  return (int)(err != cudaSuccess ? err : cudaMemcpyToSymbol(stage_span, span, sizeof span));
}

int dense_attention_stages_read(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, stage_at, sizeof stage_at);
  return (int)(err != cudaSuccess ? err
                                  : cudaMemcpyFromSymbol(out + kStageKernels * kStageSlots, stage_span,
                                                         sizeof stage_span));
}

const char* dense_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
