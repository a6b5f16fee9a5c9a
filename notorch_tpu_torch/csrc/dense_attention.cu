// The dense graph-attention core, forward and recompute backward, in CUDA C++
// for sm_90a.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_attention.py:
//   - _attn_kernel / fused_dense_attention_fwd (v1, row 10): attn_rows_kernel<false>;
//   - _attn_bwd_kernel / fused_dense_attention_bwd (v1, row 11): the query pass
//     attn_rows_kernel<true>, then the key pass attn_cols_kernel;
//   - _attn_kernel_v2 / fused_dense_attention_fwd_v2 (row 12) and
//     _attn_bwd_kernel_v2 / fused_dense_attention_bwd_v2 (row 13):
//     attn_kernel<false> and attn_kernel<true>, a block per (bin, head).
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
// Design of rows 12-13. The TPU kernels build the one-hot operators G and St
// and the [V, V] score tile in VMEM and run every product densely on the MXU.
// Here the mask is what it is, a sparse set of pairs: a molecule's node has a
// few bonded neighbours, so M has about as many nonzeros as the bin has real
// edges (3,738 of the 16 x 128 x 128 lanes of the packed lipo batch).
// Each block builds, in shared memory and from src, dst and edge_mask alone,
// the bin's live edges grouped by dst (a CSR over query rows: counts by
// shared-memory int atomics, which do not depend on order, a scan, then each
// node's run sorted by edge id) and links the edges of a run that share a
// src, so that each (i, j) pair is one softmax lane whose bias sums its edges
// in ascending e. The backward also groups each pair by src (a CSR over key
// rows, each run sorted by query row). Nothing of the mask or the bias is
// read from device memory; nothing of size V x V exists anywhere.
// The head's slices of k and v (forward and the backward's row pass), then of
// q and the cotangent (the backward's column pass) are staged in shared
// memory with 16-byte loads, all threads at once; a group of up to 32 lanes
// (dh / 4 rounded up to a power of two) owns one query row, each lane one
// 16-byte column vector per 128 columns, and reduces its dot products with
// xor shuffles, which give every lane of the group the same bits. The
// softmax takes two passes over the row's pairs (max, then sum and combine),
// in the order of the run, as the plain version's dense row sums would add
// the same nonzero terms. g_k and g_v sum over query rows: each is written
// once, by the group that owns its key row, over its src-grouped pairs in
// ascending query row, with no float atomics, so two calls give the same bits.
//
// Design of rows 10-11: every bin and head in flight at once. The TPU's v1
// grid walks tiles of bins in order on one core, looping over the heads; on
// the card blocks run side by side, so no block loops over bins or heads.
// The (row, head) slots of a bin are numbered s = i * H + h, and the grid
// puts a block of 128 threads on each (bin, run of 128 / gsz slots), a lane
// group on each slot: gsz lanes of up to two 16-byte vectors of the head's
// dh columns each (8 lanes at dh = 64), so that a row's scalar work (the walk
// of its pairs, the softmax) is repeated on few lanes. The heads of one row
// sit in neighbouring groups: a neighbour's k or v row is read as one
// contiguous line of H * dh floats. A block first gathers, from the bin's
// src, dst and edge_mask lanes, the live edges whose dst (the query pass) or
// src (the key pass) is one of its rows, in ascending edge id (a ballot per
// warp, the warps' counts added in warp order, the next lanes' loads in
// flight meanwhile), and links the edges of each (dst, src) pair from the
// first, its leader: the index of its rows, built once for all their heads,
// 24 bytes a lane of shared memory, and no [V, dh] staging. Each group then
// gathers its pairs' head slices through L2, 16 bytes a lane, the reads of up
// to 4 / (vectors a lane) pairs issued together.
//   Forward (row 10): one pass over the row's pairs in ascending leader, an
//   online softmax (the sum and the combine rescaled when the running max
//   rises).
//   Backward (row 11), the query pass: the same pass also sums, rescaled
//   alike, exp * g_alpha, exp * g_alpha * k_j and exp * k_j, so that
//   g_q_i = (sum exp g_alpha k_j - D_i sum exp k_j) / (sum exp) / sqrt(dh)
//   with D_i = sum_j alpha g_alpha, and leaves in scratch each pair's score
//   and g_alpha (at its leader edge, [B, H, E]) and each slot's max, sum and
//   D_i ([B, H, V]). The first block of each bin zeroes g_eb on the bin's
//   lanes that are not live.
//   The key pass (a second launch, the card's answer to the TPU's sequential
//   grid): a group per (key row, head) takes its pairs in ascending query row
//   (the leaders sorted by (src, dst) in shared memory), forms
//   alpha = exp(score - max) / sum and g_s = alpha g_alpha - alpha D_i from
//   the scratch, sums alpha g_i into g_v_j and g_s q_i into g_k_j, and writes
//   g_s on each of the pair's edges in g_eb.
//   Every output is written once, by one group, in a fixed order, with no
//   float atomics: two calls give the same bits.
// Exact f32 on CUDA cores throughout, no TF32.
//
// What bounds them on this card. Counted at this data's live pairs, the
// products are a few operations per byte moved (4 * dh per pair and head
// forward, 10 * dh backward, against q, k, v, out rows of 4 * dh bytes):
// every body is bound by bytes, each input read once and each output written
// once over 3.35 TB/s (2.5 us forward and 4.4 us backward at the packed lipo
// batch of 16 bins, V = 128, E = 256, H = 4, dh = 64). Counted densely, as
// the TPU's MXU runs them (4 V^2 dh a head forward), they would be bound by
// operations. What the designs do about the bytes: rows 12-13 read each
// element of q, k, v and g from device memory once per (bin, head) block, by
// 16-byte loads that all threads issue together, and every further read hits
// shared memory, after an index build and barriers that cost a few
// microseconds a block. Rows 10-11 read each operand row from device memory
// into L2 once (2 MB an operand at the packed batch, far under the 50 MB L2)
// and gather from there only the rows a pair needs. What is left over the
// bytes is latency, paid once per launch and not per head: the launch, the
// block's gather (its loads and five barriers), and a row's batches of pair
// reads in turn; the backward pays it twice, once per pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 4;           // 16-byte vectors of a head row per lane: dh <= 512
constexpr int kMaxDh = 4 * 32 * kMaxChunks;
constexpr int kMaxSmem = 232448;        // the 227 KB a block may use after the opt-in

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
};

// Shared memory of one bin (ints first, then floats; the two staged head
// slices last, 16-byte aligned).
struct Bin {
  int* src;     // [E] src of every lane
  int* dst;     // [E] dst of a live edge, -1 on any other lane
  int* pos;     // [E] a live edge's position in the dst-grouped list, else -1
  int* start;   // [V + 1] each query row's run in the dst-grouped list
  int* fill;    // [V]
  int* edge;    // [E] the dst-grouped list: edge ids, ascending within a run
  int* nbr;     // [E] src of edge[p]
  int* leader;  // [E] the first position of p's run with the same src
  int* next;    // [E] the next position of p's run with the same src, or -1
  int* tstart;  // [V + 1] backward: each key row's run of leaders
  int* tfill;   // [V]
  int* tlist;   // [E] backward: leaders grouped by src, ascending query row
  float* ebh;   // [E] this head's edge bias (0 without one)
  float* sc;    // [E] per leader: the score; after the backward's rows, g_s
  float* alpha; // [E] backward, per leader
  float* ga;    // [E] backward, per leader: g_alpha
  float* buf0;  // [V, dh] k's head slice, then (backward) q's
  float* buf1;  // [V, dh] v's head slice, then (backward) the cotangent's
};

__host__ __device__ inline int words_before_bufs(int V, int E) {
  const int words = 13 * E + 4 * V + 2;
  return (words + 3) / 4 * 4;
}

__host__ __device__ inline size_t smem_bytes(int V, int E, int dh) {
  return sizeof(float) * ((size_t)words_before_bufs(V, E) + 2 * (size_t)V * dh);
}

__device__ inline Bin carve(void* base, int V, int E, int dh) {
  Bin s;
  int* w = static_cast<int*>(base);
  s.src = w;          w += E;
  s.dst = w;          w += E;
  s.pos = w;          w += E;
  s.start = w;        w += V + 1;
  s.fill = w;         w += V;
  s.edge = w;         w += E;
  s.nbr = w;          w += E;
  s.leader = w;       w += E;
  s.next = w;         w += E;
  s.tstart = w;       w += V + 1;
  s.tfill = w;        w += V;
  s.tlist = w;        w += E;
  float* f = reinterpret_cast<float*>(w);
  s.ebh = f;          f += E;
  s.sc = f;           f += E;
  s.alpha = f;        f += E;
  s.ga = f;
  float* bufs = static_cast<float*>(base) + words_before_bufs(V, E);
  s.buf0 = bufs;
  s.buf1 = bufs + (size_t)V * dh;
  return s;
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

// Lanes a query row's group spans: dh / 4 rounded up to a power of two, at
// most a warp.
__device__ inline int group_size(int nq) {
  int g = 1;
  while (g < nq && g < 32) g <<= 1;
  return g;
}

// Sum over a group by xor shuffles: every lane ends with the same bits, since
// each step adds the same two values on both lanes of a pair.
__device__ inline float group_sum(float x, unsigned mask, int gsz) {
  for (int off = gsz >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(mask, x, off, gsz);
  return x;
}

// Inclusive scan of a[0, n) in place, by warp 0; the caller syncs after.
__device__ void warp_scan(int* a, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  int total = 0;
  for (int i = lo; i < hi; ++i) total += a[i];
  int incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  int run = incl - total;
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    a[i] = run;
  }
}

// Insertion sort of a short run a[lo, hi) (a node's in- or out-degree).
__device__ inline void sort_run(int* a, int lo, int hi) {
  for (int p = lo + 1; p < hi; ++p) {
    const int key = a[p];
    int r = p - 1;
    while (r >= lo && a[r] > key) {
      a[r + 1] = a[r];
      --r;
    }
    a[r + 1] = key;
  }
}

// The bin's live edges grouped by dst, each src's edges linked, and (with
// kBwd) the pairs grouped by src.
template <bool kBwd>
__device__ void build_bin(const Args& a, const Bin& s, int b) {
  const int tid = threadIdx.x, nt = blockDim.x, V = a.V, E = a.E;
  const size_t base = (size_t)b * E;
  for (int i = tid; i <= V; i += nt) {
    s.start[i] = 0;
    s.tstart[i] = 0;
  }
  for (int e = tid; e < E; e += nt) {
    const int j = a.src[base + e], i = a.dst[base + e];
    const bool live = a.emask[base + e] != 0 && j >= 0 && j < V && i >= 0 && i < V;
    s.src[e] = j;
    s.dst[e] = live ? i : -1;
    s.pos[e] = -1;
  }
  __syncthreads();
  for (int e = tid; e < E; e += nt)
    if (s.dst[e] >= 0) atomicAdd(&s.start[s.dst[e] + 1], 1);
  __syncthreads();
  warp_scan(s.start, V + 1);
  __syncthreads();
  for (int i = tid; i < V; i += nt) s.fill[i] = s.start[i];
  __syncthreads();
  for (int e = tid; e < E; e += nt)
    if (s.dst[e] >= 0) s.edge[atomicAdd(&s.fill[s.dst[e]], 1)] = e;
  __syncthreads();
  // one thread a query row: its run in edge order, then each src's edges
  // linked from the first (the pair's leader)
  for (int i = tid; i < V; i += nt) {
    const int lo = s.start[i], hi = s.start[i + 1];
    sort_run(s.edge, lo, hi);
    for (int p = lo; p < hi; ++p) {
      const int e = s.edge[p], j = s.src[e];
      s.nbr[p] = j;
      s.pos[e] = p;
      s.next[p] = -1;
      s.leader[p] = p;
      for (int r = lo; r < p; ++r) {
        if (s.nbr[r] == j) {
          s.leader[p] = r;
          int t = r;
          while (s.next[t] >= 0) t = s.next[t];
          s.next[t] = p;
          break;
        }
      }
    }
  }
  __syncthreads();
  if constexpr (kBwd) {
    const int live = s.start[V];
    for (int p = tid; p < live; p += nt)
      if (s.leader[p] == p) atomicAdd(&s.tstart[s.nbr[p] + 1], 1);
    __syncthreads();
    warp_scan(s.tstart, V + 1);
    __syncthreads();
    for (int j = tid; j < V; j += nt) s.tfill[j] = s.tstart[j];
    __syncthreads();
    for (int p = tid; p < live; p += nt)
      if (s.leader[p] == p) s.tlist[atomicAdd(&s.tfill[s.nbr[p]], 1)] = p;
    __syncthreads();
    // positions ascend with the query row, so a sorted run is in row order
    for (int j = tid; j < V; j += nt) sort_run(s.tlist, s.tstart[j], s.tstart[j + 1]);
    __syncthreads();
  }
}

// Head h's [V, dh] slice of x [B, V, H * dh] into buf, 16 bytes a thread.
__device__ void stage(const float* x, float* buf, const Args& a, int b, int h) {
  const int nq = a.dh / 4;
  float4* to = reinterpret_cast<float4*>(buf);
  for (int idx = threadIdx.x; idx < a.V * nq; idx += blockDim.x) {
    const int r = idx / nq, c = idx - r * nq;
    const size_t row = ((size_t)b * a.V + r) * a.H * a.dh + (size_t)h * a.dh;
    to[idx] = __ldg(reinterpret_cast<const float4*>(x + row) + c);
  }
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

__device__ inline Group row_group(int dh) { return lane_group(dh, group_size(dh / 4)); }

// The query-row pass: scores, softmax and combine (forward), or g_alpha,
// g_s and g_q (backward, with alpha and g_s left per leader in shared
// memory). buf0 holds k's head slice, buf1 v's.
template <bool kBwd>
__device__ void rows(const Args& a, const Bin& s, int b, int h) {
  const Group g = row_group(a.dh);
  const float4* kb = reinterpret_cast<const float4*>(s.buf0);
  const float4* vb = reinterpret_cast<const float4*>(s.buf1);
  const bool bias = a.eb != nullptr;
  for (int i = g.index; i < a.V; i += g.count) {
    const size_t row = ((size_t)b * a.V + i) * a.H * a.dh + (size_t)h * a.dh;
    float4 qi[kMaxChunks], gi[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int col = g.lane + c * g.gsz;
      qi[c] = col < g.nq ? __ldg(reinterpret_cast<const float4*>(a.q + row) + col) : zero4();
      gi[c] = zero4();
      if constexpr (kBwd)
        if (col < g.nq) gi[c] = __ldg(reinterpret_cast<const float4*>(a.g + row) + col);
    }
    const int lo = s.start[i], hi = s.start[i + 1];
    float m = -INFINITY;
    for (int p = lo; p < hi; ++p) {
      if (s.leader[p] != p) continue;
      const int j = s.nbr[p];
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = g.lane + c * g.gsz;
        if (col < g.nq) part += dot4(qi[c], kb[j * g.nq + col]);
      }
      float sc = group_sum(part, g.mask, g.gsz) * a.scale;
      if (bias) {
        float bsum = 0.f;
        for (int t = p; t >= 0; t = s.next[t]) bsum += s.ebh[s.edge[t]];
        sc += bsum;
      }
      if (g.lane == 0) s.sc[p] = sc;
      m = fmaxf(m, sc);
    }
    __syncwarp(g.mask);
    float den = 0.f;
    for (int p = lo; p < hi; ++p)
      if (s.leader[p] == p) den += expf(s.sc[p] - m);
    den = fmaxf(den, 1e-12f);
    float4 acc[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[c] = zero4();
    if constexpr (!kBwd) {
      for (int p = lo; p < hi; ++p) {
        if (s.leader[p] != p) continue;
        const float al = expf(s.sc[p] - m) / den;
        const int j = s.nbr[p];
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int col = g.lane + c * g.gsz;
          if (col < g.nq) acc[c] = fma4(al, vb[j * g.nq + col], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = g.lane + c * g.gsz;
        if (col < g.nq) reinterpret_cast<float4*>(a.out + row)[col] = acc[c];
      }
    } else {
      float tsum = 0.f;
      for (int p = lo; p < hi; ++p) {
        if (s.leader[p] != p) continue;
        const float al = expf(s.sc[p] - m) / den;
        const int j = s.nbr[p];
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int col = g.lane + c * g.gsz;
          if (col < g.nq) part += dot4(gi[c], vb[j * g.nq + col]);
        }
        const float ga = group_sum(part, g.mask, g.gsz);
        if (g.lane == 0) {
          s.alpha[p] = al;
          s.ga[p] = ga;
        }
        tsum += al * ga;
      }
      __syncwarp(g.mask);
      for (int p = lo; p < hi; ++p) {
        if (s.leader[p] != p) continue;
        const float al = s.alpha[p];
        const float gs = al * s.ga[p] - al * tsum;
        if (g.lane == 0) s.sc[p] = gs;
        const int j = s.nbr[p];
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int col = g.lane + c * g.gsz;
          if (col < g.nq) acc[c] = fma4(gs, kb[j * g.nq + col], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = g.lane + c * g.gsz;
        if (col < g.nq) reinterpret_cast<float4*>(a.gq + row)[col] = scale4(a.scale, acc[c]);
      }
    }
  }
}

// The backward's key-row pass: g_v and g_k from the pairs grouped by src, in
// ascending query row; then g_eb. buf0 holds q's head slice, buf1 the
// cotangent's; alpha and g_s (in sc) are complete for every leader.
__device__ void columns(const Args& a, const Bin& s, int b, int h) {
  const Group g = row_group(a.dh);
  const float4* qb = reinterpret_cast<const float4*>(s.buf0);
  const float4* gb = reinterpret_cast<const float4*>(s.buf1);
  for (int j = g.index; j < a.V; j += g.count) {
    const size_t row = ((size_t)b * a.V + j) * a.H * a.dh + (size_t)h * a.dh;
    float4 accv[kMaxChunks], acck[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) accv[c] = acck[c] = zero4();
    for (int t = s.tstart[j]; t < s.tstart[j + 1]; ++t) {
      const int p = s.tlist[t], i = s.dst[s.edge[p]];
      const float al = s.alpha[p], gs = s.sc[p];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = g.lane + c * g.gsz;
        if (col < g.nq) {
          accv[c] = fma4(al, gb[i * g.nq + col], accv[c]);
          acck[c] = fma4(gs, qb[i * g.nq + col], acck[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int col = g.lane + c * g.gsz;
      if (col < g.nq) {
        reinterpret_cast<float4*>(a.gv + row)[col] = accv[c];
        reinterpret_cast<float4*>(a.gk + row)[col] = scale4(a.scale, acck[c]);
      }
    }
  }
  if (a.geb != nullptr) {
    float* geb = a.geb + ((size_t)b * a.H + h) * a.E;
    for (int e = threadIdx.x; e < a.E; e += blockDim.x) {
      const int p = s.pos[e];
      geb[e] = p >= 0 ? s.sc[s.leader[p]] : 0.f;
    }
  }
}

template <bool kBwd>
__device__ void head(const Args& a, const Bin& s, int b, int h) {
  stage(a.k, s.buf0, a, b, h);
  stage(a.v, s.buf1, a, b, h);
  for (int e = threadIdx.x; e < a.E; e += blockDim.x)
    s.ebh[e] = a.eb != nullptr ? a.eb[((size_t)b * a.H + h) * a.E + e] : 0.f;
  __syncthreads();
  rows<kBwd>(a, s, b, h);
  __syncthreads();
  if constexpr (kBwd) {
    stage(a.q, s.buf0, a, b, h);
    stage(a.g, s.buf1, a, b, h);
    __syncthreads();
    columns(a, s, b, h);
    __syncthreads();
  }
}

// Rows 12-13: block (b, h).
template <bool kBwd>
__global__ void __launch_bounds__(kThreads) attn_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Bin s = carve(smem, a.V, a.E, a.dh);
  build_bin<kBwd>(a, s, blockIdx.x);
  head<kBwd>(a, s, blockIdx.x, blockIdx.y);
}

template <bool kBwd>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.V, a.E, a.dh);
  static uint64_t configured = 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem((const void*)attn_kernel<kBwd>, kMaxSmem, configured);
    if (err != cudaSuccess) return err;
  }
  attn_kernel<kBwd><<<dim3(a.B, a.H), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool misaligned(const Args& a) {
  const uintptr_t vecs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.g |
                         (uintptr_t)a.out | (uintptr_t)a.gq | (uintptr_t)a.gk | (uintptr_t)a.gv;
  return vecs % 16 != 0;
}

bool bad_head(const Args& a) {
  return a.B < 0 || a.V <= 0 || a.E <= 0 || a.H <= 0 || a.dh <= 0 || a.dh % 4 != 0 || a.dh > kMaxDh;
}

bool bad_shape(const Args& a) {
  return bad_head(a) || smem_bytes(a.V, a.E, a.dh) > (size_t)kMaxSmem || misaligned(a);
}

cudaError_t run(const Args& a, bool bwd, void* stream) {
  if (bad_shape(a)) return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bwd ? launch<true>(a, st) : launch<false>(a, st);
}

// ---- rows 10-11: a lane group per (query or key row, head) -----------------

constexpr int kListThreads = 128;
constexpr int kWarps = kListThreads / 32;
// Blocks an SM must hold at kC vectors a lane: a cap of 128 registers a
// thread (255 at 4 vectors), which keeps the packed lipo batch's 512 blocks
// of either pass in one wave on 132 SMs.
template <int kC>
constexpr int kMinBlocks = kC == 4 ? 2 : 4;

// Shared memory of one block of rows 10-11: the bin's live edges whose dst
// (query pass) or src (key pass) is one of the block's rows.
struct List {
  int* e;     // [E] edge ids, ascending
  int* dst;   // [E]
  int* src;   // [E]
  int* nxt;   // [E] the next entry of the same (dst, src) pair, or -1
  int* lead;  // [E] 1 on a pair's first entry (its leader), else 0
  int* ord;   // [E] key pass: the leaders sorted by (src, dst)
  int* misc;  // [kWarps + 1] the warps' counts of a gather step, then the leaders
};

__host__ __device__ inline size_t list_smem_bytes(int E) {
  return sizeof(int) * (6 * (size_t)E + kWarps + 1);
}

__device__ inline List carve_list(int* w, int E) {
  List l;
  l.e = w;     w += E;
  l.dst = w;   w += E;
  l.src = w;   w += E;
  l.nxt = w;   w += E;
  l.lead = w;  w += E;
  l.ord = w;   w += E;
  l.misc = w;
  return l;
}

// Lanes a (row, head) slot of rows 10-11 spans: its dh / 4 16-byte vectors
// at up to kVecs a lane, rounded up to a power of two, at most a warp (8
// lanes at dh = 64). Fewer lanes a slot repeat a row's scalar work (the walk
// of its pairs, the softmax) on fewer lanes.
constexpr int kVecs = 2;

__host__ __device__ inline int list_group_size(int dh) {
  int g = 1;
  while (g * kVecs < dh / 4 && g < 32) g <<= 1;
  return g;
}

__device__ inline Group list_group(int dh) { return lane_group(dh, list_group_size(dh)); }

// (row, head) slots a block of rows 10-11 takes, its blocks per bin, and
// the 16-byte vectors of a head row each lane holds (1, 2 or 4 at most).
__host__ __device__ inline int slots_per_block(int dh) { return kListThreads / list_group_size(dh); }

__host__ __device__ inline int chunks_per_bin(int V, int H, int dh) {
  const int per = slots_per_block(dh);
  return (int)(((long long)V * H + per - 1) / per);
}

__host__ __device__ inline int vectors_per_lane(int dh) {
  const int gsz = list_group_size(dh), per = (dh / 4 + gsz - 1) / gsz;
  return per == 1 ? 1 : per == 2 ? 2 : 4;
}

// The live edges of bin b whose dst (kByDst) or src lies in [lo, hi], in
// ascending edge id, each pair's edges linked from its leader. With `dead`
// (the bin's g_eb), zeroes it on every lane that is not live. Returns the
// list's length; the leaders' count is left in misc[kWarps].
template <bool kByDst>
__device__ int gather_edges(const Args& a, const List& l, int b, int lo, int hi, float* dead) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t base = (size_t)b * a.E;
  if (tid == 0) l.misc[kWarps] = 0;
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
  int n = 0;
  for (int e0 = 0; e0 < a.E; e0 += kListThreads) {
    const int e = e0 + tid;
    int i2 = -1, j2 = -1;
    unsigned char m2 = 0;
    read(e + kListThreads, i2, j2, m2);
    const bool live = e < a.E && m != 0 && j >= 0 && j < a.V && i >= 0 && i < a.V;
    if (dead != nullptr && e < a.E && !live)
      for (int h = 0; h < a.H; ++h) dead[(size_t)h * a.E + e] = 0.f;
    const int key = kByDst ? i : j;
    const bool hit = live && key >= lo && key <= hi;
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) l.misc[warp] = __popc(bits);
    __syncthreads();
    int at = n;
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) at = n;
      n += l.misc[w];
    }
    if (hit) {
      const int p = at + __popc(bits & ((1u << lane) - 1u));
      l.e[p] = e;
      l.dst[p] = i;
      l.src[p] = j;
      l.nxt[p] = -1;
    }
    __syncthreads();
    i = i2;
    j = j2;
    m = m2;
  }
  for (int p = tid; p < n; p += kListThreads) {
    int lead = 1;
    for (int r = p - 1; r >= 0; --r) {
      if (l.dst[r] == l.dst[p] && l.src[r] == l.src[p]) {
        l.nxt[r] = p;
        lead = 0;
        break;
      }
    }
    l.lead[p] = lead;
    if (lead) atomicAdd(&l.misc[kWarps], 1);
  }
  __syncthreads();
  return n;
}

// Offset of head h's slice of row r of bin b in a [B, V, H * dh] operand.
__device__ inline size_t head_row(const Args& a, int b, int r, int h) {
  return ((size_t)b * a.V + r) * a.H * a.dh + (size_t)h * a.dh;
}

// A lane's kC vectors of a head slice (zero past the slice).
template <int kC>
__device__ inline void load_slice(float4 (&x)[kC], const float* row, const Group& g) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = g.lane + c * g.gsz;
    x[c] = col < g.nq ? __ldg(reinterpret_cast<const float4*>(row) + col) : zero4();
  }
}

template <int kC>
__device__ inline void store_slice(float* row, const float4 (&x)[kC], float s, const Group& g) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = g.lane + c * g.gsz;
    if (col < g.nq) reinterpret_cast<float4*>(row)[col] = scale4(s, x[c]);
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

// The first list position after p that is a pair's leader with the given
// dst (n if none).
__device__ inline int next_pair(const List& l, int n, int dst, int p) {
  while (++p < n && !(l.dst[p] == dst && l.lead[p])) {
  }
  return min(p, n);
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

template <int kC>
__device__ inline void fetch_pair(Pair<kC>& x, const Args& a, const List& l, const float* ebh, int b,
                                  int h, int p, const Group& g) {
  const size_t jrow = head_row(a, b, l.src[p], h);
  load_slice(x.k, a.k + jrow, g);
  load_slice(x.v, a.v + jrow, g);
  x.eb = ebh != nullptr ? __ldg(ebh + l.e[p]) : 0.f;
}

// The pair's score: q_i . k_j / sqrt(dh) plus the bias of its edges, in
// ascending edge id.
template <int kC>
__device__ inline float pair_score(const Args& a, const List& l, const float* ebh, const float4 (&qi)[kC],
                                   const Pair<kC>& x, int p, const Group& g) {
  float bias = x.eb;
  if (ebh != nullptr)
    for (int t = l.nxt[p]; t >= 0; t = l.nxt[t]) bias += __ldg(ebh + l.e[t]);
  return group_dot(qi, x.k, g) * a.scale + bias;
}

// Row 11's scratch, written by its query pass for its key pass: each pair's
// score and g_alpha at its leader edge ([B, H, E] each), and each query
// slot's softmax max, sum and D_i = sum_j alpha g_alpha ([B, H, V] each).
struct Scratch {
  float *score, *galpha, *max, *sum, *dsum;
};

__device__ inline Scratch carve_scratch(float* w, const Args& a) {
  const size_t lanes = (size_t)a.B * a.H * a.E, rows = (size_t)a.B * a.H * a.V;
  return {w, w + lanes, w + 2 * lanes, w + 2 * lanes + rows, w + 2 * lanes + 2 * rows};
}

// Row 10 (forward: out) and row 11's query pass (g_q and the scratch), a
// group per (query row, head).
template <bool kBwd, int kC>
__global__ void __launch_bounds__(kListThreads, kMinBlocks<kC>)
    attn_rows_kernel(const Args a, float* scratch) {
  constexpr int kB = kBatch<kC>;
  extern __shared__ int list_smem[];
  const List l = carve_list(list_smem, a.E);
  const Group g = list_group(a.dh);
  const int slots = a.V * a.H, chunks = chunks_per_bin(a.V, a.H, a.dh);
  const int b = blockIdx.x / chunks, first = blockIdx.x % chunks * g.count;
  const int last = min(first + g.count, slots) - 1, slot = first + g.index;
  const int i = min(slot, last) / a.H, h = min(slot, last) % a.H;
  const size_t hb = ((size_t)b * a.H + h) * a.E, row = head_row(a, b, i, h);
  float4 qi[kC], gi[kC], acc[kC], ksum[kC];
  load_slice(qi, a.q + row, g);  // in flight during the gather
  if constexpr (kBwd) load_slice(gi, a.g + row, g);
  float* dead = kBwd && a.geb != nullptr && first == 0 ? a.geb + (size_t)b * a.H * a.E : nullptr;
  const int n = gather_edges<true>(a, l, b, first / a.H, last / a.H, dead);
  if (slot > last) return;
  const float* ebh = a.eb != nullptr ? a.eb + hb : nullptr;
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = ksum[c] = zero4();
  // the online softmax: max m, sum den and, rescaled when m rises, the
  // combine (forward), or the sums of exp * g_alpha, of exp * g_alpha * k_j
  // (in acc) and of exp * k_j (in ksum) (backward)
  float m = -INFINITY, den = 0.f, tsum = 0.f;
  Scratch sc_out{};
  if constexpr (kBwd) sc_out = carve_scratch(scratch, a);
  for (int p = -1; p < n;) {
    int pos[kB];
    Pair<kC> x[kB];
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      pos[t] = p = next_pair(l, n, i, p);
      if (p < n) fetch_pair(x[t], a, l, ebh, b, h, p, g);
    }
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      if (pos[t] >= n) break;
      const float sc = pair_score(a, l, ebh, qi, x[t], pos[t], g);
      const float mx = fmaxf(m, sc), cor = expf(m - mx), w = expf(sc - mx);
      m = mx;
      den = fmaf(den, cor, w);
      if constexpr (kBwd) {
        const float ga = group_dot(gi, x[t].v, g);
        tsum = fmaf(tsum, cor, w * ga);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc[c] = fma4(w * ga, x[t].k[c], scale4(cor, acc[c]));
          ksum[c] = fma4(w, x[t].k[c], scale4(cor, ksum[c]));
        }
        if (g.lane == 0) {
          sc_out.score[hb + l.e[pos[t]]] = sc;
          sc_out.galpha[hb + l.e[pos[t]]] = ga;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = fma4(w, x[t].v[c], scale4(cor, acc[c]));
      }
    }
  }
  den = fmaxf(den, 1e-12f);
  if constexpr (!kBwd) {
    store_slice(a.out + row, acc, 1.f / den, g);
  } else {
    // g_q = sum_j g_s k_j / sqrt(dh) with g_s = alpha g_alpha - alpha D_i:
    // (acc - D_i ksum) / den / sqrt(dh)
    const float dsum = tsum / den;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = fma4(-dsum, ksum[c], acc[c]);
    store_slice(a.gq + row, acc, a.scale / den, g);
    if (g.lane == 0) {
      const size_t at = ((size_t)b * a.H + h) * a.V + i;
      sc_out.max[at] = m;
      sc_out.sum[at] = den;
      sc_out.dsum[at] = dsum;
    }
  }
}

// Row 11's key pass: g_v, g_k and g_eb, a group per (key row, head), over
// the pairs of its key row in ascending query row. Each pair's alpha and g_s
// come from its score and g_alpha and its query slot's softmax, all left by
// the query pass.
template <int kC>
__global__ void __launch_bounds__(kListThreads, kMinBlocks<kC>)
    attn_cols_kernel(const Args a, float* scratch) {
  constexpr int kB = kBatch<kC>;
  extern __shared__ int list_smem[];
  const List l = carve_list(list_smem, a.E);
  const Group g = list_group(a.dh);
  const int slots = a.V * a.H, chunks = chunks_per_bin(a.V, a.H, a.dh);
  const int b = blockIdx.x / chunks, first = blockIdx.x % chunks * g.count;
  const int last = min(first + g.count, slots) - 1, slot = first + g.index;
  const int n = gather_edges<false>(a, l, b, first / a.H, last / a.H, nullptr);
  for (int p = threadIdx.x; p < n; p += kListThreads) {
    if (!l.lead[p]) continue;
    int rank = 0;
    for (int r = 0; r < n; ++r)
      rank += l.lead[r] && (l.src[r] < l.src[p] || (l.src[r] == l.src[p] && l.dst[r] < l.dst[p]));
    l.ord[rank] = p;
  }
  __syncthreads();
  if (slot > last) return;
  const int j = slot / a.H, h = slot % a.H, pairs = l.misc[kWarps];
  const size_t hb = ((size_t)b * a.H + h) * a.E, hv = ((size_t)b * a.H + h) * a.V;
  const Scratch in = carve_scratch(scratch, a);
  int r = 0;
  while (r < pairs && l.src[l.ord[r]] < j) ++r;
  float4 accv[kC], acck[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) accv[c] = acck[c] = zero4();
  for (; r < pairs && l.src[l.ord[r]] == j; r += kB) {
    float sc[kB], ga[kB], mx[kB], den[kB], ds[kB];
    float4 gx[kB][kC], qx[kB][kC];
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      const int p = l.ord[min(r + t, pairs - 1)];
      if (r + t < pairs && l.src[p] == j) {
        const size_t irow = head_row(a, b, l.dst[p], h), at = hv + l.dst[p];
        sc[t] = in.score[hb + l.e[p]];
        ga[t] = in.galpha[hb + l.e[p]];
        mx[t] = in.max[at];
        den[t] = in.sum[at];
        ds[t] = in.dsum[at];
        load_slice(gx[t], a.g + irow, g);
        load_slice(qx[t], a.q + irow, g);
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
      const float al = expf(sc[t] - mx[t]) / den[t];
      const float gs = al * ga[t] - al * ds[t];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        accv[c] = fma4(al, gx[t][c], accv[c]);
        acck[c] = fma4(gs, qx[t][c], acck[c]);
      }
      if (a.geb != nullptr && g.lane == 0 && r + t < pairs && l.src[l.ord[r + t]] == j)
        for (int e = l.ord[r + t]; e >= 0; e = l.nxt[e]) a.geb[hb + l.e[e]] = gs;
    }
  }
  const size_t row = head_row(a, b, j, h);
  store_slice(a.gv + row, accv, 1.f, g);
  store_slice(a.gk + row, acck, a.scale, g);
}

using ListKernel = void (*)(const Args, float*);

cudaError_t launch_list(ListKernel kernel, uint64_t& configured, const Args& a, float* scratch,
                        cudaStream_t stream) {
  const size_t smem = list_smem_bytes(a.E);
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem((const void*)kernel, kMaxSmem, configured);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.B * chunks_per_bin(a.V, a.H, a.dh), kListThreads, smem, stream>>>(a, scratch);
  return cudaGetLastError();
}

template <int kC>
cudaError_t run_list_at(const Args& a, float* scratch, bool bwd, cudaStream_t st) {
  static uint64_t fwd_configured = 0, rows_configured = 0, cols_configured = 0;
  if (!bwd) return launch_list(attn_rows_kernel<false, kC>, fwd_configured, a, nullptr, st);
  const cudaError_t err = launch_list(attn_rows_kernel<true, kC>, rows_configured, a, scratch, st);
  if (err != cudaSuccess) return err;
  return launch_list(attn_cols_kernel<kC>, cols_configured, a, scratch, st);
}

bool bad_list_shape(const Args& a) {
  return bad_head(a) || list_smem_bytes(a.E) > (size_t)kMaxSmem || misaligned(a) ||
         (long long)a.V * a.H > INT32_MAX ||
         (long long)a.B * chunks_per_bin(a.V, a.H, a.dh) > INT32_MAX;
}

cudaError_t run_list(const Args& a, float* scratch, bool bwd, void* stream) {
  if (bad_list_shape(a) || (bwd && scratch == nullptr)) return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vectors_per_lane(a.dh)) {
    case 1: return run_list_at<1>(a, scratch, bwd, st);
    case 2: return run_list_at<2>(a, scratch, bwd, st);
    default: return run_list_at<4>(a, scratch, bwd, st);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes a block of rows 12-13 needs at these shapes, a block
// of rows 10-11 at E edge lanes, and the most a block may have; the wrappers
// raise, naming the shape, above the latter.
long long dense_attention_smem_bytes(int V, int E, int dh) { return (long long)smem_bytes(V, E, dh); }

long long dense_attention_v1_smem_bytes(int E) { return (long long)list_smem_bytes(E); }

int dense_attention_max_smem() { return kMaxSmem; }

int dense_attention_max_dh() { return kMaxDh; }

// Rows 12 (forward) and 13 (recompute backward), a block per (bin, head).
// The forward: q, k, v, out [B, V, H * dh] f32; eb [B, H, E] f32 or null;
// src, dst [B, E] int32; emask [B, E] bytes. Device pointers of contiguous
// arrays, the float ones 16-byte aligned; dh a multiple of 4. The stream is
// a cudaStream_t. Returns the cudaError_t of the launch (0 on success).
int dense_attention_fwd_f32(const float* q, const float* k, const float* v, const float* eb,
                            const int* src, const int* dst, const unsigned char* emask, float* out,
                            int B, int V, int E, int H, int dh, float scale, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, nullptr, out, nullptr, nullptr, nullptr, nullptr,
               B, V, E, H, dh, scale};
  return (int)run(a, false, stream);
}

// The recompute backward: g (the cotangent of out) and g_q, g_k, g_v
// [B, V, H * dh]; g_eb [B, H, E], written when eb is not null. The rest as
// for the forward.
int dense_attention_bwd_f32(const float* q, const float* k, const float* v, const float* eb,
                            const int* src, const int* dst, const unsigned char* emask,
                            const float* g, float* gq, float* gk, float* gv, float* geb, int B,
                            int V, int E, int H, int dh, float scale, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, g, nullptr, gq, gk, gv, eb != nullptr ? geb : nullptr,
               B, V, E, H, dh, scale};
  return (int)run(a, true, stream);
}

// Rows 10 and 11, a lane group per (row, head): the same arguments as rows
// 12-13; the backward also takes scratch of 2 * B * H * E + 3 * B * H * V
// floats, written by its query pass for its key pass (see Scratch). The
// backward is two launches on the stream.
int dense_attention_v1_fwd_f32(const float* q, const float* k, const float* v, const float* eb,
                               const int* src, const int* dst, const unsigned char* emask, float* out,
                               int B, int V, int E, int H, int dh, float scale, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, nullptr, out, nullptr, nullptr, nullptr, nullptr,
               B, V, E, H, dh, scale};
  return (int)run_list(a, nullptr, false, stream);
}

int dense_attention_v1_bwd_f32(const float* q, const float* k, const float* v, const float* eb,
                               const int* src, const int* dst, const unsigned char* emask,
                               const float* g, float* gq, float* gk, float* gv, float* geb,
                               float* scratch, int B, int V, int E, int H, int dh, float scale,
                               void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, g, nullptr, gq, gk, gv, eb != nullptr ? geb : nullptr,
               B, V, E, H, dh, scale};
  return (int)run_list(a, scratch, true, stream);
}

const char* dense_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
