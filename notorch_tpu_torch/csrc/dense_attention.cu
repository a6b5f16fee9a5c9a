// The dense graph-attention core, forward and recompute backward, in CUDA C++
// for sm_90a.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/dense_attention.py:
//   - _attn_kernel / fused_dense_attention_fwd (v1, heads looped in a block)
//     and _attn_kernel_v2 / fused_dense_attention_fwd_v2 (v2, head in the
//     grid): the forward body below, launched by attn_kernel<false, ...>;
//   - _attn_bwd_kernel / fused_dense_attention_bwd and _attn_bwd_kernel_v2 /
//     fused_dense_attention_bwd_v2: the recompute backward body, launched by
//     attn_kernel<true, ...>.
// The v1 launch puts a block on a tile of bins (bins_per_tile, as
// fit_attn_tile cuts it) and loops over the bins and the heads inside; the v2
// launch puts a block on each (bin, head). Both read and write JAX's layouts:
// q, k, v, out, the cotangent g and g_q, g_k, g_v [B, V, H * dh]; eb and g_eb
// [B, H, E]; src, dst [B, E] int32; edge_mask [B, E] bytes (0 = padding).
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
// Design. The TPU kernels build the one-hot operators G and St and the
// [V, V] score tile in VMEM and run every product densely on the MXU. Here
// the mask is what it is, a sparse set of pairs: a molecule's node has a few
// bonded neighbours, so M has about as many nonzeros as the bin has real
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
// Exact f32 on CUDA cores throughout, no TF32.
//
// What bounds them on this card. Counted at this data's live pairs, the
// products are a few operations per byte moved (4 * dh per pair and head
// forward, three times that backward, against q, k, v, out rows of 4 * dh
// bytes): both bodies are bound by bytes, each input read once and each
// output written once over 3.35 TB/s (2.5 us forward at the packed lipo
// batch of 16 bins, V = 128, E = 256, H = 4, dh = 64). Counted densely, as
// the TPU's MXU runs them (4 V^2 dh a head forward), they would be bound by
// operations. What the design does about the bytes: each element of q, k, v
// and g is read from device memory once per (bin, head) block, by 16-byte
// loads that all threads issue together, and every further read hits shared
// memory. The per-block index build and its barriers are fixed costs of a
// few microseconds; the v1 launch, with its few blocks of several bins, pays
// them serially, as the TPU's v1 grid does.
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

__device__ inline Group row_group(int dh) {
  Group g;
  g.nq = dh / 4;
  g.gsz = group_size(g.nq);
  g.lane = threadIdx.x % g.gsz;
  g.index = threadIdx.x / g.gsz;
  g.count = blockDim.x / g.gsz;
  g.mask = g.gsz == 32 ? 0xffffffffu : ((1u << g.gsz) - 1u) << (threadIdx.x % 32 / g.gsz * g.gsz);
  return g;
}

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

// kHeadGrid (v2): block (b, h). Otherwise (v1): block t takes bins
// [t * tile, (t + 1) * tile) and every head of each.
template <bool kBwd, bool kHeadGrid>
__global__ void __launch_bounds__(kThreads) attn_kernel(const Args a, int tile) {
  extern __shared__ __align__(16) float smem[];
  const Bin s = carve(smem, a.V, a.E, a.dh);
  if constexpr (kHeadGrid) {
    build_bin<kBwd>(a, s, blockIdx.x);
    head<kBwd>(a, s, blockIdx.x, blockIdx.y);
  } else {
    for (int bb = 0; bb < tile; ++bb) {
      const int b = blockIdx.x * tile + bb;
      build_bin<kBwd>(a, s, b);
      for (int h = 0; h < a.H; ++h) head<kBwd>(a, s, b, h);
    }
  }
}

template <bool kBwd, bool kHeadGrid>
cudaError_t launch(const Args& a, int tile, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.V, a.E, a.dh);
  static uint64_t configured = 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        allow_smem((const void*)attn_kernel<kBwd, kHeadGrid>, kMaxSmem, configured);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid = kHeadGrid ? dim3(a.B, a.H) : dim3(a.B / tile);
  attn_kernel<kBwd, kHeadGrid><<<grid, kThreads, smem, stream>>>(a, tile);
  return cudaGetLastError();
}

bool bad_shape(const Args& a, int tile) {
  if (a.B < 0 || a.V <= 0 || a.E <= 0 || a.H <= 0 || a.dh <= 0 || a.dh % 4 != 0 || a.dh > kMaxDh)
    return true;
  if (smem_bytes(a.V, a.E, a.dh) > (size_t)kMaxSmem) return true;
  if (tile < 0 || (tile > 0 && a.B % tile != 0)) return true;
  const uintptr_t vecs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.g |
                         (uintptr_t)a.out | (uintptr_t)a.gq | (uintptr_t)a.gk | (uintptr_t)a.gv;
  return vecs % 16 != 0;
}

cudaError_t run(const Args& a, int tile, bool bwd, void* stream) {
  if (bad_shape(a, tile)) return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bwd) return tile > 0 ? launch<true, false>(a, tile, st) : launch<true, true>(a, tile, st);
  return tile > 0 ? launch<false, false>(a, tile, st) : launch<false, true>(a, tile, st);
}

}  // namespace

extern "C" {

// Shared-memory bytes a block needs at these shapes, and the most a block
// may have; the wrappers raise, naming the shape, above the latter.
long long dense_attention_smem_bytes(int V, int E, int dh) { return (long long)smem_bytes(V, E, dh); }

int dense_attention_max_smem() { return kMaxSmem; }

int dense_attention_max_dh() { return kMaxDh; }

// The forward: q, k, v, out [B, V, H * dh] f32; eb [B, H, E] f32 or null;
// src, dst [B, E] int32; emask [B, E] bytes. tile = 0: the v2 launch (a block
// per (bin, head)); tile > 0: the v1 launch (a block per tile bins, heads
// looped; B a multiple of tile). Device pointers of contiguous arrays, the
// float ones 16-byte aligned; dh a multiple of 4. The stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
int dense_attention_fwd_f32(const float* q, const float* k, const float* v, const float* eb,
                            const int* src, const int* dst, const unsigned char* emask, float* out,
                            int B, int V, int E, int H, int dh, float scale, int tile, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, nullptr, out, nullptr, nullptr, nullptr, nullptr,
               B, V, E, H, dh, scale};
  return (int)run(a, tile, false, stream);
}

// The recompute backward: g (the cotangent of out) and g_q, g_k, g_v
// [B, V, H * dh]; g_eb [B, H, E], written when eb is not null. The rest as
// for the forward.
int dense_attention_bwd_f32(const float* q, const float* k, const float* v, const float* eb,
                            const int* src, const int* dst, const unsigned char* emask,
                            const float* g, float* gq, float* gk, float* gv, float* geb, int B,
                            int V, int E, int H, int dh, float scale, int tile, void* stream) {
  const Args a{q, k, v, eb, src, dst, emask, g, nullptr, gq, gk, gv, eb != nullptr ? geb : nullptr,
               B, V, E, H, dh, scale};
  return (int)run(a, tile, true, stream);
}

const char* dense_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
