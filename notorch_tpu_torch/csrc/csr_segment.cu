// The two CSR segment sums of the flat edge layout, in CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/csr_segment.py:
//   - csr_segment_sum_packed / _packed_kernel: packed_kernel below;
//   - csr_segment_sum / _kernel: rowptr_kernel below.
// The Python wrappers (notorch_tpu_torch/kernels/csr_segment.py) launch each
// once a call. Both reduce data[E, d] (f32, rows 16-byte aligned, d a
// multiple of 4) into out[num_nodes, d] and write every output row, zeros
// included.
//
// What they compute:
//   packed:  out[v] = sum of data[perm[s]] over the slots s of v's tile_v-node
//            tile (slots [tile * budget, (tile + 1) * budget)) with
//            packed_dst[s] == v; a slot with perm outside [0, E) (the -1 of
//            padding) or packed_dst outside its tile adds nothing.
//   rowptr:  out[v] = sum of data[e] for e in [row_ptr[v], row_ptr[v+1]),
//            clipped to [0, E). Every edge of the range is summed: the TPU
//            kernel's grid stops after (tile_v * max_degree) / tile_e + 2
//            chunks of a tile and drops the edges past them; this one does
//            not.
// The TPU kernels turn each chunk of slots into a one-hot [tile_v, tile_e]
// matrix and multiply it on the MXU. Here a segment sum is what it is on this
// card: a gather and an add, f32 add per element read.
//
// What bounds them: bytes. Each reads every summed row of data once (4 * d
// bytes a row) and writes out once, with one add per element read, far below
// the card's f32 rate; so the floor is those bytes (plus the int32 index
// arrays) over 3.35 TB/s. At the flat lipo batch of 64 molecules (V = 2048,
// about 3,700 real edges, d = 256) that is about 6 MB, under 2 us, below a
// launch's own latency: the design keeps the reads coalesced and the number
// of dependent device-memory round trips per block small. (The packed
// kernel before this design rebuilt its tile's index in every one of its 8
// column-slice blocks, by shared-memory atomics, a scan and an insertion sort
// between five barriers, with three dependent reads of perm; PERF.md §6 has
// both times.)
//
// packed_kernel. A block per (node tile, group of kNodeWarps nodes of it), a
// warp per node; kNodeWarps * 32 threads.
//   1. The block stages its tile's slots in shared memory in one coalesced
//      read: for each slot its key, packed_dst where perm names an edge in
//      [0, E) and -1 where it does not, and, where the budget allows
//      (kStagePermMax), perm itself. One barrier.
//   2. Each warp forms its node's run with no atomics and no sort: over the
//      32-slot words of the tile, in ascending order, kScanWords at a time
//      (their key loads in flight together), __ballot_sync(key[s] == v) marks
//      the node's slots, and each marked lane writes its edge id to the
//      warp's list at its rank among the marks before it, so the list comes
//      out in ascending slot order. A key that names another tile's node
//      never equals v, so such slots add nothing.
//   3. The warp sums its node's rows: a lane owns kLaneVecs 16-byte vectors
//      of the row (all d columns between the warp's lanes, so a node's run is
//      formed once, not once a column slice; the blocks of a tile each stage
//      its index, 3 KiB at the lipo batch, from L2), reads kRowBatch rows of
//      the list at once and adds them in list order, and writes its vectors
//      once. A list that fills
//      up (a hub node) is summed and emptied as the scan goes on.
//   Dependent device-memory round trips: the index, then the rows. The order
//   of every sum is fixed (ascending slot, as the CPU plain version's
//   index_add_ takes them) with no float atomics, so two calls give the same
//   bits, and the CPU plain version's.
//
// rowptr_kernel. One warp per (node, 128-column chunk of d); each lane owns
// one 16-byte vector and walks the node's edges in ascending order, four
// loads written ahead of their adds. Edges are dst-sorted, so a node's rows
// are contiguous and its warp reads them as 512-byte runs. The longest run
// sets the time: in a flat batch it is the padding sink's, which holds every
// padding edge (358 rows in the first lipo batch), one warp's serial walk.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxTile = 128;      // nodes per packed tile (tile_v <= 128)
constexpr int kMaxBudget = 49152;  // slots per tile: 192 KiB of keys
constexpr int kNodeWarps = 4;      // nodes (a warp each) of a packed block
constexpr int kPackedThreads = kNodeWarps * 32;
constexpr int kScanWords = 4;      // 32-slot words a warp's scan takes at once
constexpr int kList = 256;         // edge ids a warp's list holds (at least 32 kScanWords)
constexpr int kRowBatch = 8;       // rows a lane reads at once
constexpr int kLaneVecs = 2;       // 16-byte vectors of a row a lane sums at once
// budgets up to which perm is staged beside the keys (else a marked lane
// reads its slot's perm from device memory)
constexpr int kStagePermMax = 24576;
constexpr int kRowThreads = 256;
// 1 builds the stage stamps (see stamp); the timing script's --stages build.
constexpr int kStages = 0;

__host__ __device__ inline size_t packed_smem_bytes(int budget, bool stage_perm) {
  return sizeof(int) * ((stage_perm ? 2 : 1) * (size_t)budget + (size_t)kNodeWarps * kList);
}

// Stage stamps of a kStages build: lane 0 of warp 0 of block 0 writes
// %globaltimer (ns) at each phase boundary of the packed kernel (stage_at:
// start, index staged, its node's run formed, its rows summed), and thread 0
// of every block takes the earliest start and the latest end (stage_span).
constexpr int kStageSlots = 4;
__device__ unsigned long long stage_at[kStageSlots];
__device__ unsigned long long stage_span[2];

__device__ inline void stamp(int stage, bool start, bool end) {
  if constexpr (kStages != 0) {
    if (threadIdx.x != 0) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (blockIdx.x == 0) stage_at[stage] = t;
    if (start) atomicMin(&stage_span[0], t);
    if (end) atomicMax(&stage_span[1], t);
  }
}

// acc[j] += the rows list[0..n) of data, vector q0 + 32 j + lane of each, in
// list order; kRowBatch rows' loads go out before their adds.
__device__ inline void sum_rows(const float4* __restrict__ rows, const int* list, int n, int nq,
                                int q0, int lane, float4 (&acc)[kLaneVecs]) {
  for (int i0 = 0; i0 < n; i0 += kRowBatch) {
    float4 x[kRowBatch][kLaneVecs];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int e = i0 + i < n ? list[i0 + i] : -1;
#pragma unroll
      for (int j = 0; j < kLaneVecs; ++j) {
        const int q = q0 + j * 32 + lane;
        x[i][j] = e >= 0 && q < nq ? rows[(size_t)e * nq + q] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i)
      if (i0 + i < n)
#pragma unroll
        for (int j = 0; j < kLaneVecs; ++j) acc[j] = add4(acc[j], x[i][j]);
  }
}

template <bool kStagePerm>
__global__ void __launch_bounds__(kPackedThreads)
    packed_kernel(const float* __restrict__ data, const int* __restrict__ perm,
                  const int* __restrict__ packed_dst, float* __restrict__ out, int E, int d,
                  int tile_v, int budget, int groups) {
  stamp(0, true, false);
  extern __shared__ int smem[];
  int* key = smem;                                    // [budget]
  int* perm_s = key + budget;                         // [budget] (kStagePerm)
  int* lists = perm_s + (kStagePerm ? budget : 0);    // [kNodeWarps][kList]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x / groups;
  const int node = blockIdx.x % groups * kNodeWarps + warp;
  const size_t s0 = (size_t)tile * budget;

  // 1. the tile's keys (and edge ids), four slots' loads in flight a thread
  for (int s = tid; s < budget; s += 4 * kPackedThreads) {
    int e[4], t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int at = s + u * kPackedThreads;
      e[u] = at < budget ? perm[s0 + at] : -1;
      t[u] = at < budget ? packed_dst[s0 + at] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int at = s + u * kPackedThreads;
      if (at < budget) {
        key[at] = e[u] >= 0 && e[u] < E ? t[u] : -1;
        if constexpr (kStagePerm) perm_s[at] = e[u];
      }
    }
  }
  __syncthreads();
  stamp(1, false, false);
  if (node >= tile_v) return;

  // 2-3. node v's run in ascending slot order, then its rows
  const int v = tile * tile_v + node;
  int* list = lists + warp * kList;
  const int nq = d / 4, words = (budget + 31) / 32;
  const float4* rows = reinterpret_cast<const float4*>(data);
  float4* o = reinterpret_cast<float4*>(out) + (size_t)v * nq;
  for (int q0 = 0; q0 < nq; q0 += 32 * kLaneVecs) {
    float4 acc[kLaneVecs];
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    int n = 0;
    for (int w0 = 0; w0 < words; w0 += kScanWords) {
      // kScanWords words at once: their key loads, then their ballots
      bool hit[kScanWords];
      unsigned bits[kScanWords];
#pragma unroll
      for (int u = 0; u < kScanWords; ++u) {
        const int s = (w0 + u) * 32 + lane;
        hit[u] = s < budget && key[s] == v;
      }
#pragma unroll
      for (int u = 0; u < kScanWords; ++u) bits[u] = __ballot_sync(0xffffffffu, hit[u]);
#pragma unroll
      for (int u = 0; u < kScanWords; ++u) {
        const int s = (w0 + u) * 32 + lane;
        if (hit[u]) list[n + __popc(bits[u] & ((1u << lane) - 1u))] = kStagePerm ? perm_s[s] : perm[s0 + s];
        n += __popc(bits[u]);
      }
      if (n > kList - 32 * kScanWords) {  // room for one more scan's marks no longer certain
        __syncwarp();
        sum_rows(rows, list, n, nq, q0, lane, acc);
        n = 0;
        __syncwarp();
      }
    }
    __syncwarp();
    if (q0 == 0) stamp(2, false, false);
    sum_rows(rows, list, n, nq, q0, lane, acc);
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) {
      const int q = q0 + j * 32 + lane;
      if (q < nq) o[q] = acc[j];
    }
    __syncwarp();  // the list is read before the next chunk's scan refills it
  }
  stamp(3, false, true);
}

__global__ void __launch_bounds__(kRowThreads)
    rowptr_kernel(const float* __restrict__ data, const int* __restrict__ row_ptr,
                  float* __restrict__ out, int E, int d, int num_nodes) {
  const int nq = d / 4;
  const int chunks = (nq + 31) / 32;
  const long long warp = ((long long)blockIdx.x * kRowThreads + threadIdx.x) / 32;
  if (warp >= (long long)num_nodes * chunks) return;
  const int v = (int)(warp / chunks);
  const int q = (int)(warp % chunks) * 32 + threadIdx.x % 32;
  if (q >= nq) return;
  const int lo = max(row_ptr[v], 0), hi = min(row_ptr[v + 1], E);
  const float4* rows = reinterpret_cast<const float4*>(data);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int e = lo;
  for (; e + 4 <= hi; e += 4) {
    const float4 x0 = rows[(size_t)e * nq + q], x1 = rows[(size_t)(e + 1) * nq + q];
    const float4 x2 = rows[(size_t)(e + 2) * nq + q], x3 = rows[(size_t)(e + 3) * nq + q];
    acc = add4(add4(add4(add4(acc, x0), x1), x2), x3);
  }
  for (; e < hi; ++e) acc = add4(acc, rows[(size_t)e * nq + q]);
  reinterpret_cast<float4*>(out)[(size_t)v * nq + q] = acc;
}

bool bad_rows(const float* data, const float* out, int E, int d) {
  return E < 0 || d < 0 || d % 4 != 0 || ((uintptr_t)data | (uintptr_t)out) % 16 != 0;
}

}  // namespace

extern "C" {

int csr_segment_max_budget() { return kMaxBudget; }

int csr_segment_max_tile() { return kMaxTile; }

// The packed sum: data[E,d], perm/packed_dst[(num_nodes / tile_v) * budget]
// int32, out[num_nodes,d]. num_nodes is a multiple of tile_v <= 128; budget
// <= kMaxBudget. Device pointers of contiguous arrays; data and out start
// 16-byte aligned. The stream is a cudaStream_t. Returns the cudaError_t of
// the launch (0 on success).
int csr_segment_sum_packed_f32(const float* data, const int* perm, const int* packed_dst,
                               float* out, int E, int d, int num_nodes, int tile_v, int budget,
                               void* stream) {
  if (bad_rows(data, out, E, d) || tile_v <= 0 || tile_v > kMaxTile || num_nodes <= 0 ||
      num_nodes % tile_v != 0 || budget < 0 || budget > kMaxBudget)
    return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  const bool stage_perm = budget <= kStagePermMax;
  const void* kernel = stage_perm ? (const void*)packed_kernel<true> : (const void*)packed_kernel<false>;
  const size_t smem = packed_smem_bytes(budget, stage_perm);
  static uint64_t configured[2] = {0, 0};
  if (smem > 48 * 1024) {
    const int most = (int)(stage_perm ? packed_smem_bytes(kStagePermMax, true)
                                      : packed_smem_bytes(kMaxBudget, false));
    const cudaError_t err = allow_smem(kernel, most, configured[stage_perm]);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (tile_v + kNodeWarps - 1) / kNodeWarps;
  const long long blocks = (long long)(num_nodes / tile_v) * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage_perm)
    packed_kernel<true><<<(unsigned)blocks, kPackedThreads, smem, s>>>(
        data, perm, packed_dst, out, E, d, tile_v, budget, groups);
  else
    packed_kernel<false><<<(unsigned)blocks, kPackedThreads, smem, s>>>(
        data, perm, packed_dst, out, E, d, tile_v, budget, groups);
  return (int)cudaGetLastError();
}

// The row-pointer sum: data[E,d], row_ptr[num_nodes + 1] int32 (nondecreasing),
// out[num_nodes,d]; the pointers and the result as for the packed sum.
int csr_segment_sum_rowptr_f32(const float* data, const int* row_ptr, float* out, int E, int d,
                               int num_nodes, void* stream) {
  if (bad_rows(data, out, E, d) || num_nodes < 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)num_nodes * ((d / 4 + 31) / 32);
  if (warps == 0) return (int)cudaSuccess;
  const long long blocks = (warps * 32 + kRowThreads - 1) / kRowThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rowptr_kernel<<<(unsigned)blocks, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, row_ptr, out, E, d, num_nodes);
  return (int)cudaGetLastError();
}

// The stage stamps of a build with kStages = 1 (see stamp): 1 if this build
// stamps. `reset` clears them before a launch; `read` copies out the
// kStageSlots stamps of block 0's first warp, then the earliest block start
// and the latest block end, in ns of %globaltimer. Both return the
// cudaError_t.
int csr_segment_stages_built() { return kStages; }

int csr_segment_stages_reset() {
  const unsigned long long at[kStageSlots] = {}, span[2] = {~0ull, 0};
  const cudaError_t err = cudaMemcpyToSymbol(stage_at, at, sizeof at);
  return (int)(err != cudaSuccess ? err : cudaMemcpyToSymbol(stage_span, span, sizeof span));
}

int csr_segment_stages_read(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, stage_at, sizeof stage_at);
  return (int)(err != cudaSuccess
                   ? err
                   : cudaMemcpyFromSymbol(out + kStageSlots, stage_span, sizeof stage_span));
}

const char* csr_segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
