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
// of dependent device-memory round trips per block small.
//
// packed_kernel. Grid (node tile, 32-column slice of d); 1024 threads, one
// per (node of the tile, 16-byte vector of the slice).
//   1. The block counts the real slots of each node of its tile (shared-memory
//      int atomics: only the counts, which do not depend on order), scans the
//      counts into run starts (one warp), and places each slot in its node's
//      run; then the thread of each node sorts its run by slot (insertion
//      sort: a node's run is its in-degree) and swaps each slot for its edge
//      id perm[s]. The runs live in shared memory, one int per slot of the
//      budget (at most kMaxBudget).
//   2. Each thread sums the rows of its node's run, in ascending slot order,
//      for its 16-byte vector, and writes the vector once. A warp reads four
//      rows' 128-byte slices, each in one transaction; no packed [T*budget, d]
//      copy is made (the JAX package gathers one), and each real row is read
//      once per slice.
//   The order of every sum is fixed (ascending slot, as the CPU plain
//   version's index_add_ takes them), with no float atomics: two calls give
//   the same bits.
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

constexpr int kMaxTile = 128;                // nodes per packed block (tile_v <= 128)
constexpr int kSliceVecs = 8;                // 16-byte vectors per packed block's slice
constexpr int kPackedThreads = kMaxTile * kSliceVecs;  // 1024
constexpr int kMaxBudget = 49152;            // slots per tile: 192 KiB of runs
constexpr int kRowThreads = 256;
constexpr int kHeaderInts = 3 * kMaxTile + 1;  // count, start (+1), fill

__device__ inline bool slot_adds(int e, int v, int E, int tile_v) {
  return e >= 0 && e < E && v >= 0 && v < tile_v;
}

__global__ void __launch_bounds__(kPackedThreads)
    packed_kernel(const float* __restrict__ data, const int* __restrict__ perm,
                  const int* __restrict__ packed_dst, float* __restrict__ out, int E, int d,
                  int tile_v, int budget) {
  extern __shared__ int smem[];
  int* count = smem;                  // [kMaxTile]
  int* start = count + kMaxTile;      // [kMaxTile + 1]
  int* fill = start + kMaxTile + 1;   // [kMaxTile]
  int* run = fill + kMaxTile;         // [budget]
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * tile_v;
  const size_t s0 = (size_t)blockIdx.x * budget;

  // 1a. count the slots of each node
  if (tid < kMaxTile) count[tid] = 0;
  __syncthreads();
  for (int s = tid; s < budget; s += kPackedThreads) {
    const int v = packed_dst[s0 + s] - v0;
    if (slot_adds(perm[s0 + s], v, E, tile_v)) atomicAdd(&count[v], 1);
  }
  __syncthreads();
  // 1b. exclusive scan of the counts: warp 0, four nodes a lane
  if (tid < 32) {
    int c[4], total = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = count[4 * tid + k];
      total += c[k];
    }
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += n;
    }
    int at = incl - total;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      start[4 * tid + k] = fill[4 * tid + k] = at;
      at += c[k];
    }
    if (tid == 31) start[kMaxTile] = at;
  }
  __syncthreads();
  // 1c. place each slot in its node's run (in no particular order yet)
  for (int s = tid; s < budget; s += kPackedThreads) {
    const int v = packed_dst[s0 + s] - v0;
    if (slot_adds(perm[s0 + s], v, E, tile_v)) run[atomicAdd(&fill[v], 1)] = s;
  }
  __syncthreads();
  // 1d. sort each run by slot, then name each slot's edge
  if (tid < tile_v) {
    const int lo = start[tid], hi = start[tid + 1];
    for (int i = lo + 1; i < hi; ++i) {
      const int key = run[i];
      int j = i - 1;
      while (j >= lo && run[j] > key) {
        run[j + 1] = run[j];
        --j;
      }
      run[j + 1] = key;
    }
    for (int i = lo; i < hi; ++i) run[i] = perm[s0 + run[i]];
  }
  __syncthreads();
  // 2. one 16-byte vector of one node, summed over its run in slot order
  const int node = tid / kSliceVecs;
  const int nq = d / 4;
  const int q = blockIdx.y * kSliceVecs + tid % kSliceVecs;
  if (node >= tile_v || q >= nq) return;
  const float4* rows = reinterpret_cast<const float4*>(data);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int hi = start[node + 1];
  for (int i = start[node]; i < hi; ++i) acc = add4(acc, rows[(size_t)run[i] * nq + q]);
  reinterpret_cast<float4*>(out)[(size_t)(v0 + node) * nq + q] = acc;
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
  const int nq = d / 4;
  if (nq == 0) return (int)cudaSuccess;
  const int smem = (kHeaderInts + budget) * (int)sizeof(int);
  static uint64_t configured = 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        allow_smem((const void*)packed_kernel, (kHeaderInts + kMaxBudget) * (int)sizeof(int),
                   configured);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(num_nodes / tile_v, (nq + kSliceVecs - 1) / kSliceVecs);
  packed_kernel<<<grid, kPackedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      data, perm, packed_dst, out, E, d, tile_v, budget);
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

const char* csr_segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
