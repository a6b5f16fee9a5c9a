// The two CSR segment sums of the flat edge layout, in CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/csr_segment.py:
//   - csr_segment_sum_packed / _packed_kernel: packed_kernel below;
//   - csr_segment_sum / _kernel: rowptr_kernel below.
// The Python wrappers (notorch_tpu_torch/kernels/csr_segment.py) launch each
// once a call. Both reduce data[E, d] (f32) into out[num_nodes, d] and write
// every output row, zeros included. The packed kernel reads rows in 16-byte
// vectors (d a multiple of 4, data and out 16-byte aligned); the row-pointer
// kernel takes any d >= 1 and any alignment, and reads its rows either in
// edge order or through an order array (the stable sort of a segment sum's
// ids: notorch_tpu_torch/nn/ops.py segment_sum and take route every sum of
// the port's glue on the card through it).
//
// What they compute:
//   packed:  out[v] = sum of data[perm[s]] over the slots s of v's tile_v-node
//            tile (slots [tile * budget, (tile + 1) * budget)) with
//            packed_dst[s] == v; a slot with perm outside [0, E) (the -1 of
//            padding) or packed_dst outside its tile adds nothing.
//   rowptr:  out[v] = sum of data[e] (data[order[e]] given an order) for e in
//            [row_ptr[v], row_ptr[v+1]), clipped to [0, E), in ascending e.
//            Every edge of the range is summed: the TPU kernel's grid stops
//            after (tile_v * max_degree) / tile_e + 2 chunks of a tile and
//            drops the edges past them; this one does not.
// Row 8b, the row-pointer sum on bf16 rows (rowptr_kernel_bf16): the same
// walk, with the running sum rounded to bf16 (nearest, ties to even) after
// every add, as XLA adds the rows of a bf16 scatter-add (jax.ops.segment_sum
// of bf16 data, the VJP of a bf16 gather); bf16 read and bf16 written, one
// launch a call. See rowptr_kernel_bf16 below.
// Row 9b, the packed kernel's bf16 modes (kBf16x8, kBf16x4): bf16 rows read
// in 16-byte vectors of 8 values where d is a multiple of 8 (a warp covers a
// 256-wide row with one load a lane), else in 8-byte vectors of 4, and
// widened exactly, summed in f32 in slot order within each tile_e-slot chunk
// of the tile's budget; at each chunk's end the f32 partial is rounded to
// bf16 (__float2bfloat16_rn) and added to a bf16 total, the add rounded; bf16
// written in the same vectors. That is where the TPU kernel rounds: its grid
// walks a tile's budget chunk by chunk, forms each chunk's sums as an f32 one-hot product,
// rounds them to the bf16 output's type and adds them to the bf16 output
// tile. The cut falls at the slot index within the tile, as the grid's
// chunks do, wherever the node's run begins; a node whose slots lie in one
// chunk gets its f32 sum rounded once.
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
//   3. The warp sums its node's rows: a lane owns kLaneVecs float4 sums of
//      the row (all d columns between the warp's lanes, so a node's run is
//      formed once, not once a column slice; the blocks of a tile each stage
//      its index, 3 KiB at the lipo batch, from L2), filled by two 16-byte
//      vectors (f32), one 16-byte vector of 8 bf16 values, or two 8-byte
//      ones of 4, reads a batch of rows of the list at once, adds them in
//      list order, and writes its vectors once. A list that fills up (a hub
//      node) is summed and emptied as the scan goes on. On bf16 rows the scan
//      marks, in the list itself, each row whose slot lies in another chunk
//      (slot / tile_e, by a multiply with its reciprocal) than the node's
//      row before it (from the ballot: the marked lane below, or the last
//      slot of the words before), by writing its edge id as ~e; the sum folds
//      its f32 partial into the bf16 total before such a row and at the end,
//      and reads kRowBatchBf16 rows at once: one scan, one list and one pass
//      over the rows, as in f32 (a pass per chunk took 1.55x row 9's time
//      on the card; 8-byte vectors, a second list, or a division for each
//      row's chunk, 1.1-1.3x: PERF.md §6).
//   Dependent device-memory round trips: the index, then the rows. The order
//   of every sum is fixed (ascending slot, as the CPU plain version's
//   index_add_ takes them) with no float atomics, so two calls give the same
//   bits, and the CPU plain version's.
//
// rowptr_kernel. A block per (group of consecutive nodes, slice of kSlice
// columns, w = min(kSlice, d - c0) wide); kRowThreads threads in teams of
// lanes, each lane four columns (where rows are read in 16-byte pieces and
// the block's span holds no long run) or one.
//   1. The block reads its group's row pointers (one coalesced read) into
//      shared memory. Rows are sorted by node, so the group's runs are one
//      contiguous span of rows [row_ptr[v0], row_ptr[v1]).
//   2. It stages the span's slice in shared memory in windows of
//      kWindowFloats floats (kWindowFloats / w rows), every row of a window in
//      flight at once (cp.async from every thread: 16-byte copies where d is
//      a multiple of 4 and data 16-byte aligned, else 4-byte ones), kBuffers
//      windows in flight, the next loading while the block adds the current.
//      With an order array a row's index is read first (one more round trip).
//   3. Each team adds its node's rows from shared memory in ascending edge
//      order (the next kChain rows' reads in flight while a lane adds the
//      last kChain), carrying the sum
//      from window to window, and writes the node once; a team takes the
//      group's nodes t, t + teams, ... in turn.
//   The host sizes a group to about kGroupRows rows at this call's mean run
//   length, so most groups take one window, and a long run (the padding
//   sink, a hub) takes a group's few nodes: its d / kSlice column slices run
//   on as many SMs, and its windows all load at once but for kBuffers.
//   Dependent device-memory round trips: the row pointers, the rows (through
//   the order: its index, then the row), then a window per kBuffers - 1 more.
//   Every output element is one ascending add chain started from zero, as the
//   CPU plain version's index_add_ takes it, with no atomics: two calls give
//   the same bits, and the CPU plain version's. (The kernel before this design
//   walked each node's rows with one warp, four loads in flight a lane; the
//   first flat lipo batch's 358-row sink run then held the whole launch for
//   some 90 dependent round trips: PERF.md §6 has both times.)
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxTile = 128;      // nodes per packed tile (tile_v <= 128)
constexpr int kMaxBudget = 49152;  // slots per tile: 192 KiB of keys
constexpr int kNodeWarps = 4;      // nodes (a warp each) of a packed block
constexpr int kPackedThreads = kNodeWarps * 32;
constexpr int kScanWords = 4;      // 32-slot words a warp's scan takes at once
constexpr int kList = 256;         // edge ids a warp's list holds (at least 32 kScanWords)
// Rows a lane reads at once: f32 rows, and bf16 rows (whose batch of
// unrolled widenings and folds costs more than the loads it keeps in flight)
constexpr int kRowBatch = 8;
constexpr int kRowBatchBf16 = 4;
constexpr int kLaneVecs = 2;       // 16-byte vectors of a row a lane sums at once
// budgets up to which perm is staged beside the keys (else a marked lane
// reads its slot's perm from device memory)
constexpr int kStagePermMax = 24576;
constexpr int kRowThreads = 256;  // threads of a row-pointer block
constexpr int kSlice = 32;        // columns of a row-pointer block
constexpr int kWindowFloats = 8192;  // floats of a staged window (32 KiB)
constexpr int kBuffers = 2;       // windows in flight
constexpr int kMaxGroup = 256;    // nodes of a row-pointer block, at most
constexpr int kGroupRows = 128;   // rows a row-pointer block takes at the mean run length
constexpr int kChain = 16;        // rows a lane reads from shared memory ahead of their adds
constexpr int kLongSpan = 2 * kGroupRows;  // a block's span past which it holds a long run
// 1 builds the stage stamps (see stamp); the timing script's --stages build.
constexpr int kStages = 0;

// The packed kernel's shared memory: the tile's keys (and edge ids), and a
// list a warp.
__host__ __device__ inline size_t packed_smem_bytes(int budget, bool stage_perm) {
  return sizeof(int) * ((stage_perm ? 2 : 1) * (size_t)budget + (size_t)kNodeWarps * kList);
}

// How packed_kernel reads a row: f32 in 16-byte vectors of 4 values (row 9);
// bf16 (row 9b) in 16-byte vectors of 8 values where d is a multiple of 8 and
// the rows 16-byte aligned, else in 8-byte vectors of 4.
constexpr int kF32 = 0, kBf16x4 = 1, kBf16x8 = 2;

// Vectors of a row a lane reads at once, each into kLaneVecs / kLoads of its
// float4 sums (a 16-byte vector of 8 bf16 values fills two), and the values
// of a vector.
template <int kType>
constexpr int kLoads = kType == kBf16x8 ? 1 : kLaneVecs;
template <int kType>
constexpr int kVecValues = kType == kBf16x8 ? 8 : 4;
template <int kType>
constexpr int kRows = kType == kF32 ? kRowBatch : kRowBatchBf16;

// Stage stamps of a kStages build: lane 0 of warp 0 of block 0 writes
// %globaltimer (ns) at each phase boundary of the packed kernel (stage_at:
// start, index staged, its node's run formed, its rows summed), and thread 0
// of every block takes the earliest start and the latest end (stage_span).
constexpr int kStageSlots = 4;
__device__ unsigned long long stage_at[kStageSlots];
__device__ unsigned long long stage_span[2];

// The row-pointer kernel's stamps of a kStages build: thread 0 of each of the
// first kStampBlocks blocks (x fastest) writes %globaltimer at its start, with
// its row pointers in, with its first window in and at its end, then its
// span's row count.
constexpr int kStampBlocks = kStages != 0 ? 4096 : 1, kRowStamps = 5;
__device__ unsigned long long rowptr_at[kStampBlocks][kRowStamps];

__device__ inline void row_stamp(int slot, long long span = -1) {
  if constexpr (kStages != 0) {
    const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x != 0 || b >= kStampBlocks) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    rowptr_at[b][slot] = span >= 0 ? (unsigned long long)span : t;
  }
}

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

__device__ inline unsigned pack_bf16x2(float x, float y) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&r);
}

// A lane's values of row e of data: its kLoads<kType> vectors q0 + 32 j +
// lane (j < kLoads) of the row's nq, as kLaneVecs float4s, widened exactly
// from bf16; zero past the row, and for e < 0.
template <int kType>
__device__ inline void load_lane(float4 (&x)[kLaneVecs], const void* __restrict__ data, int e, int nq, int q0,
                                 int lane) {
#pragma unroll
  for (int j = 0; j < kLoads<kType>; ++j) {
    const int q = q0 + j * 32 + lane;
    const size_t at = (size_t)e * nq + q;
    const bool in = e >= 0 && q < nq;
    if constexpr (kType == kBf16x8) {
      const uint4 raw = in ? static_cast<const uint4*>(data)[at] : make_uint4(0u, 0u, 0u, 0u);
      x[0] = widen_bf16x4(make_uint2(raw.x, raw.y));
      x[1] = widen_bf16x4(make_uint2(raw.z, raw.w));
    } else if constexpr (kType == kBf16x4) {
      x[j] = in ? load_bf16x4(static_cast<const __nv_bfloat16*>(data), 4 * at) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      x[j] = in ? static_cast<const float4*>(data)[at] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Row 9b's fold: the f32 partial rounded to bf16 and added to the bf16
// total, the add rounded; the partial starts again from zero.
__device__ inline void fold(float4 (&acc)[kLaneVecs], float4 (&total)[kLaneVecs]) {
#pragma unroll
  for (int j = 0; j < kLaneVecs; ++j) {
    total[j] = operand4<true>(add4(total[j], operand4<true>(acc[j])));
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc += the rows list[0..n) of data (the lane's values of each, load_lane),
// in list order; kRows rows' loads go out before their adds. On bf16
// rows an entry that starts a chunk of slots (stored as ~e, negative: see
// sum_run) first folds the partial into total.
template <int kType>
__device__ inline void sum_rows(const void* __restrict__ rows, const int* list, int n, int nq, int q0, int lane,
                                float4 (&acc)[kLaneVecs], float4 (&total)[kLaneVecs]) {
  for (int i0 = 0; i0 < n; i0 += kRows<kType>) {
    float4 x[kRows<kType>][kLaneVecs];
    bool starts[kRows<kType>];
#pragma unroll
    for (int i = 0; i < kRows<kType>; ++i) {
      int e = i0 + i < n ? list[i0 + i] : -1;
      if constexpr (kType != kF32) {
        starts[i] = e < 0;
        if (e < 0 && i0 + i < n) e = ~e;
      }
      load_lane<kType>(x[i], rows, e, nq, q0, lane);
    }
#pragma unroll
    for (int i = 0; i < kRows<kType>; ++i)
      if (i0 + i < n) {
        if constexpr (kType != kF32) {
          if (starts[i]) fold(acc, total);
        }
#pragma unroll
        for (int j = 0; j < kLaneVecs; ++j) acc[j] = add4(acc[j], x[i][j]);
      }
  }
}

// Steps 2-3 of packed_kernel: node v's slots of the tile in ascending order,
// kScanWords words at once (their key loads, then their ballots), each
// marked lane writing its edge id at its rank among the marks before it; acc
// gains their rows in that order. On bf16 rows a marked lane whose slot lies
// in another chunk (slot / chunk) than the node's slot marked before it (the
// lane below it in the ballot, or the last of the words before; a run's
// first row has none) writes ~e instead: the sum folds its f32 partial into
// the bf16 total there, and at the end (a slot's chunk from a multiply by a
// reciprocal, no division). A list that fills up is summed and emptied as
// the scan goes on.
template <bool kStagePerm, int kType>
__device__ inline void sum_run(const void* __restrict__ data, const int* key, const int* perm_s,
                               const int* __restrict__ perm, size_t s0, int v, int budget, int chunk, int* list,
                               int nq, int q0, int lane, float4 (&acc)[kLaneVecs], float4 (&total)[kLaneVecs]) {
  // bf16: the slot last marked; s / chunk as __umulhi(s, magic), magic =
  // ceil(2^32 / chunk): exact for every slot below 2^16 (kMaxBudget)
  int n = 0, last = -1;
  const unsigned magic = chunk > 1 ? 0xffffffffu / (unsigned)chunk + 1u : 0u;
  const int words = (budget + 31) / 32;
  const unsigned below = (1u << lane) - 1u;
  for (int w0 = 0; w0 < words; w0 += kScanWords) {
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
      if (hit[u]) {
        const int at = n + __popc(bits[u] & below);
        int e = kStagePerm ? perm_s[s] : perm[s0 + s];
        if constexpr (kType != kF32) {
          // a run's first row folds nothing: its partial and total are zero
          const unsigned before = bits[u] & below;
          const int prev = before != 0 ? (w0 + u) * 32 + 31 - __clz(before) : last;
          const int cs = chunk > 1 ? (int)__umulhi((unsigned)s, magic) * chunk : s;
          if (prev >= 0 && prev < cs) e = ~e;
        }
        list[at] = e;
      }
      n += __popc(bits[u]);
      if constexpr (kType != kF32) {
        if (bits[u] != 0) last = (w0 + u) * 32 + 31 - __clz(bits[u]);
      }
    }
    if (n > kList - 32 * kScanWords) {  // room for one more scan's marks no longer certain
      __syncwarp();
      sum_rows<kType>(data, list, n, nq, q0, lane, acc, total);
      n = 0;
      __syncwarp();
    }
  }
  __syncwarp();
  if (q0 == 0) stamp(2, false, false);
  sum_rows<kType>(data, list, n, nq, q0, lane, acc, total);
  if constexpr (kType != kF32) fold(acc, total);
  __syncwarp();  // the list is read before the next scan refills it
}

template <bool kStagePerm, int kType>
__global__ void __launch_bounds__(kPackedThreads)
    packed_kernel(const void* __restrict__ data, const int* __restrict__ perm,
                  const int* __restrict__ packed_dst, void* __restrict__ out, int E, int d,
                  int tile_v, int budget, int groups, int chunk) {
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

  // 2-3. node v's run in ascending slot order, then its rows; on bf16 rows
  // each chunk's f32 partial rounded to bf16 and added to the bf16 total,
  // the add rounded
  const int v = tile * tile_v + node;
  int* list = lists + warp * kList;
  const int nq = d / kVecValues<kType>;
  for (int q0 = 0; q0 < nq; q0 += 32 * kLoads<kType>) {
    float4 acc[kLaneVecs], total[kLaneVecs];
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) acc[j] = total[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    sum_run<kStagePerm, kType>(data, key, perm_s, perm, s0, v, budget, chunk, list, nq, q0, lane, acc, total);
#pragma unroll
    for (int j = 0; j < kLoads<kType>; ++j) {
      const int q = q0 + j * 32 + lane;
      if (q >= nq) continue;
      const size_t at = (size_t)v * nq + q;
      if constexpr (kType == kBf16x8) {
        reinterpret_cast<uint4*>(out)[at] = make_uint4(pack_bf16x2(total[0].x, total[0].y),
                                                       pack_bf16x2(total[0].z, total[0].w),
                                                       pack_bf16x2(total[1].x, total[1].y),
                                                       pack_bf16x2(total[1].z, total[1].w));
      } else if constexpr (kType == kBf16x4) {
        reinterpret_cast<uint2*>(out)[at] =
            make_uint2(pack_bf16x2(total[j].x, total[j].y), pack_bf16x2(total[j].z, total[j].w));
      } else {
        reinterpret_cast<float4*>(out)[at] = acc[j];
      }
    }
  }
  stamp(3, false, true);
}

// cp.async of 4 or 16 bytes from device memory into shared memory.
template <int kBytes>
__device__ inline void cp_async(float* to, const float* from) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(to);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(from));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at), "l"(from));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending)); }

__host__ __device__ inline size_t rowptr_smem_bytes(int group) {
  return sizeof(float) * (size_t)kBuffers * kWindowFloats + sizeof(int) * ((size_t)group + 1);
}

// Window k of a block's span, rows [lo + k * rows, ...) clipped at hi, into
// its buffer: each thread copies every kRowThreads-th 4 * kVec-float piece.
template <int kVec>
__device__ inline void load_window(float* buf, const float* __restrict__ data,
                                   const long long* __restrict__ order, int r0, int nr, int w, int d,
                                   int c0) {
  const int pieces = w / kVec;
  for (int i = threadIdx.x; i < nr * pieces; i += kRowThreads) {
    const int r = i / pieces, c = (i - r * pieces) * kVec;
    const long long e = order != nullptr ? order[r0 + r] : r0 + r;
    cp_async<4 * kVec>(buf + r * w + c, data + (size_t)e * d + c0 + c);
  }
}

template <int kFloats>
using Lane = std::conditional_t<kFloats == 4, float4, float>;

__device__ inline float add_lane(float a, float b) { return a + b; }
__device__ inline float4 add_lane(float4 a, float4 b) { return add4(a, b); }

// acc plus the rows at, at + stride, ... (count of them) of a window, in
// order: the next kChain rows' reads in flight while the last kChain are
// added. kStride is the row stride in floats, or 0 for w at run time.
template <int kStride, typename V>
__device__ inline V add_rows(V acc, const float* at, int count, int w) {
  const int stride = kStride != 0 ? kStride : w;
  int r = 0;
  if (count >= kChain) {
    V x[kChain], next[kChain];
#pragma unroll
    for (int u = 0; u < kChain; ++u) x[u] = *reinterpret_cast<const V*>(at + u * stride);
    for (r = kChain, at += kChain * stride; r + kChain <= count; r += kChain, at += kChain * stride) {
#pragma unroll
      for (int u = 0; u < kChain; ++u) next[u] = *reinterpret_cast<const V*>(at + u * stride);
#pragma unroll
      for (int u = 0; u < kChain; ++u) acc = add_lane(acc, x[u]);
#pragma unroll
      for (int u = 0; u < kChain; ++u) x[u] = next[u];
    }
#pragma unroll
    for (int u = 0; u < kChain; ++u) acc = add_lane(acc, x[u]);
  }
  for (; r < count; ++r, at += stride) acc = add_lane(acc, *reinterpret_cast<const V*>(at));
  return acc;
}

// Steps 2-3 of rowptr_kernel for one block: the span [lo, hi) of its n nodes
// (row pointers rp) staged in windows, each team's nodes summed as their rows
// arrive. A team is w / kFloats lanes, each holding kFloats columns.
template <int kVec, int kFloats>
__device__ inline void sum_group(const float* __restrict__ data, const long long* __restrict__ order,
                                 float* __restrict__ out, const int* rp, float* windows, int d, int n,
                                 int v0, int c0, int w, int lo, int hi) {
  const int rows = kWindowFloats / w;
  const int count = (hi - lo + rows - 1) / rows;
  auto load = [&](int k) {  // window k, or an empty group of copies past the last
    if (k < count)
      load_window<kVec>(windows + k % kBuffers * kWindowFloats, data, order, lo + k * rows,
                        min(rows, hi - lo - k * rows), w, d, c0);
    cp_async_commit();
  };
  using V = Lane<kFloats>;
  const int team_lanes = w / kFloats, lane = threadIdx.x % 32, per_warp = 32 / team_lanes;
  const int t = lane / team_lanes, col = (lane - t * team_lanes) * kFloats;
  const bool active = t < per_warp;
  const int teams = kRowThreads / 32 * per_warp;
  int j = threadIdx.x / 32 * per_warp + t;  // the team's node in the group
  V acc = {};
  V* o = reinterpret_cast<V*>(out + (size_t)v0 * d + c0 + col);
  const size_t stride = (size_t)d / kFloats;  // an output row, in lane values
#pragma unroll
  for (int k = 0; k < kBuffers - 1; ++k) load(k);
  for (int k = 0; k < count; ++k) {
    load(k + kBuffers - 1);
    cp_async_wait<kBuffers - 1>();
    __syncthreads();
    if (k == 0) row_stamp(2);
    const float* buf = windows + k % kBuffers * kWindowFloats + col;
    const int r0 = lo + k * rows, r1 = min(r0 + rows, hi);
    if (active) {
      for (; j < n; j += teams) {
        const int a = max(rp[j], r0), b = min(rp[j + 1], r1);
        const float* at = buf + (a - r0) * w;
        acc = w == kSlice ? add_rows<kSlice>(acc, at, b - a, w) : add_rows<0>(acc, at, b - a, w);
        if (rp[j + 1] > r1) break;  // the run goes on in the next window
        o[j * stride] = acc;
        acc = V{};
      }
    }
    __syncthreads();  // the buffer is read before a later window's copies refill it
  }
  cp_async_wait<0>();
  if (active)  // nodes past the span (empty), or every node of an empty span
    for (; j < n; j += teams) {
      o[j * stride] = acc;
      acc = V{};
    }
}

template <int kVec>
__global__ void __launch_bounds__(kRowThreads)
    rowptr_kernel(const float* __restrict__ data, const int* __restrict__ row_ptr,
                  const long long* __restrict__ order, float* __restrict__ out, int E, int d,
                  int num_nodes, int group) {
  row_stamp(0);
  extern __shared__ float4 rowptr_smem[];
  float* windows = reinterpret_cast<float*>(rowptr_smem);       // [kBuffers][kWindowFloats]
  int* rp = reinterpret_cast<int*>(windows + kBuffers * kWindowFloats);  // [group + 1]
  const int v0 = blockIdx.x * group, n = min(group, num_nodes - v0);
  const int c0 = blockIdx.y * kSlice, w = min(kSlice, d - c0);

  // 1. the group's row pointers, clipped to [0, E)
  for (int i = threadIdx.x; i <= n; i += kRowThreads) rp[i] = min(max(row_ptr[v0 + i], 0), E);
  __syncthreads();
  const int lo = rp[0], hi = max(rp[n], lo);
  row_stamp(1);
  row_stamp(4, hi - lo);

  // 2-3. a span of the group's usual size: teams of lanes that hold four
  // columns each, so a warp takes four nodes at once; a span that holds a
  // long run (the padding sink, a hub): lanes of one column each, whose
  // chains through the run's rows took less time on the card
  if constexpr (kVec == 4) {
    if (hi - lo > kLongSpan)
      sum_group<4, 1>(data, order, out, rp, windows, d, n, v0, c0, w, lo, hi);
    else
      sum_group<4, 4>(data, order, out, rp, windows, d, n, v0, c0, w, lo, hi);
  } else {
    sum_group<1, 1>(data, order, out, rp, windows, d, n, v0, c0, w, lo, hi);
  }
  __syncthreads();
  row_stamp(3);
}

// ---- row 8b: the ordered bf16 sum --------------------------------------------
//
// rowptr_kernel_bf16 computes what rowptr_kernel computes, on bf16 rows, with
// the running sum rounded to bf16 after every add: out[v] (bf16) is the chain
// 0 + x_1 + x_2 + ... over v's rows in ascending e, each add rounded to the
// nearest bf16, ties to even. A tree of partial sums cannot give those bits,
// so every output element is one chain of dependent adds, and a long run (the
// padding ids of an embedding table's gradient: 9,513 of the dense first
// lipo batch's 21,504 type ids) is one chain as long as the run. What bounds
// it is that chain: the longest run times one add's latency (chip_smoke.py
// measures that latency with csr_segment_chain_latency and reports it beside
// the bytes bound), not the bytes.
//
// One step of the chain is one instruction. A lane carries a pair of columns
// as a bf16x2 and adds a row's pair with add.rn.bf16x2: one rounding of the
// exact sum of two bf16 values. That is the f32 add rounded
// to bf16 which XLA (and the plain version) computes: where the exponents
// differ by at most 15 the f32 sum is exact; where they differ more, the
// smaller term lies far below half a bf16 ulp of the larger, and both round
// to the larger. Subnormals are kept (add.bf16x2 has no flush-to-zero mode)
// and +0 + -0 is +0. (tests/test_torch_bf16_chain.py pins the identity over
// random, gapped, tied, subnormal, zero and infinite pairs on the CPU;
// tests/test_torch_gpu_bf16.py holds the kernel to the plain version's bits
// on the card for the same classes and 2^20 random bit patterns: on an H100
// the packed add gave the f32 add's rounded bits in every case, so the f32
// add with a packed cvt.rn.bf16x2.f32, three dependent instructions a step,
// is not needed.) An odd width stages a zero in its last pair's high half,
// which no store reads.
//
// A block per (group of consecutive nodes, slice of kSlice columns), as
// rowptr_kernel, with its warps split in two roles, so that a long run never
// waits on a barrier of the whole block:
//   - kBfProducers producer warps fill a ring of kBfStages windows of the
//     span's rows (at most kBfWindowRows rows a window, the slice's columns
//     as bf16 pairs), window k by warp k % kBfProducers: a lane reads the
//     order index of each of its rows once (coalesced, all in flight before
//     the window's buffer is waited for), then copies the row's slice by
//     cp.async (16-byte pieces where d is a multiple of 8 and data 16-byte
//     aligned, else 4-byte pieces where d is even, else plain loads and
//     stores) and arrives on the window's full mbarrier when its copies land
//     (cp.async.mbarrier.arrive.noinc);
//   - the other warps consume the windows in order as they arrive (each waits
//     on the window's full mbarrier, then arrives on its empty one): teams of
//     lanes, a lane a pair of columns, take the group's nodes in turn and add
//     their rows, the next kChain rows read from shared memory ahead of their
//     adds, carrying a run's sum from window to window; a node is written
//     once, bf16.
// A window's buffer is refilled only after every consumer lane has arrived on
// its empty mbarrier. Dependent device-memory round trips: the row pointers,
// then a window's indices and its rows, kBfStages windows in flight.
constexpr int kBfThreads = 256;
constexpr int kBfProducers = 2;                                  // producer warps
constexpr int kBfConsumerThreads = kBfThreads - 32 * kBfProducers;
constexpr int kBfStages = 4;                                     // windows in the ring
constexpr int kBfWindowRows = 256;                               // rows of a window, at most
constexpr int kBfLaneRows = kBfWindowRows / 32;                  // of a producer lane
constexpr int kBfWindowWords = kBfWindowRows * kSlice / 2;       // 32-bit words of a window (16 KiB)

__device__ inline unsigned smem_at(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_at(bar)), "r"(count) : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n" : "=l"(state) : "r"(smem_at(bar)) : "memory");
}

// An arrive on bar when this thread's cp.async copies so far have landed.
__device__ inline void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_at(bar)) : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_at(bar)), "r"(parity)
        : "memory");
}

// One step of the chain: a + b for two bf16 pairs, each half rounded to bf16.
__device__ inline unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned out;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(b));
  return out;
}

// acc plus the pairs at, at + stride, ... (count of them), in order: the next
// kChain rows' reads in flight while the last kChain are added.
__device__ inline unsigned add_pairs(unsigned acc, const unsigned* at, int count, int stride) {
  int r = 0;
  if (count >= kChain) {
    unsigned x[kChain], next[kChain];
#pragma unroll
    for (int u = 0; u < kChain; ++u) x[u] = at[u * stride];
    for (r = kChain, at += kChain * stride; r + kChain <= count; r += kChain, at += kChain * stride) {
#pragma unroll
      for (int u = 0; u < kChain; ++u) next[u] = at[u * stride];
#pragma unroll
      for (int u = 0; u < kChain; ++u) acc = add_bf16x2(acc, x[u]);
#pragma unroll
      for (int u = 0; u < kChain; ++u) x[u] = next[u];
    }
#pragma unroll
    for (int u = 0; u < kChain; ++u) acc = add_bf16x2(acc, x[u]);
  }
  for (; r < count; ++r, at += stride) acc = add_bf16x2(acc, *at);
  return acc;
}

// A row's slice of w bf16 values from src into a window row at dst (words
// pairs): kVec 8 by 16-byte cp.async, 2 by 4-byte cp.async, 1 by plain loads
// and stores (an odd w's last pair padded with a zero).
template <int kVec>
__device__ inline void copy_row(unsigned* dst, const __nv_bfloat16* __restrict__ src, int w) {
  if constexpr (kVec == 1) {
    uint16_t* to = reinterpret_cast<uint16_t*>(dst);
    const uint16_t* from = reinterpret_cast<const uint16_t*>(src);
    for (int c = 0; c < w; ++c) to[c] = from[c];
    if (w % 2) to[w] = 0;
  } else {
    for (int c = 0; c < w; c += kVec)
      cp_async<2 * kVec>(reinterpret_cast<float*>(dst + c / 2), reinterpret_cast<const float*>(src + c));
  }
}

template <int kVec>
__global__ void __launch_bounds__(kBfThreads)
    rowptr_kernel_bf16(const __nv_bfloat16* __restrict__ data, const int* __restrict__ row_ptr,
                       const long long* __restrict__ order, __nv_bfloat16* __restrict__ out, int E, int d,
                       int num_nodes, int group) {
  extern __shared__ float4 rowptr_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(rowptr_smem);           // [kBfStages]
  uint64_t* empty = full + kBfStages;                                  // [kBfStages]
  unsigned* windows = reinterpret_cast<unsigned*>(empty + kBfStages);  // [kBfStages][kBfWindowWords]
  int* rp = reinterpret_cast<int*>(windows + kBfStages * kBfWindowWords);  // [group + 1]
  const int v0 = blockIdx.x * group, n = min(group, num_nodes - v0);
  const int c0 = blockIdx.y * kSlice, w = min(kSlice, d - c0);
  const int words = (w + 1) / 2;  // bf16 pairs of a staged row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i <= n; i += kBfThreads) rp[i] = min(max(row_ptr[v0 + i], 0), E);
  if (threadIdx.x < kBfStages) {
    mbar_init(full + threadIdx.x, 32);                   // the lanes of the window's producer warp
    mbar_init(empty + threadIdx.x, kBfConsumerThreads);  // every consumer lane
  }
  __syncthreads();
  const int lo = rp[0], hi = max(rp[n], lo);
  const int count = (hi - lo + kBfWindowRows - 1) / kBfWindowRows;

  if (warp < kBfProducers) {
    for (int k = warp; k < count; k += kBfProducers) {
      const int slot = k % kBfStages, r0 = lo + k * kBfWindowRows, nr = min(kBfWindowRows, hi - r0);
      long long e[kBfLaneRows];
#pragma unroll
      for (int u = 0; u < kBfLaneRows; ++u) {
        const int r = lane + 32 * u;
        e[u] = r >= nr ? -1 : order != nullptr ? order[r0 + r] : (long long)(r0 + r);
      }
      if (k >= kBfStages) mbar_wait(empty + slot, (k / kBfStages + 1) & 1);
      unsigned* buf = windows + slot * kBfWindowWords;
#pragma unroll
      for (int u = 0; u < kBfLaneRows; ++u)
        if (e[u] >= 0) copy_row<kVec>(buf + (lane + 32 * u) * words, data + (size_t)e[u] * d + c0, w);
      if constexpr (kVec == 1)
        mbar_arrive(full + slot);
      else
        cp_async_arrive(full + slot);
    }
    if constexpr (kVec != 1) cp_async_wait<0>();
    return;
  }

  // consumers: teams of `words` lanes, lane `col` of a team the pair of
  // columns c0 + 2 col, c0 + 2 col + 1
  const int per_warp = 32 / words, t = lane / words, col = lane - t * words;
  const bool active = t < per_warp;
  const int teams = kBfConsumerThreads / 32 * per_warp;
  int j = (warp - kBfProducers) * per_warp + t;  // the team's node in the group
  unsigned acc = 0u;
  uint16_t* o = reinterpret_cast<uint16_t*>(out) + (size_t)v0 * d + c0 + 2 * col;
  const bool high = 2 * col + 1 < w;
  auto store = [&](int node) {
    o[(size_t)node * d] = (uint16_t)(acc & 0xffffu);
    if (high) o[(size_t)node * d + 1] = (uint16_t)(acc >> 16);
    acc = 0u;
  };
  for (int k = 0; k < count; ++k) {
    const int slot = k % kBfStages;
    mbar_wait(full + slot, (k / kBfStages) & 1);
    const unsigned* buf = windows + slot * kBfWindowWords + col;
    const int r0 = lo + k * kBfWindowRows, r1 = min(r0 + kBfWindowRows, hi);
    if (active) {
      for (; j < n; j += teams) {
        const int a = max(rp[j], r0), b = min(rp[j + 1], r1);
        acc = add_pairs(acc, buf + (a - r0) * words, b - a, words);
        if (rp[j + 1] > r1) break;  // the run goes on in the next window
        store(j);
      }
    }
    mbar_arrive(empty + slot);
  }
  if (active)  // nodes past the span (empty), or every node of an empty span
    for (; j < n; j += teams) store(j);
}

__host__ __device__ inline size_t rowptr_bf16_smem_bytes(int group) {
  return sizeof(uint64_t) * 2 * kBfStages + sizeof(unsigned) * (size_t)kBfStages * kBfWindowWords +
         sizeof(int) * ((size_t)group + 1);
}

// The chain floor's probe: one thread adds x to a bf16 pair iters * 64 times,
// each add depending on the last (the chain's own instruction, kept in order
// by volatile asm), and writes the chain's SM cycles and %globaltimer
// nanoseconds, then the sum.
__global__ void chain_latency_kernel(unsigned long long* out, unsigned x, int iters) {
  unsigned acc = x;
  unsigned long long t0, t1;
  const long long c0 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 64; ++u) asm volatile("add.rn.bf16x2 %0, %0, %1;\n" : "+r"(acc) : "r"(x));
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  const long long c1 = clock64();
  out[0] = (unsigned long long)(c1 - c0);
  out[1] = t1 - t0;
  out[2] = acc;
}

bool bad_rows(const float* data, const float* out, int E, int d) {
  return E < 0 || d < 0 || d % 4 != 0 || ((uintptr_t)data | (uintptr_t)out) % 16 != 0;
}

// Nodes a row-pointer block sums: about kGroupRows rows (scaled up for narrow
// slices, whose rows are shorter) at the mean run length (E / num_nodes), a
// power of two in [1, kMaxGroup].
int rowptr_group(int E, int d, int num_nodes) {
  const long long rows = (long long)kGroupRows * kSlice / (d < kSlice ? d : kSlice);
  const long long want = rows * num_nodes / (E > 0 ? E : 1);
  int group = 1;
  while (group < kMaxGroup && 2LL * group <= want) group *= 2;
  return group;
}

// Launch the packed kernel (reading rows as kType) once; `chunk` is the
// slot count at which the bf16 modes round their partials (the budget for
// f32). Each instantiation raises its own shared-memory limit.
template <int kType>
int launch_packed(const void* data, const int* perm, const int* packed_dst, void* out, int E, int d,
                  int num_nodes, int tile_v, int budget, int chunk, cudaStream_t s) {
  if (tile_v <= 0 || tile_v > kMaxTile || num_nodes <= 0 || num_nodes % tile_v != 0 || budget < 0 ||
      budget > kMaxBudget || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  const bool stage_perm = budget <= kStagePermMax;
  const void* kernel = stage_perm ? (const void*)packed_kernel<true, kType>
                                  : (const void*)packed_kernel<false, kType>;
  const size_t smem = packed_smem_bytes(budget, stage_perm);
  static uint64_t configured[2] = {0, 0};
  if (smem > 48 * 1024) {
    const int most = (int)(stage_perm ? packed_smem_bytes(kStagePermMax, true) : packed_smem_bytes(kMaxBudget, false));
    const cudaError_t err = allow_smem(kernel, most, configured[stage_perm]);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (tile_v + kNodeWarps - 1) / kNodeWarps;
  const long long blocks = (long long)(num_nodes / tile_v) * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (stage_perm)
    packed_kernel<true, kType><<<(unsigned)blocks, kPackedThreads, smem, s>>>(
        data, perm, packed_dst, out, E, d, tile_v, budget, groups, chunk);
  else
    packed_kernel<false, kType><<<(unsigned)blocks, kPackedThreads, smem, s>>>(
        data, perm, packed_dst, out, E, d, tile_v, budget, groups, chunk);
  return (int)cudaGetLastError();
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
  if (bad_rows(data, out, E, d)) return (int)cudaErrorInvalidValue;
  return launch_packed<kF32>(data, perm, packed_dst, out, E, d, num_nodes, tile_v, budget, budget,
                             static_cast<cudaStream_t>(stream));
}

// Row 9b, the packed sum on bf16 data: as csr_segment_sum_packed_f32, with
// data and out bf16 (d a multiple of 4, both 8-byte aligned) and the budget
// a multiple of tile_e, the chunk at which the TPU kernel's grid rounds. Rows
// are read and written in 16-byte vectors where d is a multiple of 8 and
// both start 16-byte aligned, else in 8-byte ones.
int csr_segment_sum_packed_bf16(const __nv_bfloat16* data, const int* perm, const int* packed_dst,
                                __nv_bfloat16* out, int E, int d, int num_nodes, int tile_v, int budget,
                                int tile_e, void* stream) {
  const uintptr_t at = (uintptr_t)data | (uintptr_t)out;
  if (E < 0 || d < 0 || d % 4 != 0 || at % 8 != 0 || tile_e <= 0 || budget % tile_e != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 == 0 && at % 16 == 0)
    return launch_packed<kBf16x8>(data, perm, packed_dst, out, E, d, num_nodes, tile_v, budget, tile_e, s);
  return launch_packed<kBf16x4>(data, perm, packed_dst, out, E, d, num_nodes, tile_v, budget, tile_e, s);
}

// The row-pointer sum: data[rows, d] (any d >= 0), row_ptr[num_nodes + 1]
// int32 (nondecreasing), out[num_nodes, d]; with order (int64, E entries, each
// a row of data) the sum reads data[order[e]], without it data[e] (E rows).
// Device pointers of contiguous arrays; the stream is a cudaStream_t. Returns
// the cudaError_t of the launch (0 on success).
int csr_segment_sum_rowptr_f32(const float* data, const int* row_ptr, const long long* order, float* out,
                               int E, int d, int num_nodes, void* stream) {
  if (E < 0 || d < 0 || num_nodes < 0) return (int)cudaErrorInvalidValue;
  if (d == 0 || num_nodes == 0) return (int)cudaSuccess;
  const int group = rowptr_group(E, d, num_nodes);
  const long long groups = ((long long)num_nodes + group - 1) / group;
  const long long slices = ((long long)d + kSlice - 1) / kSlice;
  if (groups > 0x7fffffffLL || slices > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && ((uintptr_t)data | (uintptr_t)out) % 16 == 0;
  const void* kernels[2] = {(const void*)rowptr_kernel<1>, (const void*)rowptr_kernel<4>};
  const size_t smem = rowptr_smem_bytes(group);
  static uint64_t configured[2] = {0, 0};
  const cudaError_t err = allow_smem(kernels[vec], (int)rowptr_smem_bytes(kMaxGroup), configured[vec]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)groups, (unsigned)slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    rowptr_kernel<4><<<grid, kRowThreads, smem, s>>>(data, row_ptr, order, out, E, d, num_nodes, group);
  else
    rowptr_kernel<1><<<grid, kRowThreads, smem, s>>>(data, row_ptr, order, out, E, d, num_nodes, group);
  return (int)cudaGetLastError();
}

// Row 8b, the row-pointer sum on bf16 data: as csr_segment_sum_rowptr_f32,
// with data and out bf16 (any d, any 2-byte alignment) and the running sum
// rounded to bf16 after every add, in one launch.
int csr_segment_sum_rowptr_bf16(const __nv_bfloat16* data, const int* row_ptr, const long long* order,
                                __nv_bfloat16* out, int E, int d, int num_nodes, void* stream) {
  if (E < 0 || d < 0 || num_nodes < 0) return (int)cudaErrorInvalidValue;
  if (d == 0 || num_nodes == 0) return (int)cudaSuccess;
  const int group = rowptr_group(E, d, num_nodes);
  const long long groups = ((long long)num_nodes + group - 1) / group;
  const long long slices = ((long long)d + kSlice - 1) / kSlice;
  if (groups > 0x7fffffffLL || slices > 65535) return (int)cudaErrorInvalidValue;
  const int which = d % 8 == 0 && (uintptr_t)data % 16 == 0 ? 2 : d % 2 == 0 && (uintptr_t)data % 4 == 0 ? 1 : 0;
  const void* kernels[3] = {(const void*)rowptr_kernel_bf16<1>, (const void*)rowptr_kernel_bf16<2>,
                            (const void*)rowptr_kernel_bf16<8>};
  static uint64_t configured[3] = {0, 0, 0};
  const cudaError_t err =
      allow_smem(kernels[which], (int)rowptr_bf16_smem_bytes(kMaxGroup), configured[which]);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = rowptr_bf16_smem_bytes(group);
  const dim3 grid((unsigned)groups, (unsigned)slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: rowptr_kernel_bf16<1><<<grid, kBfThreads, smem, s>>>(data, row_ptr, order, out, E, d, num_nodes, group); break;
    case 1: rowptr_kernel_bf16<2><<<grid, kBfThreads, smem, s>>>(data, row_ptr, order, out, E, d, num_nodes, group); break;
    default: rowptr_kernel_bf16<8><<<grid, kBfThreads, smem, s>>>(data, row_ptr, order, out, E, d, num_nodes, group);
  }
  return (int)cudaGetLastError();
}

// The chain floor's probe (chain_latency_kernel): out[3] (device, uint64)
// gets the SM cycles and nanoseconds of iters * 64 dependent adds of row 8b's
// chain, then the sum. Returns the cudaError_t of the launch.
int csr_segment_chain_latency(unsigned long long* out, int iters, void* stream) {
  if (iters <= 0) return (int)cudaErrorInvalidValue;
  chain_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, 0x3f803f80u, iters);
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

// The row-pointer kernel's stamps (see row_stamp): `reset` zeroes them,
// `read` copies kRowStamps values for each of the first `blocks` blocks
// (at most kStampBlocks).
int csr_segment_rowptr_stamps_reset() {
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, rowptr_at);
  return (int)(err != cudaSuccess ? err : cudaMemset(at, 0, sizeof rowptr_at));
}

int csr_segment_rowptr_stamps_read(unsigned long long* out, int blocks) {
  if (blocks < 0 || blocks > kStampBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, rowptr_at, sizeof(unsigned long long) * kRowStamps * blocks);
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
