// One layer of the folded dense D-MPNN block, in CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel notorch_tpu/kernels/dense_mpnn.py:
// fused_dense_mpnn_block / _block_kernel (with its operator _edge_adjacency).
// The Python wrapper (notorch_tpu_torch/kernels/dense_mpnn.py) launches this
// kernel once per layer and ping-pongs the edge state between two buffers.
//
// Per bin b, with rev(e) = e ^ 1 (edges interleaved in reverse pairs):
//   keep[e,e'] = src[e] == dst[e'] && emask[e']
//   sum:  A[e,e'] = keep[e,e'] && e' != rev(e)
//   mean: A[e,e'] = keep[e,e'] / max(indeg(e), 1) - [e' == rev(e)],
//         indeg(e) = sum_e' keep[e,e']
//   h_out = (h_in +) bias + A @ (relu(h_in) @ W)
// The rev subtraction is folded into A exactly as the TPU kernel folds it, so
// padded edge lanes come out the same as there, not as the unfolded form.
//
// Grid: (bin, 64-column slice of d); 256 threads per block.
//   1. The block stages src/dst/emask of its bin and builds A's nonzero pattern
//      as one bit row per edge ([E][ceil(E/32)] words, 8 KiB at E = 256).
//   2. mW[:, slice] = relu(h_in[b]) @ W[:, slice] by k-tiled shared-memory f32
//      FMA (32-deep k tiles of h and W); mW stays in shared memory. Each
//      thread loads its share of the next tile into registers, in 16-byte
//      vectors, while the block computes on the current one.
//   3. Each output row walks the set bits of its A row and sums the mW rows
//      they name: the row-sparse form of A @ mW, with no E x E product. The
//      residual reads are issued eight rows at a time.
//
// What bounds it: the work is exact f32 (no TF32, no bf16), so the floor is
// the CUDA-core f32 rate (67 TFLOP/s on an H100 SXM at 700 W). The W products
// need depth * 2 * B * E * d^2 operations and A @ mW only 2 * nnz(A) * d per
// layer, a few per row for molecules; the bytes (read h0, W, b and the index
// arrays once, write the output once) take about a tenth as long. So it is
// bound by operations, and the design spends them only where A is nonzero and
// keeps the device-memory latency behind the FMAs. It does not reach that
// floor: the product phase is plain FMA from shared memory with no tensor
// cores, one launch per layer re-reads h_in from device memory (it stays in
// the 50 MB L2 at serving shapes), and every column slice of a bin rebuilds
// the same bit rows. Moving the state into shared memory for the whole depth
// and the products onto wgmma is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;      // output columns per block
constexpr int kKTile = 32;     // k depth of one staged tile
constexpr int kThreads = 256;
constexpr int kMaxEdges = 256;  // edge lanes per bin this kernel takes
constexpr int kResGroup = 8;    // residual reads in flight per thread in step 3

__host__ __device__ inline int adj_words(int E) { return (E + 31) / 32; }

__host__ inline size_t smem_bytes(int E) {
  return sizeof(float) * ((size_t)kKTile * kCols          // W tile (first: 16-byte aligned)
                          + (size_t)E * kCols             // mW slice
                          + (size_t)E * (kKTile + 1))     // relu(h) tile, padded rows
         + sizeof(uint32_t) * (size_t)E * adj_words(E)  // A bit rows
         + sizeof(int) * 3 * (size_t)E;                 // src, dst, emask
}

// One thread's share of a k-tile, in registers: R / 2 vectors of h (a block
// covers 16 * R rows of 8 vectors) and 2 of W (32 rows of 16 vectors).
template <int R>
struct TileRegs {
  float4 h[R / 2];
  float4 w[2];
};

template <int R>
__device__ inline void load_tile(TileRegs<R>& t, const float* hb, const float* W, int E, int d,
                                 int c0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int idx = tid + kThreads * i, e = idx >> 3, q = idx & 7;
    t.h[i] = e < E ? reinterpret_cast<const float4*>(hb + (size_t)e * d + k0)[q]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i, k = idx >> 4, q = idx & 15;
    t.w[i] = reinterpret_cast<const float4*>(W + (size_t)(k0 + k) * d + c0)[q];
  }
}

__device__ inline float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN passes, as in torch

template <int R>
__device__ inline void store_tile(const TileRegs<R>& t, float* hs, float* ws, int E, int tid) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int idx = tid + kThreads * i, e = idx >> 3, q = idx & 7;
    if (e < E) {
      float* row = hs + e * (kKTile + 1) + 4 * q;
      row[0] = relu(t.h[i].x);
      row[1] = relu(t.h[i].y);
      row[2] = relu(t.h[i].z);
      row[3] = relu(t.h[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) reinterpret_cast<float4*>(ws)[tid + kThreads * i] = t.w[i];
}

// R: rows of the product phase per thread; a block covers 16 * R edge lanes.
template <int R>
__global__ void __launch_bounds__(kThreads)
dense_mpnn_layer_kernel(const float* __restrict__ h_in, float* __restrict__ h_out,
                        const int* __restrict__ src, const int* __restrict__ dst,
                        const uint8_t* __restrict__ emask, const float* __restrict__ W,
                        const float* __restrict__ bias, int E, int d, int residual,
                        int mean) {
  extern __shared__ float4 smem4[];
  const int words = adj_words(E);
  float* ws = reinterpret_cast<float*>(smem4);                       // [kKTile][kCols]
  float* mw = ws + kKTile * kCols;                                   // [E][kCols]
  float* hs = mw + (size_t)E * kCols;                                // [E][kKTile + 1]
  uint32_t* adj = reinterpret_cast<uint32_t*>(hs + (size_t)E * (kKTile + 1));  // [E][words]
  int* src_s = reinterpret_cast<int*>(adj + (size_t)E * words);
  int* dst_s = src_s + E;
  int* ok_s = dst_s + E;

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const size_t bin_off = (size_t)b * E;
  const float* hb = h_in + bin_off * d;

  // the first tile's loads go out before anything waits on shared memory
  TileRegs<R> tile;
  load_tile<R>(tile, hb, W, E, d, c0, 0, tid);

  for (int e = tid; e < E; e += kThreads) {
    src_s[e] = src[bin_off + e];
    dst_s[e] = dst[bin_off + e];
    ok_s[e] = emask[bin_off + e] != 0;
  }
  __syncthreads();

  // 1. bit rows of A's pattern (sum: keep without rev; mean: keep)
  for (int i = tid; i < E * words; i += kThreads) {
    const int e = i / words;
    const int base = (i % words) * 32;
    const int se = src_s[e];
    const int rev = e ^ 1;
    uint32_t bits = 0u;
    for (int t = 0; t < 32; ++t) {
      const int e2 = base + t;
      if (e2 < E && ok_s[e2] && dst_s[e2] == se && (mean || e2 != rev)) bits |= 1u << t;
    }
    adj[i] = bits;
  }

  // 2. mW[:, c0:c0+64] = relu(h_in[b]) @ W[:, c0:c0+64]; thread (tx, ty)
  //    owns columns 4tx..4tx+3 of rows ty + 16r
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kKTile) {
    __syncthreads();  // the previous tiles are consumed (and step 1 is done)
    store_tile<R>(tile, hs, ws, E, tid);
    __syncthreads();
    if (k0 + kKTile < d) load_tile<R>(tile, hb, W, E, d, c0, k0 + kKTile, tid);
#pragma unroll 4
    for (int k = 0; k < kKTile; ++k) {
      const float4 bv = reinterpret_cast<const float4*>(ws + k * kCols)[tx];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = ty + 16 * r;
        const float a = e < E ? hs[e * (kKTile + 1) + k] : 0.f;
        acc[r][0] = fmaf(a, bv.x, acc[r][0]);
        acc[r][1] = fmaf(a, bv.y, acc[r][1]);
        acc[r][2] = fmaf(a, bv.z, acc[r][2]);
        acc[r][3] = fmaf(a, bv.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = ty + 16 * r;
    if (e < E)
      reinterpret_cast<float4*>(mw + e * kCols)[tx] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  // 3. h_out[b, e, c] = (h_in +) bias + sum over the set bits of row e
  constexpr int kRowStep = kThreads / kCols;
  const int c = tid % kCols;
  const float bc = bias[c0 + c];
  for (int e0 = tid / kCols; e0 < E; e0 += kRowStep * kResGroup) {
    float res[kResGroup];
#pragma unroll
    for (int u = 0; u < kResGroup; ++u) {
      const int e = e0 + u * kRowStep;
      res[u] = residual && e < E ? h_in[(bin_off + e) * d + c0 + c] : 0.f;
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
      if (mean) s = s / fmaxf((float)deg, 1.f) - mw[(e ^ 1) * kCols + c];
      const float o = bc + s;
      h_out[(bin_off + e) * d + c0 + c] = residual ? res[u] + o : o;
    }
  }
}

template <int R>
cudaError_t launch(const float* h_in, float* h_out, const int* src, const int* dst,
                   const uint8_t* emask, const float* W, const float* bias, int B, int E,
                   int d, int residual, int mean, cudaStream_t stream) {
  // the shared-memory limit is a per-device attribute: set it once on each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static uint64_t configured = 0;  // bit per device
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(dense_mpnn_layer_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(16 * R));
    if (err != cudaSuccess) return err;
    configured |= uint64_t{1} << dev;
  }
  dim3 grid(B, d / kCols);
  dense_mpnn_layer_kernel<R><<<grid, kThreads, smem_bytes(E), stream>>>(
      h_in, h_out, src, dst, emask, W, bias, E, d, residual, mean);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_mpnn_max_edges() { return kMaxEdges; }

int dense_mpnn_cols() { return kCols; }

// One layer: h_out[B,E,d] from h_in[B,E,d], src/dst[B,E] int32, emask[B,E]
// bytes, W[d,d] ([in, out], row-major), bias[d]. All pointers are device
// pointers of contiguous arrays; h_in, h_out and W start 16-byte aligned. The
// stream is a cudaStream_t. Returns the cudaError_t of the launch (0 on
// success).
int dense_mpnn_layer(const float* h_in, float* h_out, const int* src, const int* dst,
                     const uint8_t* emask, const float* W, const float* bias, int B, int E,
                     int d, int residual, int mean, void* stream) {
  if (B <= 0 || E <= 0 || E % 2 != 0 || E > kMaxEdges || d <= 0 || d % kCols != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)h_in | (uintptr_t)h_out | (uintptr_t)W) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 128)
    return (int)launch<8>(h_in, h_out, src, dst, emask, W, bias, B, E, d, residual, mean, s);
  return (int)launch<16>(h_in, h_out, src, dst, emask, W, bias, B, E, d, residual, mean, s);
}

const char* dense_mpnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
