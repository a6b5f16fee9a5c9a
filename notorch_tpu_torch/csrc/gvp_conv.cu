// The fused GVP message convolution, forward and recompute backward, in CUDA
// C++ for sm_90a.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/gvp_conv.py:
//   - _fwd_kernel / fused_gvp_conv_fwd: the fwd_ kernels (the weights'
//     copies, the per-node products, each layer's products, the masked
//     mean);
//   - _bwd_kernel / fused_gvp_conv_bwd: the recompute and reverse sweep
//     (the sweep_ kernels and the sweep_gemm products), the gather's VJP
//     (node_grad_scan_kernel and two node_grad_gemm products), then the
//     weight gradients (wgrad_kernel, wgrad_reduce_kernel).
//
// What they compute. N nodes with K neighbour slots each; row r = n K + k is
// slot k of node n, j = nbrs[n, k]. The gather reads x[j] on a live slot (mask
// set, |j - n| <= W) and zero on any other, as the TPU kernel's one-hot over
// its tile's +-W halo reads for the banded neighbour lists it is given. Per
// row, three GatedGVP layers on the 25 split weights (kernels/gvp_conv.py
// split_gvp_weights):
//   layer 0: vh = v_i Whi + v_j Whj + u whu (each of the 3 components),
//            nrm = sqrt(vh_x^2 + vh_y^2 + vh_z^2 + 1e-8),
//            mid = bm + nrm Wnrm + s_i Wsi + s_j Wsj + rbf Wrbf,
//            gate = sigmoid(bg + mid Wg), s' = relu(mid), v' = (vh Wmu) * gate;
//   layers 1, 2: vh = v Wh, mid = bm + nrm Wnrm + s Ws, the rest alike, the
//            last layer's gate raw;
// then the masked mean of s' and v' over the K slots, the divisor
// max(sum of the mask, 1). Layouts: s [N, ds]; v, out_v [3, N, dv] (the
// components x, y, z); rbf [N K, nb]; u [3, N K]; nbrs int32 [N, K]; mask
// bytes [N, K]; the weights row-major [in, out], as the flax kernels.
//
// Design. The TPU kernel gathers with a one-hot matmul over a tile of 64
// nodes x K rows and runs every product of that tile in VMEM; here a tile of
// 1,024 rows at ds = 256 would not fit a block's 227 KB, and blocks of a few
// nodes' rows would fetch every weight again for every few rows. So both
// entries run the forward layer by layer over all N K rows (forward_layers
// below, the one routine for both):
//   - s_i Wsi, s_j Wsj, v_i Whi and v_j Whj are products of a node's own row,
//     so they are two products over the N nodes ([Wsi | Wsj] and [Whi |
//     Whj] side by side), not over the N K rows, and layer 0's
//     pre-activations gather them by index: the largest products of layer 0
//     shrink K-fold.
//   - Each layer's products are tiled GEMMs (Tile below: a block of 64 x 64
//     outputs for the 256-wide products, 8 x 4 a thread, 32 x 32 for the
//     narrow and vector ones, k-slabs of both operands staged in shared
//     memory in two stages; the three vector components of a product run as
//     one), with the layer's elementwise work in their epilogues: layer 0's
//     gather of the per-node products, the norms, the gates, the ReLU. A
//     64-row tile reads a weight slab once for 64 rows and keeps 32
//     multiply-adds a thread in flight per three shared-memory loads. (The
//     tile shapes were chosen by timing variants side by side on the card.)
//   - The activations go through device memory (an [N K, 256] array is 20 MB
//     at N K = 19,456, under the L2's 50 MB), laid out so each product reads
//     one row-major operand: a layer's scalar input is kept with its norms
//     and a column of ones beside it, and the weights are copied once a call
//     into the matching stacks (the weights kernels). The forward keeps two
//     layers' activations, used in turn; the backward keeps every layer's for
//     its reverse sweep.
//   - The forward ends in the masked mean (fwd_mean_kernel): each node's K
//     rows summed in ascending k.
//   - The backward then runs the reverse sweep the same way, each product
//     with its epilogue. No float atomics. The sums over a node's own K rows
//     (the cotangents of s_i and v_i) run in ascending k
//     (sweep_node_sum_kernel). The gather's VJP into a source row m sums the
//     rows that name m: node_grad_scan_kernel gives each m one warp, which
//     lists those rows once, in ascending order (ballots, in lane order),
//     then sums every column over the list, so each source has one owner and
//     one order. Each weight gradient is X^T G summed over the rows, the
//     gradients that share a cotangent merged into one product (a bias is
//     X's column of ones): one tile of one product over one chunk of 1,024
//     rows a block (wgrad_kernel), the chunks added in ascending order
//     (wgrad_reduce_kernel).
// Each output's sum runs in a fixed order whatever the tile: two calls give
// the same bits, and no result depends on a tile size. Exact f32 on CUDA
// cores throughout, no TF32. The kernels' names carry their stage: fwd_ for
// the forward's (fwd_layer_gemm<l> a layer's products), sweep_ for the
// backward's recompute and reverse sweep, node_grad_ for the gather's VJP,
// wgrad_ for the weight gradients.
//
// What bounds them on this card: the products, a few hundred thousand
// multiply-adds a row against a few kilobytes of its inputs, so operations
// over the f32 rate (67 TFLOP/s on an H100 SXM at 700 W). The design cuts the
// operations (the per-node products) and reuses each weight slab over a
// tile's rows; the activations cost device-memory bytes that the TPU kernel
// kept in VMEM, traded for those tiles, no float atomics and a fixed-order
// weight-gradient reduction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// make_dims' limits
constexpr int kNodeGroup = 8;
constexpr int kMaxSmem = 232448;  // the 227 KB a block may use after the opt-in
constexpr int kNW = 25;
constexpr int kChunk = 1024;      // rows of one weight-gradient partial
constexpr float kEps = 1e-8f;

// split weight indices: layer 0, then layer l = 1, 2 at lw(l, i)
enum { WHI, WHJ, WHU, WMU0, WSI, WSJ, WRBF, WNRM0, BM0, WG0, BG0 };
enum { LWH, LWMU, LWS, LWNRM, LBM, LWG, LBG };
__host__ __device__ constexpr int lw(int l, int i) { return 11 + 7 * (l - 1) + i; }

struct Dims {
  int N, K, ds, dv, nb, W;
  int h0;  // layer 0's hidden vector width, 2 dv + 1
};

__host__ __device__ inline int hidden(const Dims& d, int l) { return l == 0 ? d.h0 : d.dv; }

struct Weights { const float* w[kNW]; };

// The per-row arrays, by layer, R = N K rows: [R, width], or
// [3, R, width] for vectors (component-major), each row at the stride the
// helpers below give (a multiple of 4 where a 16-byte load wants one). The
// backward keeps every layer's (its stash); the forward's layers 0 and 2
// share their arrays but x (fwd_layout), and it has no cotangents.
struct Stash {
  float* x[3];     // layer l's scalar-path input with a column of ones, the
                   // left factor of its pre-activation's product: layer 0
                   // [nrm0 | rbf | 1], layers 1, 2 [relu(mid_{l-1}) | nrm_l | 1]
  float* vh[3];    // 3 x H_l
  float* mid[3];   // [mid | 1], mid before the relu
  float* vmu[3];   // 3 x dv
  float* gate[3];  // dv, after the activation
  float* vin[3];   // 3 x dv, the vector input of layers 1 and 2
  float* gvh[3];   // 3 x H_l
  float* gvmu[3];  // 3 x dv
  float* gmid[3];  // ds
  float* gpre[3];  // dv, the gate pre-activation's cotangent
  float* gs;       // ds, the cotangent of the scalar output of the layer in reverse
  float* gv;       // 3 x dv, of its vector output
  float* gnrm;     // H_l, of its norms
  float* den;      // 1: the mean's divisor max(sum of the node's mask, 1) on a live slot, 0 on a masked one
  float* wx[3];    // the right factor of x[l]'s product: [Wnrm0; Wrbf; bm0], [Ws; Wnrm; bm]
  float* pq;       // [N, 2 ds]: s [Wsi | Wsj], the per-node products P | Q
  float* ab;       // [3, N, 2 h0] (row stride lab): v [Whi | Whj], A | B
  float* wsij;     // [ds, 2 ds]: [Wsi | Wsj]
  float* whij;     // [dv, 2 h0] (row stride lab): [Whi | Whj]
};

// Row strides of the per-row arrays.
__host__ __device__ inline int r4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int xw(const Dims& d, int l) { return l == 0 ? d.h0 + d.nb + 1 : d.ds + d.dv + 1; }
__host__ __device__ inline int lx(const Dims& d, int l) { return r4(xw(d, l)); }
__host__ __device__ inline int lh(const Dims& d, int l) { return l == 0 ? r4(d.h0) : d.dv; }  // vh, gvh, gnrm
__host__ __device__ inline int lm(const Dims& d) { return r4(d.ds + 1); }                  // mid
__host__ __device__ inline int lab(const Dims& d) { return r4(2 * d.h0); }                 // gAB, whij
// layer l's norms inside x[l]
__host__ __device__ inline int nrm_col(const Dims& d, int l) { return l == 0 ? 0 : d.ds; }

// Per-node gradients.
struct Nodes {
  float* gPQ;    // [N, 2 ds]: gP | gQ, the sums of g_mid0 over a node's own rows | over the rows naming it
  float* gAB;    // [3, N, 2 h0] (row stride lab): gA | gB, the same for g_vh0
};

struct Args {
  Dims d;
  const float* s;
  const float* v;
  const int* nbrs;
  const unsigned char* mask;
  const float* rbf;
  const float* u;
  Weights w;
  float* out_s;      // forward
  float* out_v;
  const float* gs;   // backward: the cotangents of out_s, out_v
  const float* gv;
  float* g_s;
  float* g_v;
  float* g_rbf;
  float* g_u;
  Nodes nodes;
  Stash st;
  int layer;         // the layer of a backward launch
};

__device__ inline float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// ---- the products: tiled f32 GEMMs ---------------------------------------------

// An operand as the products read it: element (c, o, i) at p[c cs + o ld + i]
// for o < rows and i < cols, zero outside; o is the outer index (a row in
// memory), i the inner one (contiguous), c a vector's component.
struct Mat {
  const float* p;
  long long cs;
  int ld, rows, cols;
};

// Elements (c, o, i .. i + 3), by one 16-byte load where all four lie inside
// at an aligned address. Nothing here reads the loaded values, so a thread's
// loads of a slab are all in flight at once.
__device__ inline float4 mat4(const Mat& a, int c, int o, int i) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (o < a.rows && i < a.cols) {
    const float* s = a.p + c * a.cs + (long long)o * a.ld + i;
    if (i + 3 < a.cols && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      x = *reinterpret_cast<const float4*>(s);
    } else {
      x.x = s[0];
      if (i + 1 < a.cols) x.y = s[1];
      if (i + 2 < a.cols) x.z = s[2];
      if (i + 3 < a.cols) x.w = s[3];
    }
  }
  return x;
}

__device__ inline void put4(float* s, int stride, float4 x) {
  s[0] = x.x;
  s[stride] = x.y;
  s[2 * stride] = x.z;
  s[3 * stride] = x.w;
}

// C[M, N] = A[M, Kd] B[Kd, N] for k in [k0, k1), NC components of A at once
// (the three of a vector against one B). A block takes a BM x BN tile, a
// thread TM x TN outputs of each component. The k-slabs of both operands
// pass through shared memory in two stages: each thread loads its share of
// the next slab into registers while the block computes on this one, then
// stores it, one barrier a slab (a slab of an operand read along k lands
// transposed, which an asynchronous copy could not do; staging the other
// operands by cp.async timed slower). Each output's sum runs over k in
// ascending order by fmaf. AK: A's memory runs along k (activations, one
// row a row of M), else along m (the weight gradients' X^T, one row a k).
// BKc: B's runs along k (a weight read transposed), else along n.
template <int BM, int BN, int BK, int TM, int TN, int NC, bool AK, bool BKc>
struct Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kLdA = BM + 4, kLdB = BN + 4;
  static constexpr int kStage = NC * BK * kLdA + BK * kLdB;
  static constexpr int kSmem = 2 * kStage;
  static constexpr int kAG = NC * BM * BK / 4, kBG = BK * BN / 4;  // 16-byte groups of a slab
  static constexpr int kAR = (kAG + kThreads - 1) / kThreads, kBR = (kBG + kThreads - 1) / kThreads;
  static constexpr int kNC = NC, kTM = TM, kTN = TN, kBM = BM, kBN = BN;
  // 12 warps an SM: at most 170 registers a thread
  static constexpr int kMinBlocks = kThreads < 384 ? 384 / kThreads : 1;
  static_assert(BM % TM == 0 && BN % TN == 0 && TM % 4 == 0 && TN % 4 == 0 && BK % 4 == 0, "tile shape");

  float4 ra[kAR], rb[kBR];

  // where group g of a slab lies: component c, the slab's row (m or n) and k
  __device__ static void a_pos(int g, int& c, int& m, int& k) {
    c = g / (BM * BK / 4);
    const int rest = g % (BM * BK / 4);
    if (AK) {
      m = rest / (BK / 4);
      k = rest % (BK / 4) * 4;
    } else {
      k = rest / (BM / 4);
      m = rest % (BM / 4) * 4;
    }
  }
  __device__ static void b_pos(int g, int& n, int& k) {
    if (BKc) {
      n = g / (BK / 4);
      k = g % (BK / 4) * 4;
    } else {
      k = g / (BN / 4);
      n = g % (BN / 4) * 4;
    }
  }

  // An operand read along k ends at Kd (its cols), so only one read across
  // k checks k1.
  __device__ void load(const Mat& A, const Mat& B, int m0, int n0, int k0, int k1) {
#pragma unroll
    for (int t = 0; t < kAR; ++t) {
      const int g = threadIdx.x + t * kThreads;
      ra[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < kAG) {
        int c, m, k;
        a_pos(g, c, m, k);
        if (AK)
          ra[t] = mat4(A, c, m0 + m, k0 + k);
        else if (k0 + k < k1)
          ra[t] = mat4(A, c, k0 + k, m0 + m);
      }
    }
#pragma unroll
    for (int t = 0; t < kBR; ++t) {
      const int g = threadIdx.x + t * kThreads;
      rb[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < kBG) {
        int n, k;
        b_pos(g, n, k);
        if (BKc)
          rb[t] = mat4(B, 0, n0 + n, k0 + k);
        else if (k0 + k < k1)
          rb[t] = mat4(B, 0, k0 + k, n0 + n);
      }
    }
  }

  // smem: As [NC, BK, kLdA] (k-major), then Bs [BK, kLdB]
  __device__ void store(float* S) const {
#pragma unroll
    for (int t = 0; t < kAR; ++t) {
      const int g = threadIdx.x + t * kThreads;
      if (g < kAG) {
        int c, m, k;
        a_pos(g, c, m, k);
        float* s = S + (c * BK + k) * kLdA + m;
        const float4 x = ra[t];
        if (AK)
          put4(s, kLdA, x);
        else
          *reinterpret_cast<float4*>(s) = x;
      }
    }
    float* Bs = S + NC * BK * kLdA;
#pragma unroll
    for (int t = 0; t < kBR; ++t) {
      const int g = threadIdx.x + t * kThreads;
      if (g < kBG) {
        int n, k;
        b_pos(g, n, k);
        const float4 x = rb[t];
        if (BKc)
          put4(Bs + k * kLdB + n, kLdB, x);
        else
          *reinterpret_cast<float4*>(Bs + k * kLdB + n) = x;
      }
    }
  }

  __device__ static void compute(const float* S, float (&acc)[TM][NC][TN]) {
    const float* Bs = S + NC * BK * kLdA;
    const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + kk * kLdB + tx * TN + j);
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(S + (c * BK + kk) * kLdA + ty * TM + i);
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][c][j] = fmaf(a[i], b[j], acc[i][c][j]);
      }
    }
  }

  // S holds kSmem floats
  __device__ void run(const Mat& A, const Mat& B, int m0, int n0, int k0, int k1, float* S,
                      float (&acc)[TM][NC][TN]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][c][j] = 0.f;
    if (k0 >= k1) return;
    load(A, B, m0, n0, k0, k1);
    store(S);
    __syncthreads();
    int s = 0;
    for (int k = k0; k < k1; k += BK) {
      const bool more = k + BK < k1;
      if (more) load(A, B, m0, n0, k + BK, k1);
      compute(S + s * kStage, acc);
      if (more) store(S + (s ^ 1) * kStage);
      __syncthreads();
      s ^= 1;
    }
  }

  // epi.row(m, n, cnt, y) for each row m < M of the thread's outputs: y the
  // TN outputs from column n on (cnt of them inside N), NC components each.
  // An epilogue loads what it reads for the whole row before it stores, so
  // those loads are in flight together.
  template <typename Epi>
  __device__ static void finish(const float (&acc)[TM][NC][TN], int m0, int n0, int M, int N, const Epi& epi) {
    const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
    const int n = n0 + tx * TN;
    if (n >= N) return;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m < M) epi.row(m, n, min(TN, N - n), acc[i]);
    }
  }
};

// The products' epilogues: row(m, n, cnt, y) takes the thread's outputs
// y[c][j] at row m, columns n + j for j < cnt (NC components), adds what the
// layer adds there and stores, loading what it reads first.

// stores as they are: out[c cs + m ld + n]
struct StoreRows {
  float* out;
  long long cs;
  int ld;
  template <int NC, int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[NC][TN]) const {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (j < cnt) out[c * cs + (long long)m * ld + n + j] = y[c][j];
  }
};

// the tiles: outputs 64 or more wide; narrow outputs (dv); three components
// of a vector; the per-node products (N rows, not N K: smaller tiles, more
// blocks); the weight gradients' wide and narrow jobs
using TileWide = Tile<64, 64, 16, 8, 4, 1, true, false>;
using TileWideT = Tile<64, 64, 16, 8, 4, 1, true, true>;
using TileNarrow = Tile<32, 32, 16, 4, 4, 1, true, false>;
using TileVec = Tile<32, 32, 8, 4, 4, 3, true, false>;
using TileVecT = Tile<32, 32, 8, 4, 4, 3, true, true>;
using TileNode = Tile<32, 64, 16, 4, 8, 1, true, false>;
using TileNodeT = Tile<32, 64, 16, 4, 8, 1, true, true>;
using TileGradWide = Tile<64, 64, 16, 8, 4, 1, false, false>;
using TileGradNarrow = Tile<32, 32, 16, 4, 4, 1, false, false>;

// One product C = A B on a grid of (M / BM, N / BN) tiles, epi taking each
// output: fwd_node_gemm and fwd_layer_gemm<layer> in the forward, sweep_gemm
// in the backward's recompute and reverse sweep, node_grad_gemm for the
// cotangents of s and v. The kernels differ only in name, the stage a
// profile reads.
template <class T, class Epi>
__device__ void gemm_block(const Mat& A, const Mat& B, int M, int N, int Kd, const Epi& epi) {
  __shared__ __align__(16) float S[T::kSmem];
  T tile;
  float acc[T::kTM][T::kNC][T::kTN];
  const int m0 = blockIdx.x * T::kBM, n0 = blockIdx.y * T::kBN;
  tile.run(A, B, m0, n0, 0, Kd, S, acc);
  T::finish(acc, m0, n0, M, N, epi);
}

template <class T, class Epi>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    fwd_node_gemm(const __grid_constant__ Mat A, const __grid_constant__ Mat B, const int M, const int N,
                  const int Kd, const __grid_constant__ Epi epi) {
  gemm_block<T>(A, B, M, N, Kd, epi);
}

template <int L, class T, class Epi>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    fwd_layer_gemm(const __grid_constant__ Mat A, const __grid_constant__ Mat B, const int M, const int N,
                   const int Kd, const __grid_constant__ Epi epi) {
  gemm_block<T>(A, B, M, N, Kd, epi);
}

template <class T, class Epi>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    sweep_gemm(const __grid_constant__ Mat A, const __grid_constant__ Mat B, const int M, const int N, const int Kd,
               const __grid_constant__ Epi epi) {
  gemm_block<T>(A, B, M, N, Kd, epi);
}

template <class T, class Epi>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    node_grad_gemm(const __grid_constant__ Mat A, const __grid_constant__ Mat B, const int M, const int N,
                   const int Kd, const __grid_constant__ Epi epi) {
  gemm_block<T>(A, B, M, N, Kd, epi);
}

// The weight gradients: a job is X^T G summed over its rows, X [rows, M] and
// G [rows, N] (the sums of the three components of a vector ride as 3 x rows
// rows). A block takes one BM x BN tile of one job over one chunk of kChunk
// rows and writes its partial; wgrad_reduce_kernel adds the chunks in
// ascending order.
struct WJob {
  Mat X, G;
  int rows, M, N, tn, nchunk, tile_off;
  long long part_off;  // the job's partials: [nchunk, M, N]
};

constexpr int kMaxJobs = 10;

struct WJobs {
  WJob j[kMaxJobs];
  int n, tiles;
  float* part;
};

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) wgrad_kernel(const WJobs J) {
  __shared__ __align__(16) float S[T::kSmem];
  __shared__ WJob job;  // the block's job, read at fixed offsets from here on
  if (threadIdx.x == 0) {
    int ji = 0;
    while (ji + 1 < J.n && (int)blockIdx.x >= J.j[ji + 1].tile_off) ++ji;
    job = J.j[ji];
  }
  __syncthreads();
  const int local = blockIdx.x - job.tile_off;
  const int chunk = local % job.nchunk, t = local / job.nchunk;
  const int m0 = t / job.tn * T::kBM, n0 = t % job.tn * T::kBN;
  const int r0 = chunk * kChunk, r1 = min(job.rows, r0 + kChunk);
  T tile;
  float acc[T::kTM][1][T::kTN];
  tile.run(job.X, job.G, m0, n0, r0, r1, S, acc);
  float* part = J.part + job.part_off + (long long)chunk * job.M * job.N;
  T::finish(acc, m0, n0, job.M, job.N, StoreRows{part, 0, job.N});
}

// One of the 25 weight gradients: a [rows, cols] block of its job's result
// at partial offset base (row stride ld), from flattened element off on.
struct WOut {
  float* out;
  long long base, cstride, off;
  int ld, cols, nchunk;
};

struct WOuts {
  WOut o[kNW];
  long long total;
  const float* part;
};

// Each gradient element: its chunks' partials added in ascending order.
__global__ void __launch_bounds__(kThreads) wgrad_reduce_kernel(const WOuts W) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= W.total) return;
  int i = 0;
  while (i + 1 < kNW && e >= W.o[i + 1].off) ++i;
  const WOut& o = W.o[i];
  const long long local = e - o.off;
  const float* src = W.part + o.base + local / o.cols * o.ld + local % o.cols;
  float sum = 0.f;
  for (int c = 0; c < o.nchunk; ++c) sum += src[c * o.cstride];
  o.out[local] = sum;
}

// The gather's VJP into a source row m: kSplit warps share m, each listing
// the rows that gather m (ascending, by ballots in lane order; kList at a
// time, the column sums carried in the output between lists) and summing
// every kSplit-th 32-column slice of their g_mid0 and g_vh0 rows over the
// list: gQ and gB, the right halves of gPQ and gAB.
constexpr int kList = 256;
constexpr int kSplit = 4;

__global__ void __launch_bounds__(kThreads) node_grad_scan_kernel(const Args a) {
  __shared__ int lists[kWarps][kList];
  const Dims& d = a.d;
  const int ds = d.ds, h0 = d.h0, K = d.K, N = d.N, width = ds + 3 * h0;
  const size_t NK = (size_t)N * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * (kWarps / kSplit) + warp / kSplit, slice = warp % kSplit;
  if (m >= N) return;  // the whole warp; no block barrier follows
  int* list = lists[warp];
  const int lo = max(0, m - d.W), hi = min(N - 1, m + d.W);
  const size_t base = (size_t)lo * K;
  const int ncand = (hi - lo + 1) * K;
  int start = 0;
  do {
    int cnt = 0, p0 = start;
    for (; p0 < ncand && cnt + 128 <= kList; p0 += 128) {  // four ballots' loads in flight
      bool hit[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + 32 * q + lane;
        const size_t r = base + (p < ncand ? p : 0);
        const unsigned char on = a.mask[r];
        const int j = a.nbrs[r];
        hit[q] = p < ncand && on != 0 && j == m;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned bits = __ballot_sync(0xffffffffu, hit[q]);
        if (hit[q]) list[cnt + __popc(bits & ((1u << lane) - 1u))] = (int)(base + p0 + 32 * q + lane);
        cnt += __popc(bits);
      }
    }
    __syncwarp();
    for (int c = 32 * slice + lane; c < width; c += 32 * kSplit) {
      float* out;
      const float* src;
      size_t stride;
      if (c < ds) {
        out = a.nodes.gPQ + (size_t)m * 2 * ds + ds + c;
        src = a.st.gmid[0] + c;
        stride = ds;
      } else {
        const int comp = (c - ds) / h0, cc = (c - ds) % h0;
        out = a.nodes.gAB + ((size_t)comp * N + m) * lab(d) + h0 + cc;
        stride = lh(d, 0);
        src = a.st.gvh[0] + comp * NK * stride + cc;
      }
      float acc = start == 0 ? 0.f : *out;
      int t = 0;
      for (; t + 8 <= cnt; t += 8) {  // eight loads in flight, added in list order
        float x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] = src[(size_t)list[t + q] * stride];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc += x[q];
      }
      for (; t < cnt; ++t) acc += src[(size_t)list[t] * stride];
      *out = acc;
    }
    __syncwarp();
    start = p0;
  } while (start < ncand);
}

// ---- the forward's elementwise kernels, and the reverse sweep's ----------------

// The row r = n K + k gathers source j, or -1 (zero) on a masked slot or one
// whose j lies outside the node range or the band.
__device__ inline int source_of(const int* nbrs, const unsigned char* mask, int N, int K, int W, int r) {
  const int n = r / K, j = nbrs[r];
  return mask[r] != 0 && j >= 0 && j < N && j - n <= W && n - j <= W ? j : -1;
}

// Copies of the weights side by side or one above another, as the products
// read them (Stash.wx, wsij, whij): one launch for all (fwd_weights_kernel,
// sweep_weights_kernel).
struct Copy {
  const float* src;
  float* dst;
  long long off;  // first element in the flattened index
  int rows, cols, ld, r0, c0;
};

constexpr int kCopies = 13;

struct Copies {
  Copy c[kCopies];
  long long total;
};

__device__ void copy_weights(const Copies& C) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C.total) return;
  int i = 0;
  while (i + 1 < kCopies && e >= C.c[i + 1].off) ++i;
  const Copy& c = C.c[i];
  const long long local = e - c.off;
  const int r = (int)(local / c.cols), col = (int)(local % c.cols);
  c.dst[(long long)(c.r0 + r) * c.ld + c.c0 + col] = c.src[local];
}

__global__ void __launch_bounds__(kThreads) fwd_weights_kernel(const Copies C) { copy_weights(C); }
__global__ void __launch_bounds__(kThreads) sweep_weights_kernel(const Copies C) { copy_weights(C); }

// Layer 0's hidden vectors vh = A[n] + B[j] + u whu (Stash.ab), x0 = [their
// norms | rbf | 1], the columns of ones of x1, x2 and mid, and the masked
// mean's divisor of each row (Stash.den): fwd_layer0_in_kernel,
// sweep_layer0_in_kernel.
__device__ void layer0_in(const Args& a) {
  const Dims& d = a.d;
  const int h0 = d.h0, nb = d.nb, ds = d.ds, K = d.K, N = d.N, R = N * K, w = max(h0, nb);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * w) return;
  const int r = (int)(i / w), c = (int)(i % w), n = r / K;
  float* x0 = a.st.x[0] + (size_t)r * lx(d, 0);
  if (c < h0) {
    const int j = source_of(a.nbrs, a.mask, N, K, d.W, r);
    const float whu = a.w.w[WHU][c];
    const int ldh = lh(d, 0);
    float x[3];
    const float* ab = a.st.ab;
    const int ldab = lab(d);
    for (int comp = 0; comp < 3; ++comp) {
      x[comp] = ab[((size_t)comp * N + n) * ldab + c] + (j >= 0 ? ab[((size_t)comp * N + j) * ldab + h0 + c] : 0.f);
      x[comp] = x[comp] + a.u[(size_t)comp * R + r] * whu;
      a.st.vh[0][((size_t)comp * R + r) * ldh + c] = x[comp];
    }
    x0[c] = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + kEps);
  }
  if (c < nb) x0[h0 + c] = a.rbf[(size_t)r * nb + c];
  if (c == 0) {
    x0[h0 + nb] = 1.f;
    for (int l = 1; l <= 2; ++l) a.st.x[l][(size_t)r * lx(d, l) + ds + d.dv] = 1.f;
    for (int l = 0; l <= 2; ++l) a.st.mid[l][(size_t)r * lm(d) + ds] = 1.f;
    float cnt = 0.f;
    for (int k = 0; k < K; ++k) cnt += a.mask[(size_t)n * K + k] != 0 ? 1.f : 0.f;
    a.st.den[r] = a.mask[r] != 0 ? fmaxf(cnt, 1.f) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) fwd_layer0_in_kernel(const Args a) { layer0_in(a); }
__global__ void __launch_bounds__(kThreads) sweep_layer0_in_kernel(const Args a) { layer0_in(a); }

// The forward's outputs: the masked mean of the last layer's relu(mid) and
// (v Wmu) gate over each node's K rows, summed in ascending k and divided by
// max(sum of the node's mask, 1).
__global__ void __launch_bounds__(kThreads) fwd_mean_kernel(const Args a) {
  const Dims& d = a.d;
  const int ds = d.ds, dv = d.dv, K = d.K, N = d.N;
  const long long RD = (long long)N * K * dv, ns = (long long)N * ds;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ns + 3LL * N * dv) return;
  const bool scalar = i < ns;
  const long long e = scalar ? i : i - ns;  // out_s [N, ds], out_v [3, N, dv]
  const int width = scalar ? ds : dv;
  const int comp = scalar ? 0 : (int)(e / ((long long)N * dv));
  const int n = (int)(e / width % N), c = (int)(e % width);
  const float* mid = a.st.mid[2];
  const float* vmu = a.st.vmu[2] + comp * RD;
  const float* gate = a.st.gate[2];
  float sum = 0.f, cnt = 0.f;
  for (int k = 0; k < K; ++k) {
    const size_t r = (size_t)n * K + k;
    const float on = a.mask[r] != 0 ? 1.f : 0.f;
    const float x = scalar ? fmaxf(mid[r * lm(d) + c], 0.f) : vmu[r * dv + c] * gate[r * dv + c];
    sum += x * on;
    cnt += on;
  }
  (scalar ? a.out_s : a.out_v)[e] = sum / fmaxf(cnt, 1.f);
}

// The masked mean's cotangents on each row, g / den on a live slot and 0 on
// a masked one: the scalar's, then the vector's.
__global__ void __launch_bounds__(kThreads) sweep_mean_grad_kernel(const Args a) {
  const Dims& d = a.d;
  const int ds = d.ds, dv = d.dv, K = d.K, N = d.N, R = N * K;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ns = (long long)R * ds;
  if (i >= ns + 3LL * R * dv) return;
  const bool scalar = i < ns;
  const long long e = scalar ? i : i - ns;
  const int width = scalar ? ds : dv;
  const int comp = scalar ? 0 : (int)(e / ((long long)R * dv));
  const int r = (int)(e / width % R), c = (int)(e % width), n = r / K;
  const float den = a.st.den[r];
  (scalar ? a.st.gs : a.st.gv)[e] =
      den > 0.f ? (scalar ? a.gs[(size_t)n * ds + c] : a.gv[((size_t)comp * N + n) * dv + c]) / den : 0.f;
}

// The gate's reverse in layer a.layer: g_pre = (sum_c gv_c vmu_c) times the
// sigmoid's slope (the last layer's gate is raw), and g_vmu = gv gate.
__global__ void __launch_bounds__(kThreads) sweep_gate_grad_kernel(const Args a) {
  const int l = a.layer, dv = a.d.dv;
  const long long RD = (long long)a.d.N * a.d.K * dv;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= RD) return;
  const float gate = a.st.gate[l][i];
  float g_gate = 0.f;
  for (int comp = 0; comp < 3; ++comp) g_gate += a.st.gv[comp * RD + i] * a.st.vmu[l][comp * RD + i];
  a.st.gpre[l][i] = l < 2 ? g_gate * gate * (1.f - gate) : g_gate;
  for (int comp = 0; comp < 3; ++comp) a.st.gvmu[l][comp * RD + i] = a.st.gv[comp * RD + i] * gate;
}

// Layer 0's cotangents summed over each node's own K rows in ascending k (gP
// and gA, the left halves of gPQ and gAB), and g_u = g_vh0 whu per row.
__global__ void __launch_bounds__(kThreads) sweep_node_sum_kernel(const Args a) {
  const Dims& d = a.d;
  const int ds = d.ds, h0 = d.h0, K = d.K, N = d.N, R = N * K, ldh = lh(d, 0);
  const long long np = (long long)N * ds, na = 3LL * N * h0;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float* gvh = a.st.gvh[0];
  if (i < np) {
    const int n = (int)(i / ds), c = (int)(i % ds);
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += a.st.gmid[0][((size_t)n * K + k) * ds + c];
    a.nodes.gPQ[(size_t)n * 2 * ds + c] = acc;
  } else if (i < np + na) {
    const long long e = i - np;
    const int comp = (int)(e / ((long long)N * h0)), n = (int)(e / h0 % N), c = (int)(e % h0);
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += gvh[((size_t)comp * R + (size_t)n * K + k) * ldh + c];
    a.nodes.gAB[((size_t)comp * N + n) * lab(d) + c] = acc;
  } else if (i < np + na + 3LL * R) {
    const long long e = i - np - na;
    const float* g = gvh + e * ldh;
    const float* whu = a.w.w[WHU];
    float acc = 0.f;
    for (int h = 0; h < h0; ++h) acc = fmaf(g[h], whu[h], acc);
    a.g_u[e] = acc;
  }
}

// A thread's cnt (at most TN) consecutive elements of a row at p, by 16-byte
// accesses where all TN lie inside at an aligned address; a load gives 0
// past cnt.
template <int TN>
__device__ inline bool whole(const float* p, int cnt) {
  return cnt == TN && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int TN>
__device__ inline void get_row(const float* p, float (&x)[TN], int cnt) {
  if (whole<TN>(p, cnt)) {
#pragma unroll
    for (int t = 0; t < TN; t += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + t);
      x[t] = v.x;
      x[t + 1] = v.y;
      x[t + 2] = v.z;
      x[t + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < TN; ++t) x[t] = t < cnt ? p[t] : 0.f;
  }
}

template <int TN>
__device__ inline void put_row(float* p, const float (&x)[TN], int cnt) {
  if (whole<TN>(p, cnt)) {
#pragma unroll
    for (int t = 0; t < TN; t += 4) *reinterpret_cast<float4*>(p + t) = make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (t < cnt) p[t] = x[t];
  }
}

// a layer's pre-activation mid: + the bias (layer 0 also + P[node] +
// Q[source], from pq), and relu(mid) into the next layer's x
struct MidEpi {
  float *mid, *xn;  // xn null for the last layer
  const float *bias, *pq;
  const int* nbrs;
  const unsigned char* mask;
  int N, K, W, ds, ldm, ldx;
  template <int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[1][TN]) const {
    float x[TN], b[TN];
    get_row(bias + n, b, cnt);
    if (pq) {
      const int j = source_of(nbrs, mask, N, K, W, m);
      float P[TN], Q[TN];
      get_row(pq + (size_t)(m / K) * 2 * ds + n, P, cnt);
      get_row(pq + (size_t)(j >= 0 ? j : 0) * 2 * ds + ds + n, Q, j >= 0 ? cnt : 0);
#pragma unroll
      for (int t = 0; t < TN; ++t) x[t] = y[0][t] + b[t] + P[t] + Q[t];
    } else {
#pragma unroll
      for (int t = 0; t < TN; ++t) x[t] = y[0][t] + b[t];
    }
    put_row(mid + (size_t)m * ldm + n, x, cnt);
    if (xn) {
#pragma unroll
      for (int t = 0; t < TN; ++t) x[t] = fmaxf(x[t], 0.f);
      put_row(xn + (size_t)m * ldx + n, x, cnt);
    }
  }
};

// + a bias, then the gate's sigmoid where act is set
struct BiasEpi {
  float* out;
  const float* bias;
  int ld, act;
  template <int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[1][TN]) const {
    float g[TN];
    get_row(bias + n, g, cnt);
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      g[t] = y[0][t] + g[t];
      if (act) g[t] = sigmoidf(g[t]);
    }
    put_row(out + (size_t)m * ld + n, g, cnt);
  }
};

// v Wmu where vmu is set (the backward's stash, the forward's last layer),
// and the layer's vector output (v Wmu) gate where a next layer takes it
struct VmuEpi {
  float *vmu, *vout;
  const float* gate;
  long long cs;
  int dv;
  template <int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[3][TN]) const {
    const size_t o = (size_t)m * dv + n;
    float g[TN];
    get_row(gate + o, g, vout ? cnt : 0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (vmu) put_row(vmu + c * cs + o, y[c], cnt);
      if (vout) {
        float x[TN];
#pragma unroll
        for (int t = 0; t < TN; ++t) x[t] = y[c][t] * g[t];
        put_row(vout + c * cs + o, x, cnt);
      }
    }
  }
};

// the hidden vectors, and their norms into x
struct VhEpi {
  float *vh, *nrm;
  long long cs;
  int ldh, ldn;
  template <int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[3][TN]) const {
    float x[TN];
#pragma unroll
    for (int c = 0; c < 3; ++c) put_row(vh + c * cs + (size_t)m * ldh + n, y[c], cnt);
#pragma unroll
    for (int t = 0; t < TN; ++t) x[t] = sqrtf(y[0][t] * y[0][t] + y[1][t] * y[1][t] + y[2][t] * y[2][t] + kEps);
    put_row(nrm + (size_t)m * ldn + n, x, cnt);
  }
};

// g_mid = relu'(mid) gs + g_pre Wg^T
struct GmidEpi {
  float* gmid;
  const float *mid, *gs;
  int ds, ldm;
  template <int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[1][TN]) const {
    const size_t o = (size_t)m * ds + n, om = (size_t)m * ldm + n;
    float x[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (t < cnt) {
        const float g = gs[o + t];
        x[t] = (mid[om + t] > 0.f ? g : 0.f) + y[0][t];
      }
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (t < cnt) gmid[o + t] = x[t];
  }
};

// columns [0, n1) to out1, the rest to out2
struct SplitEpi {
  float *out1, *out2;
  int ld1, ld2, n1;
  template <int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[1][TN]) const {
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (t < cnt) {
        if (n + t < n1)
          out1[(size_t)m * ld1 + n + t] = y[0][t];
        else
          out2[(size_t)m * ld2 + n + t - n1] = y[0][t];
      }
  }
};

// g_vh = g_vmu Wmu^T + g_nrm vh / nrm
struct GvhEpi {
  float* gvh;
  const float *gnrm, *vh, *nrm;
  long long cs;
  int ldh, ldn;
  template <int TN>
  __device__ void row(int m, int n, int cnt, const float (&y)[3][TN]) const {
    const size_t o = (size_t)m * ldh + n;
    float x[3][TN];
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (t < cnt) {
        const float gn = gnrm[o + t], nr = nrm[(size_t)m * ldn + n + t];
        for (int c = 0; c < 3; ++c) x[c][t] = y[c][t] + gn * vh[c * cs + o + t] / nr;
      }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int t = 0; t < TN; ++t)
        if (t < cnt) gvh[c * cs + o + t] = x[c][t];
  }
};

// ---- host side ---------------------------------------------------------------

// The [in, out] shape of split weight i; a bias gives {0, out}.
void weight_shape(const Dims& d, int i, int& rows, int& cols) {
  const int ds = d.ds, dv = d.dv, h0 = d.h0;
  static const int kinds0[11] = {0, 0, 1, 2, 3, 3, 4, 5, 6, 7, 8};
  int in = 0, out = 0;
  if (i < 11) {
    switch (kinds0[i]) {
      case 0: in = dv; out = h0; break;   // Whi, Whj
      case 1: in = 1; out = h0; break;    // whu
      case 2: in = h0; out = dv; break;   // Wmu0
      case 3: in = ds; out = ds; break;   // Wsi, Wsj
      case 4: in = d.nb; out = ds; break; // Wrbf
      case 5: in = h0; out = ds; break;   // Wnrm0
      case 6: in = 0; out = ds; break;    // bm0
      case 7: in = ds; out = dv; break;   // Wg0
      default: in = 0; out = dv; break;   // bg0
    }
  } else {
    switch ((i - 11) % 7) {
      case LWH: case LWMU: in = dv; out = dv; break;
      case LWS: in = ds; out = ds; break;
      case LWNRM: in = dv; out = ds; break;
      case LBM: in = 0; out = ds; break;
      case LWG: in = ds; out = dv; break;
      default: in = 0; out = dv; break;
    }
  }
  rows = in;
  cols = out;
}

// The shapes both entries take: those of an earlier forward whose blocks held
// one node's K rows and their activations in shared memory, and whose
// prologue held kNodeGroup nodes' features. Neither entry uses such a block
// now; the limits stay, so the entries refuse what they refused.
bool make_dims(int N, int K, int ds, int dv, int nb, int W, Dims& d) {
  if (N <= 0 || K <= 0 || ds <= 0 || dv <= 0 || nb <= 0 || W < 0) return false;
  d = Dims{N, K, ds, dv, nb, W, 2 * dv + 1 > dv ? 2 * dv + 1 : dv};
  const size_t rows = (size_t)K * (2 * ds + 4 * d.h0 + 4 * dv + nb + 5) * sizeof(float);
  const size_t nodes = (size_t)kNodeGroup * (ds + 3 * dv) * sizeof(float);
  return rows <= (size_t)kMaxSmem && nodes <= (size_t)kMaxSmem;
}

// Carves the scratch (or, with base null, counts it) in floats.
struct Cursor {
  float* base;
  size_t off = 0;
  float* take(size_t n) {
    float* p = base ? base + off : nullptr;
    off += n;
    return p;
  }
};

Mat mat(const float* p, int rows, int cols, int ld, long long cs = 0) { return Mat{p, cs, ld, rows, cols}; }

// The weight-gradient launches: the wide jobs (TileGradWide), the narrow
// ones (TileGradNarrow), and where each of the 25 gradients lies in them.
struct Grads {
  WJobs wide, narrow;
  WOuts outs;
};

template <class T>
WJob& add_job(WJobs& J, long long& part, const Mat& X, const Mat& G) {
  WJob& job = J.j[J.n++];
  const int rows = X.rows, M = X.cols, N = G.cols;
  job = WJob{X, G, rows, M, N, (N + T::kBN - 1) / T::kBN, (rows + kChunk - 1) / kChunk, J.tiles, part};
  J.tiles += (M + T::kBM - 1) / T::kBM * job.tn * job.nchunk;
  part += (long long)job.nchunk * M * N;
  return job;
}

// gradient i is the block of job's result from row moff, column noff
void add_out(const Dims& d, WOuts& O, int i, const WJob& job, int moff, int noff, float* out) {
  int in, cols;
  weight_shape(d, i, in, cols);
  O.o[i] = WOut{out, job.part_off + (long long)moff * job.N + noff, (long long)job.M * job.N,
                (long long)(in > 0 ? in : 1) * cols, job.N, cols, job.nchunk};
}

void add_copy(const Dims& d, Copies& C, int& ci, const float* src, int i, float* dst, int ld, int r0, int c0) {
  int rows, cols;
  weight_shape(d, i, rows, cols);
  if (rows == 0) rows = 1;
  C.c[ci++] = Copy{src, dst, C.total, rows, cols, ld, r0, c0};
  C.total += (long long)rows * cols;
}

// The weights as the products read them (Stash.wx, wsij, whij).
void weight_copies(const Dims& d, const Weights& W, const Stash& st, Copies& C) {
  const int ds = d.ds, dv = d.dv, h0 = d.h0, nb = d.nb;
  const float* const* w = W.w;
  C = Copies{};
  int ci = 0;
  add_copy(d, C, ci, w[WNRM0], WNRM0, st.wx[0], ds, 0, 0);
  add_copy(d, C, ci, w[WRBF], WRBF, st.wx[0], ds, h0, 0);
  add_copy(d, C, ci, w[BM0], BM0, st.wx[0], ds, h0 + nb, 0);
  for (int l = 1; l <= 2; ++l) {
    add_copy(d, C, ci, w[lw(l, LWS)], lw(l, LWS), st.wx[l], ds, 0, 0);
    add_copy(d, C, ci, w[lw(l, LWNRM)], lw(l, LWNRM), st.wx[l], ds, ds, 0);
    add_copy(d, C, ci, w[lw(l, LBM)], lw(l, LBM), st.wx[l], ds, ds + dv, 0);
  }
  add_copy(d, C, ci, w[WSI], WSI, st.wsij, 2 * ds, 0, 0);
  add_copy(d, C, ci, w[WSJ], WSJ, st.wsij, 2 * ds, 0, ds);
  add_copy(d, C, ci, w[WHI], WHI, st.whij, lab(d), 0, 0);
  add_copy(d, C, ci, w[WHJ], WHJ, st.whij, lab(d), 0, h0);
}

// Lays out the backward's scratch at base (nodes, stash, partials), the
// weights' copies and the weight-gradient jobs, and returns its size in
// floats; with gw null the gradients' outputs are left unset.
size_t bwd_layout(const Dims& d, float* base, const float* s, const float* v, const float* u,
                  float* const* gw, Args& a, Grads& gr, Copies& C) {
  Cursor cur{base};
  const size_t N = d.N, NK = N * d.K;
  const int ds = d.ds, dv = d.dv, h0 = d.h0, nb = d.nb, n = d.N, R = (int)NK;
  a.nodes = Nodes{cur.take(2 * N * ds), cur.take(3 * N * lab(d))};
  Stash& st = a.st;
  for (int l = 0; l < 3; ++l) {
    st.x[l] = cur.take(NK * lx(d, l));
    st.vh[l] = cur.take(3 * NK * lh(d, l));
    st.mid[l] = cur.take(NK * lm(d));
    st.vmu[l] = cur.take(3 * NK * dv);
    st.gate[l] = cur.take(NK * dv);
    st.vin[l] = l > 0 ? cur.take(3 * NK * dv) : nullptr;
    st.gvh[l] = cur.take(3 * NK * lh(d, l));
    st.gvmu[l] = cur.take(3 * NK * dv);
    st.gmid[l] = cur.take(NK * ds);
    st.gpre[l] = cur.take(NK * dv);
    st.wx[l] = cur.take((size_t)xw(d, l) * ds);
  }
  st.gs = cur.take(NK * ds);
  st.gv = cur.take(3 * NK * dv);
  st.gnrm = cur.take(NK * lh(d, 0));
  st.den = cur.take(NK);
  st.pq = cur.take(N * 2 * ds);
  st.ab = cur.take(3 * N * lab(d));
  st.wsij = cur.take((size_t)2 * ds * ds);
  st.whij = cur.take((size_t)dv * lab(d));
  weight_copies(d, a.w, st, C);
  // the weight gradients, X^T G over the rows
  gr = Grads{};
  long long part = 0;
  float* none[kNW] = {};
  float* const* g = gw ? gw : none;
  const Nodes& nd = a.nodes;
  WOuts& O = gr.outs;
  using TW = TileGradWide;
  using TN = TileGradNarrow;
  // the node rows: s^T [gP | gQ] and v^T [gA | gB] (three components as 3 N rows)
  const WJob& js = add_job<TW>(gr.wide, part, mat(s, n, ds, ds), mat(nd.gPQ, n, 2 * ds, 2 * ds));
  add_out(d, O, WSI, js, 0, 0, g[WSI]);
  add_out(d, O, WSJ, js, 0, ds, g[WSJ]);
  const WJob& jv = add_job<TN>(gr.narrow, part, mat(v, 3 * n, dv, dv), mat(nd.gAB, 3 * n, 2 * h0, lab(d)));
  add_out(d, O, WHI, jv, 0, 0, g[WHI]);
  add_out(d, O, WHJ, jv, 0, h0, g[WHJ]);
  // layer 0: u^T g_vh0, vh0^T g_vmu0, x0^T g_mid0, [mid0 | 1]^T g_pre0
  add_out(d, O, WHU, add_job<TN>(gr.narrow, part, mat(u, 3 * R, 1, 1), mat(st.gvh[0], 3 * R, h0, lh(d, 0))), 0, 0,
          g[WHU]);
  add_out(d, O, WMU0, add_job<TN>(gr.narrow, part, mat(st.vh[0], 3 * R, h0, lh(d, 0)), mat(st.gvmu[0], 3 * R, dv, dv)),
          0, 0, g[WMU0]);
  for (int l = 0; l <= 2; ++l) {
    if (l > 0) {  // vin^T g_vh, vh^T g_vmu
      const int ih = lw(l, LWH), imu = lw(l, LWMU);
      add_out(d, O, ih, add_job<TN>(gr.narrow, part, mat(st.vin[l], 3 * R, dv, dv), mat(st.gvh[l], 3 * R, dv, dv)),
              0, 0, g[ih]);
      add_out(d, O, imu, add_job<TN>(gr.narrow, part, mat(st.vh[l], 3 * R, dv, dv), mat(st.gvmu[l], 3 * R, dv, dv)),
              0, 0, g[imu]);
    }
    // x^T g_mid: [Wnrm0; Wrbf; bm0] or [Ws; Wnrm; bm]
    const WJob& jm = add_job<TW>(gr.wide, part, mat(st.x[l], R, xw(d, l), lx(d, l)), mat(st.gmid[l], R, ds, ds));
    const int i1 = l == 0 ? WNRM0 : lw(l, LWS), i2 = l == 0 ? WRBF : lw(l, LWNRM), i3 = l == 0 ? BM0 : lw(l, LBM);
    const int k1 = l == 0 ? h0 : ds, k2 = k1 + (l == 0 ? nb : dv);
    add_out(d, O, i1, jm, 0, 0, g[i1]);
    add_out(d, O, i2, jm, k1, 0, g[i2]);
    add_out(d, O, i3, jm, k2, 0, g[i3]);
    // [mid | 1]^T g_pre: [Wg; bg]
    const WJob& jg = add_job<TN>(gr.narrow, part, mat(st.mid[l], R, ds + 1, lm(d)), mat(st.gpre[l], R, dv, dv));
    const int ig = l == 0 ? WG0 : lw(l, LWG), ib = l == 0 ? BG0 : lw(l, LBG);
    add_out(d, O, ig, jg, 0, 0, g[ig]);
    add_out(d, O, ib, jg, ds, 0, g[ib]);
  }
  for (int i = 0; i < kNW; ++i) {
    const long long size = O.o[i].off;  // add_out left the element count there
    O.o[i].off = O.total;
    O.total += size;
  }
  float* p = cur.take((size_t)part);
  gr.wide.part = gr.narrow.part = p;
  O.part = p;
  return cur.off;
}

// Lays out the forward's scratch at base and the weights' copies, and
// returns its size in floats: two sets of a layer's activations, layer l's
// in set l % 2 (layer 2 overwrites layer 0's once layer 1 has read them;
// layer 0's input x has its own array, as the ones of x[2] are written
// before layer 0 runs; v Wmu only of the last layer, which the mean reads),
// the weight stacks, the per-node products and the rows' divisors.
size_t fwd_layout(const Dims& d, float* base, Args& a, Copies& C) {
  Cursor cur{base};
  const size_t N = d.N, NK = N * d.K;
  const int ds = d.ds, dv = d.dv;
  Stash& st = a.st;
  st = Stash{};
  for (int set = 0; set < 2; ++set) {
    const int l = set == 0 ? 2 : 1;  // the layer whose x and vin the set holds
    st.x[l] = cur.take(NK * lx(d, l));
    float* vh = cur.take(3 * NK * lh(d, set == 0 ? 0 : 1));
    float* mid = cur.take(NK * lm(d));
    float* gate = cur.take(NK * dv);
    st.vin[l] = cur.take(3 * NK * dv);
    for (int m = set; m < 3; m += 2) {
      st.vh[m] = vh;
      st.mid[m] = mid;
      st.gate[m] = gate;
    }
  }
  st.vmu[2] = cur.take(3 * NK * dv);  // the mean reads the last layer's; the others are not kept
  st.x[0] = cur.take(NK * lx(d, 0));
  for (int l = 0; l < 3; ++l) st.wx[l] = cur.take((size_t)xw(d, l) * ds);
  st.pq = cur.take(N * 2 * ds);
  st.ab = cur.take(3 * N * lab(d));
  st.wsij = cur.take((size_t)2 * ds * ds);
  st.whij = cur.take((size_t)dv * lab(d));
  st.den = cur.take(NK);
  weight_copies(d, a.w, st, C);
  return cur.off;
}

long long blocks(long long items) { return (items + kThreads - 1) / kThreads; }

template <typename Arg>
cudaError_t launch(void (*kernel)(const Arg), long long blocks, cudaStream_t stream, const Arg& arg,
                   int threads = kThreads) {
  if (blocks <= 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(arg);
  return cudaGetLastError();
}

// The stage of a product, the name its kernel carries: a layer l of the
// forward (fwd_layer_gemm<l>), or one of these.
enum { kFwdNode = -1, kSweep = -2, kNodeGrad = -3 };

// C = A B, C [M, N], by the kernel of stage kStage
template <int kStage, class T, class Epi>
cudaError_t gemm(const Mat& A, const Mat& B, int M, int N, int Kd, const Epi& epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const dim3 grid((M + T::kBM - 1) / T::kBM, (N + T::kBN - 1) / T::kBN);
  if constexpr (kStage == kFwdNode)
    fwd_node_gemm<T, Epi><<<grid, T::kThreads, 0, stream>>>(A, B, M, N, Kd, epi);
  else if constexpr (kStage == kSweep)
    sweep_gemm<T, Epi><<<grid, T::kThreads, 0, stream>>>(A, B, M, N, Kd, epi);
  else if constexpr (kStage == kNodeGrad)
    node_grad_gemm<T, Epi><<<grid, T::kThreads, 0, stream>>>(A, B, M, N, Kd, epi);
  else
    fwd_layer_gemm<kStage, T, Epi><<<grid, T::kThreads, 0, stream>>>(A, B, M, N, Kd, epi);
  return cudaGetLastError();
}

// Layer L over all rows: vh = v Wh and its norms (layers 1, 2); mid = x
// [Wnrm0; Wrbf] + bm0 + P + Q, or x [Ws; Wnrm] + bm (x without its ones),
// and relu(mid) into the next layer's x; the gate; v Wmu, and (v Wmu) gate
// into the next layer's v. kFwd: the forward's kernels, else the backward's.
template <bool kFwd, int L>
cudaError_t forward_layer(const Args& a, cudaStream_t st) {
  constexpr int kStage = kFwd ? L : kSweep;
  const Dims& d = a.d;
  const Stash& S = a.st;
  const float* const* w = a.w.w;
  const int H = hidden(d, L), R = d.N * d.K, ds = d.ds, dv = d.dv;
  const long long RD = (long long)R * dv;
  cudaError_t err = cudaSuccess;
  if constexpr (L > 0)
    err = gemm<kStage, TileVec>(mat(S.vin[L], R, dv, dv, RD), mat(w[lw(L, LWH)], dv, dv, dv), R, dv, dv,
                                VhEpi{S.vh[L], S.x[L] + nrm_col(d, L), RD, dv, lx(d, L)}, st);
  const int kx = xw(d, L) - 1, ib = L == 0 ? BM0 : lw(L, LBM);
  if (err == cudaSuccess)
    err = gemm<kStage, TileWide>(mat(S.x[L], R, kx, lx(d, L)), mat(S.wx[L], kx, ds, ds), R, ds, kx,
                                 MidEpi{S.mid[L], L < 2 ? S.x[L + 1] : nullptr, w[ib], L == 0 ? S.pq : nullptr,
                                        a.nbrs, a.mask, d.N, d.K, d.W, ds, lm(d), L < 2 ? lx(d, L + 1) : 0}, st);
  if (err == cudaSuccess)
    err = gemm<kStage, TileNarrow>(mat(S.mid[L], R, ds, lm(d)), mat(w[L == 0 ? WG0 : lw(L, LWG)], ds, dv, dv), R,
                                   dv, ds, BiasEpi{S.gate[L], w[L == 0 ? BG0 : lw(L, LBG)], dv, L < 2}, st);
  if (err == cudaSuccess)
    err = gemm<kStage, TileVec>(mat(S.vh[L], R, H, lh(d, L), (long long)R * lh(d, L)),
                                mat(w[L == 0 ? WMU0 : lw(L, LWMU)], H, dv, dv), R, dv, H,
                                VmuEpi{kFwd && L < 2 ? nullptr : S.vmu[L], L < 2 ? S.vin[L + 1] : nullptr, S.gate[L],
                                       RD, dv}, st);
  return err;
}

// The forward's layers over all N K rows, as both entries run them: the
// weights' copies, the per-node products P | Q = s [Wsi | Wsj] and A | B =
// v [Whi | Whj], layer 0's input, then the three layers. What a.st holds
// decides what is kept: the backward's stash keeps every layer's arrays.
template <bool kFwd>
cudaError_t forward_layers(const Args& a, const Copies& C, cudaStream_t st) {
  constexpr int kNode = kFwd ? kFwdNode : kSweep;
  const Dims& d = a.d;
  const Stash& S = a.st;
  const int n = d.N, ds = d.ds, dv = d.dv, h0 = d.h0, R = d.N * d.K;
  cudaError_t err = launch(kFwd ? fwd_weights_kernel : sweep_weights_kernel, blocks(C.total), st, C);
  if (err == cudaSuccess)
    err = gemm<kNode, TileNode>(mat(a.s, n, ds, ds), mat(S.wsij, ds, 2 * ds, 2 * ds), n, 2 * ds, ds,
                                StoreRows{S.pq, 0, 2 * ds}, st);
  if (err == cudaSuccess)
    err = gemm<kNode, TileVec>(mat(a.v, n, dv, dv, (long long)n * dv), mat(S.whij, dv, 2 * h0, lab(d)), n, 2 * h0,
                               dv, StoreRows{S.ab, (long long)n * lab(d), lab(d)}, st);
  if (err == cudaSuccess)
    err = launch(kFwd ? fwd_layer0_in_kernel : sweep_layer0_in_kernel, blocks((long long)R * (h0 > d.nb ? h0 : d.nb)),
                 st, a);
  if (err == cudaSuccess) err = forward_layer<kFwd, 0>(a, st);
  if (err == cudaSuccess) err = forward_layer<kFwd, 1>(a, st);
  if (err == cudaSuccess) err = forward_layer<kFwd, 2>(a, st);
  return err;
}

Args base_args(const Dims& d, const float* s, const float* v, const int* nbrs, const unsigned char* mask,
               const float* rbf, const float* u, const float* const* w) {
  Args a{};
  a.d = d;
  a.s = s;
  a.v = v;
  a.nbrs = nbrs;
  a.mask = mask;
  a.rbf = rbf;
  a.u = u;
  for (int i = 0; i < kNW; ++i) a.w.w[i] = w[i];
  return a;
}

}  // namespace

extern "C" {

// 0 when the kernels take these shapes (make_dims), else
// cudaErrorInvalidValue.
int gvp_conv_supported(int N, int K, int ds, int dv, int nb) {
  Dims d;
  return make_dims(N, K, ds, dv, nb, 0, d) ? 0 : (int)cudaErrorInvalidValue;
}

// Floats of the scratch each entry needs at these shapes (0 when unsupported).
long long gvp_conv_fwd_scratch_floats(int N, int K, int ds, int dv, int nb) {
  Dims d;
  if (!make_dims(N, K, ds, dv, nb, 0, d)) return 0;
  Args a{};
  Copies C;
  return (long long)fwd_layout(d, nullptr, a, C);
}

long long gvp_conv_bwd_scratch_floats(int N, int K, int ds, int dv, int nb) {
  Dims d;
  if (!make_dims(N, K, ds, dv, nb, 0, d)) return 0;
  Args a{};
  Grads gr;
  Copies C;
  return (long long)bwd_layout(d, nullptr, nullptr, nullptr, nullptr, nullptr, a, gr, C);
}

// The forward. s [N, ds], v [3, N, dv], nbrs int32 [N, K], mask bytes [N, K],
// rbf [N K, nb], u [3, N K], w the 25 split weights (a host array of device
// pointers), out_s [N, ds], out_v [3, N, dv], scratch of
// gvp_conv_fwd_scratch_floats floats: contiguous float32 device arrays. W is
// the gather's band. The stream is a cudaStream_t. Returns the cudaError_t of
// the launches (0 on success).
int gvp_conv_fwd_f32(const float* s, const float* v, const int* nbrs, const unsigned char* mask, const float* rbf,
                     const float* u, const float* const* w, float* out_s, float* out_v, float* scratch, int N,
                     int K, int ds, int dv, int nb, int W, void* stream) {
  Dims d;
  if (!make_dims(N, K, ds, dv, nb, W, d)) return (int)cudaErrorInvalidValue;
  Args a = base_args(d, s, v, nbrs, mask, rbf, u, w);
  a.out_s = out_s;
  a.out_v = out_v;
  Copies C;
  fwd_layout(d, scratch, a, C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = forward_layers<true>(a, C, st);
  if (err == cudaSuccess) err = launch(fwd_mean_kernel, blocks((long long)N * ds + 3LL * N * dv), st, a);
  return (int)err;
}

// The recompute backward: gs [N, ds] and gv [3, N, dv], the cotangents of the
// forward's outputs; g_s [N, ds], g_v [3, N, dv], g_rbf [N K, nb], g_u [3, N K]
// and gw (a host array of 25 device pointers, each shaped as its weight) are
// written whole; scratch of gvp_conv_bwd_scratch_floats floats. The rest as
// for the forward.
int gvp_conv_bwd_f32(const float* s, const float* v, const int* nbrs, const unsigned char* mask, const float* rbf,
                     const float* u, const float* const* w, const float* gs, const float* gv, float* g_s,
                     float* g_v, float* g_rbf, float* g_u, float* const* gw, float* scratch, int N, int K, int ds,
                     int dv, int nb, int W, void* stream) {
  Dims d;
  if (!make_dims(N, K, ds, dv, nb, W, d)) return (int)cudaErrorInvalidValue;
  Args a = base_args(d, s, v, nbrs, mask, rbf, u, w);
  a.gs = gs;
  a.gv = gv;
  a.g_s = g_s;
  a.g_v = g_v;
  a.g_rbf = g_rbf;
  a.g_u = g_u;
  Grads gr;
  Copies C;
  bwd_layout(d, scratch, s, v, u, gw, a, gr, C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = N, h0 = d.h0, R = N * K;
  const long long RD = (long long)R * dv;
  const Stash& S = a.st;
  // the forward again, layer by layer, keeping what the reverse and the weight gradients read
  cudaError_t err = forward_layers<false>(a, C, st);
  // the reverse sweep from the masked mean's cotangents
  if (err == cudaSuccess) err = launch(sweep_mean_grad_kernel, blocks((long long)R * ds + 3 * RD), st, a);
  for (int l = 2; l >= 0 && err == cudaSuccess; --l) {
    const int H = hidden(d, l), ldh = lh(d, l);
    a.layer = l;
    err = launch(sweep_gate_grad_kernel, blocks(RD), st, a);
    if (err == cudaSuccess)
      err = gemm<kSweep, TileWideT>(mat(S.gpre[l], R, dv, dv), mat(w[l == 0 ? WG0 : lw(l, LWG)], ds, dv, dv), R, ds, dv,
                            GmidEpi{S.gmid[l], S.mid[l], S.gs, ds, lm(d)}, st);
    // g_mid [Wnrm0 | Wrbf]^T: g_nrm0 and g_rbf; g_mid [Ws | Wnrm]^T: the next layer's gs and this one's g_nrm
    const int k1 = l == 0 ? h0 : ds, k2 = l == 0 ? nb : dv;
    if (err == cudaSuccess)
      err = gemm<kSweep, TileWideT>(mat(S.gmid[l], R, ds, ds), mat(S.wx[l], k1 + k2, ds, ds), R, k1 + k2, ds,
                            l == 0 ? SplitEpi{S.gnrm, g_rbf, lh(d, 0), nb, h0} : SplitEpi{S.gs, S.gnrm, ds, dv, ds},
                            st);
    if (err == cudaSuccess)
      err = gemm<kSweep, TileVecT>(mat(S.gvmu[l], R, dv, dv, RD), mat(w[l == 0 ? WMU0 : lw(l, LWMU)], H, dv, dv), R, H,
                           dv, GvhEpi{S.gvh[l], S.gnrm, S.vh[l], S.x[l] + nrm_col(d, l), (long long)R * ldh, ldh,
                                      lx(d, l)}, st);
    if (err == cudaSuccess && l > 0)
      err = gemm<kSweep, TileVecT>(mat(S.gvh[l], R, dv, dv, RD), mat(w[lw(l, LWH)], dv, dv, dv), R, dv, dv,
                           StoreRows{S.gv, RD, dv}, st);
  }
  if (err == cudaSuccess)
    err = launch(sweep_node_sum_kernel, blocks((long long)n * ds + 3LL * n * h0 + 3LL * R), st, a);
  // the gather's VJP, then the cotangents of s and v
  if (err == cudaSuccess) {
    const int per_block = kWarps / kSplit;
    err = launch(node_grad_scan_kernel, (n + per_block - 1) / per_block, st, a);
  }
  if (err == cudaSuccess)
    err = gemm<kNodeGrad, TileNodeT>(mat(a.nodes.gPQ, n, 2 * ds, 2 * ds), mat(S.wsij, ds, 2 * ds, 2 * ds), n, ds, 2 * ds,
                          StoreRows{g_s, 0, ds}, st);
  if (err == cudaSuccess)
    err = gemm<kNodeGrad, TileVecT>(mat(a.nodes.gAB, n, 2 * h0, lab(d), (long long)n * lab(d)),
                             mat(S.whij, dv, 2 * h0, lab(d)), n, dv, 2 * h0, StoreRows{g_v, (long long)n * dv, dv}, st);
  // the weight gradients: chunk partials, then their fixed-order sums
  if (err == cudaSuccess)
    err = launch(wgrad_kernel<TileGradWide>, gr.wide.tiles, st, gr.wide, TileGradWide::kThreads);
  if (err == cudaSuccess)
    err = launch(wgrad_kernel<TileGradNarrow>, gr.narrow.tiles, st, gr.narrow, TileGradNarrow::kThreads);
  if (err == cudaSuccess) err = launch(wgrad_reduce_kernel, blocks(gr.outs.total), st, gr.outs);
  return (int)err;
}

const char* gvp_conv_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
