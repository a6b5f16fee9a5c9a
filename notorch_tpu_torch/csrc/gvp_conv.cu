// The fused GVP message convolution, forward and recompute backward, in CUDA
// C++ for sm_90a.
//
// Replaces the Pallas kernels of notorch_tpu/kernels/gvp_conv.py:
//   - _fwd_kernel / fused_gvp_conv_fwd: prologue_kernel, then fwd_kernel;
//   - _bwd_kernel / fused_gvp_conv_bwd: transpose_kernel (the weights'
//     transposed copies), prologue_kernel, sweep_kernel, node_grad_kernel,
//     then wgrad_partial_kernel and wgrad_reduce_kernel.
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
// 1,024 rows at ds = 256 would not fit a block's 227 KB. So:
//   - s_i Wsi, s_j Wsj, v_i Whi and v_j Whj are products of a node's own row,
//     so prologue_kernel computes them once per node (N rows, not N K) and the
//     layer-0 pre-activations gather them by index: the largest products of
//     layer 0 shrink K-fold.
//   - fwd_kernel puts a block on G nodes (R = G K rows, at least 16): their
//     rows' activations stay in shared memory through the three layers and
//     the mean, and only the outputs are written. Each product is rowmm
//     below (the backward's X W^T on transposed weight copies, made by
//     transpose_kernel): 4 x 4 outputs a thread (1 x 4 for narrow outputs),
//     the k-sum in ascending order by fmaf, 16-byte loads, the weight read
//     through the read-only cache; the three vector components of a product
//     run as one product over 3 R rows.
//   - The backward recomputes the forward in the same block (sweep_kernel),
//     writes the per-row residuals and cotangents that the weight gradients
//     need to a stash in device memory, and runs the reverse sweep in shared
//     memory. A node's K rows sit in one block, so the sums over k (the
//     cotangents of s_i and v_i) are taken there in order.
//   - No float atomics. The gather's VJP into a source row m sums the rows
//     that name m: node_grad_kernel gives each m one warp, which scans the
//     rows of the nodes within W of m in ascending order (ballots, in lane
//     order), so each source has one owner and one order. Each weight
//     gradient sum_rows X^T G is cut into 64 x 64 tiles and chunks of 1,024
//     rows (wgrad_partial_kernel), and the chunks are added in ascending
//     order (wgrad_reduce_kernel): two calls give the same bits.
// Exact f32 on CUDA cores throughout, no TF32.
//
// What bounds them on this card: the products, a few hundred thousand
// multiply-adds a row against a few kilobytes of its inputs, so operations
// over the f32 rate (67 TFLOP/s on an H100 SXM at 700 W). The design cuts the
// operations (the per-node prologue) and keeps the rows' activations out of
// device memory in the forward; the backward's stash costs device-memory
// bytes that the TPU kernel did not move, traded for having no float atomics
// and a simple fixed-order weight-gradient reduction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsTarget = 16;   // message rows a block of fwd/sweep aims for
constexpr int kNodeGroup = 8;     // nodes a block of the prologue and node_grad (a warp each)
constexpr int kMaxSmem = 232448;  // the 227 KB a block may use after the opt-in
constexpr int kNW = 25;
constexpr int kChunk = 1024;      // rows of one weight-gradient partial
constexpr int kTile = 64;         // weight-gradient tile (k x n)
constexpr int kSlab = 32;         // rows staged at a time in wgrad_partial_kernel
constexpr float kEps = 1e-8f;

// split weight indices: layer 0, then layer l = 1, 2 at lw(l, i)
enum { WHI, WHJ, WHU, WMU0, WSI, WSJ, WRBF, WNRM0, BM0, WG0, BG0 };
enum { LWH, LWMU, LWS, LWNRM, LBM, LWG, LBG };
__host__ __device__ constexpr int lw(int l, int i) { return 11 + 7 * (l - 1) + i; }

struct Dims {
  int N, K, ds, dv, nb, W;
  int h0;  // layer 0's hidden vector width, 2 dv + 1
  int G;   // nodes of a fwd/sweep block
  int R;   // rows of a fwd/sweep block, G K
};

__host__ __device__ inline int hidden(const Dims& d, int l) { return l == 0 ? d.h0 : d.dv; }

struct Weights { const float* w[kNW]; };

// Per-row residuals and cotangents of the recomputed forward, by layer:
// [rows, width], or [3, rows, width] for vectors (component-major).
struct Stash {
  float* vh[3];    // 3 x H_l
  float* nrm[3];   // H_l
  float* mid[3];   // ds, before the relu
  float* vmu[3];   // 3 x dv
  float* gate[3];  // dv, after the activation
  float* vin[3];   // 3 x dv, the vector input of layers 1 and 2
  float* gvh[3];   // 3 x H_l
  float* gvmu[3];  // 3 x dv
  float* gmid[3];  // ds
  float* gpre[3];  // dv, the gate pre-activation's cotangent
};

// Per-node products and gradients.
struct Nodes {
  float *P, *Q;    // [N, ds]: s Wsi, s Wsj
  float *A, *B;    // [3, N, h0]: v Whi, v Whj
  float *gP, *gQ;  // [N, ds]: sums of g_mid0 over a node's own rows / over the rows naming it
  float *gA, *gB;  // [3, N, h0]: the same for g_vh0
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
  Weights wt;        // backward: the 2-D weights transposed ([out, in]), null for the biases
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
};

__device__ inline float lane4(const float4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }

// Y = X W, W row-major [Kd, n], for the R rows of X (row stride ldx, in
// shared memory), handed to epi(r, c, y) element by element. A thread takes
// TR x 4 outputs at a time; each sum runs over k in ascending order by fmaf.
// The threads of a warp read neighbouring columns of W's rows. Where every
// row of X and W starts 16-byte aligned, both are read in 16-byte vectors;
// the sums are the same either way. (The backward's products with W^T run
// on transposed copies, so that they read W's rows the same way.)
template <int TR, typename Epi>
__device__ void rowmm_tiles(const float* X, int ldx, int R, int Kd, const float* __restrict__ W, int n, Epi epi) {
  const int rg = (R + TR - 1) / TR, cg = (n + 3) >> 2;
  const bool vec = ((reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(W)) & 15) == 0 &&
                   (ldx & 3) == 0 && (Kd & 3) == 0 && (n & 3) == 0;
  for (int item = threadIdx.x; item < rg * cg; item += blockDim.x) {
    const int r0 = (item / cg) * TR, c0 = (item % cg) * 4;
    const float* xr[TR];
    int cc[4];
#pragma unroll
    for (int i = 0; i < TR; ++i) xr[i] = X + (size_t)(r0 + i < R ? r0 + i : r0) * ldx;
#pragma unroll
    for (int j = 0; j < 4; ++j) cc[j] = c0 + j < n ? c0 + j : c0;
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (vec) {
      for (int k = 0; k < Kd; k += 4) {
        float4 xv[TR], wv[4];
#pragma unroll
        for (int i = 0; i < TR; ++i) xv[i] = *reinterpret_cast<const float4*>(xr[i] + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wv[kk] = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k + kk) * n + c0));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(lane4(xv[i], kk), lane4(wv[kk], j), acc[i][j]);
      }
    } else {
      for (int k = 0; k < Kd; ++k) {
        float x[TR], w[4];
#pragma unroll
        for (int i = 0; i < TR; ++i) x[i] = xr[i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = __ldg(W + (size_t)k * n + cc[j]);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r0 + i < R && c0 + j < n) epi(r0 + i, c0 + j, acc[i][j]);
  }
}

// 4 x 4 tiles where they give every thread work, else 1 x 4 (a narrow
// output: the gates and the vector products, dv columns).
template <typename Epi>
__device__ void rowmm(const float* X, int ldx, int R, int Kd, const float* __restrict__ W, int n, Epi epi) {
  if (((R + 3) >> 2) * ((n + 3) >> 2) >= (int)blockDim.x)
    rowmm_tiles<4>(X, ldx, R, Kd, W, n, epi);
  else
    rowmm_tiles<1>(X, ldx, R, Kd, W, n, epi);
}

__device__ inline float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Shared memory of a fwd/sweep block (floats; J is ints).
struct Smem {
  float* MA;   // [R, ds] two scalar buffers, used in turn
  float* MB;
  float* VH;   // [3, R, H]
  float* NRM;  // [R, H]
  float* V;    // [3, R, dv]
  float* GT;   // [R, dv]
  float* RB;   // [R, nb]
  float* GVM;  // [3, R, dv] (backward)
  float* UU;   // [3, R]
  float* MK;   // [R] the mask as 0 / 1
  int* J;      // [R] the gathered row, or -1 for zero
};

__host__ __device__ inline size_t block_floats(const Dims& d, int R) {
  return (size_t)R * (2 * d.ds + 4 * d.h0 + 7 * d.dv + d.nb + 5);
}

__device__ inline Smem carve(float* base, const Dims& d) {
  Smem s;
  const int R = d.R;
  float* p = base;
  s.MA = p;  p += (size_t)R * d.ds;
  s.MB = p;  p += (size_t)R * d.ds;
  s.VH = p;  p += (size_t)3 * R * d.h0;
  s.NRM = p; p += (size_t)R * d.h0;
  s.V = p;   p += (size_t)3 * R * d.dv;
  s.GT = p;  p += (size_t)R * d.dv;
  s.RB = p;  p += (size_t)R * d.nb;
  s.GVM = p; p += (size_t)3 * R * d.dv;
  s.UU = p;  p += (size_t)3 * R;
  s.MK = p;  p += R;
  s.J = reinterpret_cast<int*>(p);
  return s;
}

// The block's rows: J, MK, the RBF rows and the unit vectors; rows past the
// last node read zero.
__device__ void load_rows(const Args& a, const Smem& sm, int n0) {
  const Dims& d = a.d;
  const size_t NK = (size_t)d.N * d.K;
  for (int r = threadIdx.x; r < d.R; r += blockDim.x) {
    const int n = n0 + r / d.K;
    const bool valid = n < d.N;
    const size_t gr = (size_t)n * d.K + r % d.K;
    const int j = valid ? a.nbrs[gr] : 0;
    const bool on = valid && a.mask[gr] != 0;
    sm.J[r] = on && j >= 0 && j < d.N && j - n <= d.W && n - j <= d.W ? j : -1;
    sm.MK[r] = on ? 1.f : 0.f;
    for (int c = 0; c < 3; ++c) sm.UU[c * d.R + r] = valid ? a.u[c * NK + gr] : 0.f;
  }
  for (int i = threadIdx.x; i < d.R * d.nb; i += blockDim.x) {
    const int r = i / d.nb, n = n0 + r / d.K;
    sm.RB[i] = n < d.N ? a.rbf[((size_t)n * d.K + r % d.K) * d.nb + i % d.nb] : 0.f;
  }
}

// The global row of block row r, or -1 past the last node.
__device__ inline long long grow(const Dims& d, int n0, int r) {
  const int n = n0 + r / d.K;
  return n < d.N ? (long long)n * d.K + r % d.K : -1;
}

// nrm = sqrt(x^2 + y^2 + z^2 + eps) of the layer's hidden vectors VH [3, R, H].
template <bool kStash>
__device__ void norms(const Args& a, const Smem& sm, int n0, int l) {
  const Dims& d = a.d;
  const int H = hidden(d, l), R = d.R;
  const size_t NK = (size_t)d.N * d.K;
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    const float x = sm.VH[i], y = sm.VH[R * H + i], z = sm.VH[2 * R * H + i];
    const float nrm = sqrtf(x * x + y * y + z * z + kEps);
    sm.NRM[i] = nrm;
    if constexpr (kStash) {
      const long long gr = grow(d, n0, i / H);
      if (gr >= 0) {
        const size_t o = (size_t)gr * H + i % H;
        a.st.nrm[l][o] = nrm;
        for (int c = 0; c < 3; ++c) a.st.vh[l][c * NK * H + o] = sm.VH[c * R * H + i];
      }
    }
  }
}

// The gate, the vector output and the relu of a layer whose pre-activation is
// in M: GT = act(bg + M Wg), V = (VH Wmu) * GT, M = relu(M).
template <bool kStash>
__device__ void layer_tail(const Args& a, const Smem& sm, int n0, int l, float* M) {
  const Dims& d = a.d;
  const int H = hidden(d, l), R = d.R, ds = d.ds, dv = d.dv;
  const size_t NK = (size_t)d.N * d.K;
  const float* Wg = a.w.w[l == 0 ? WG0 : lw(l, LWG)];
  const float* bg = a.w.w[l == 0 ? BG0 : lw(l, LBG)];
  const float* Wmu = a.w.w[l == 0 ? WMU0 : lw(l, LWMU)];
  const bool act = l < 2;
  if constexpr (kStash) {
    for (int i = threadIdx.x; i < R * ds; i += blockDim.x) {
      const long long gr = grow(d, n0, i / ds);
      if (gr >= 0) a.st.mid[l][(size_t)gr * ds + i % ds] = M[i];
    }
  }
  rowmm(M, ds, R, ds, Wg, dv, [&](int r, int c, float y) {
    const float g = y + bg[c];
    sm.GT[r * dv + c] = act ? sigmoidf(g) : g;
  });
  __syncthreads();
  // the three components as 3 R rows: VH is [3, R, H], V [3, R, dv]
  rowmm(sm.VH, H, 3 * R, H, Wmu, dv, [&](int rr, int c, float y) {
    const int comp = rr / R, r = rr % R;
    if constexpr (kStash) {
      const long long gr = grow(d, n0, r);
      if (gr >= 0) {
        a.st.vmu[l][comp * NK * dv + (size_t)gr * dv + c] = y;
        if (comp == 0) a.st.gate[l][(size_t)gr * dv + c] = sm.GT[r * dv + c];
      }
    }
    sm.V[(size_t)rr * dv + c] = y * sm.GT[r * dv + c];
  });
  __syncthreads();
  for (int i = threadIdx.x; i < R * ds; i += blockDim.x) M[i] = fmaxf(M[i], 0.f);
  __syncthreads();
}

// The three message layers of the block's rows: on return MA holds s' and V
// holds v' of the last layer. With kStash the residuals go to the stash.
template <bool kStash>
__device__ void forward_rows(const Args& a, const Smem& sm, int n0) {
  const Dims& d = a.d;
  const int R = d.R, ds = d.ds, dv = d.dv, h0 = d.h0;
  const size_t N = d.N;
  const float* whu = a.w.w[WHU];
  const float* bm0 = a.w.w[BM0];
  // layer 0: the gathered per-node products plus the unit vector's term
  for (int i = threadIdx.x; i < R * h0; i += blockDim.x) {
    const int r = i / h0, c = i % h0, n = n0 + r / d.K, j = sm.J[r];
    for (int comp = 0; comp < 3; ++comp) {
      float x = 0.f;
      if (n < d.N) {
        x = a.nodes.A[(comp * N + n) * h0 + c] + (j >= 0 ? a.nodes.B[(comp * N + j) * h0 + c] : 0.f);
        x = x + sm.UU[comp * R + r] * whu[c];
      }
      sm.VH[(size_t)comp * R * h0 + i] = x;
    }
  }
  __syncthreads();
  norms<kStash>(a, sm, n0, 0);
  __syncthreads();
  rowmm(sm.NRM, h0, R, h0, a.w.w[WNRM0], ds, [&](int r, int c, float y) {
    const int n = n0 + r / d.K, j = sm.J[r];
    float m = 0.f;
    if (n < d.N) m = y + bm0[c] + a.nodes.P[(size_t)n * ds + c] + (j >= 0 ? a.nodes.Q[(size_t)j * ds + c] : 0.f);
    sm.MA[r * ds + c] = m;
  });
  __syncthreads();
  rowmm(sm.RB, d.nb, R, d.nb, a.w.w[WRBF], ds, [&](int r, int c, float y) { sm.MA[r * ds + c] += y; });
  __syncthreads();
  layer_tail<kStash>(a, sm, n0, 0, sm.MA);

  float* Sin = sm.MA;
  float* Mout = sm.MB;
  const size_t NK = N * d.K;
  for (int l = 1; l <= 2; ++l) {
    if constexpr (kStash) {
      for (int i = threadIdx.x; i < 3 * R * dv; i += blockDim.x) {
        const int comp = i / (R * dv), r = (i / dv) % R;
        const long long gr = grow(d, n0, r);
        if (gr >= 0) a.st.vin[l][comp * NK * dv + (size_t)gr * dv + i % dv] = sm.V[i];
      }
    }
    rowmm(sm.V, dv, 3 * R, dv, a.w.w[lw(l, LWH)], dv, [&](int rr, int c, float y) { sm.VH[(size_t)rr * dv + c] = y; });
    __syncthreads();
    norms<kStash>(a, sm, n0, l);
    __syncthreads();
    const float* bm = a.w.w[lw(l, LBM)];
    rowmm(Sin, ds, R, ds, a.w.w[lw(l, LWS)], ds,
        [&](int r, int c, float y) { Mout[r * ds + c] = y + bm[c]; });
    __syncthreads();
    rowmm(sm.NRM, dv, R, dv, a.w.w[lw(l, LWNRM)], ds,
        [&](int r, int c, float y) { Mout[r * ds + c] += y; });
    __syncthreads();
    layer_tail<kStash>(a, sm, n0, l, Mout);
    float* t = Sin;
    Sin = Mout;
    Mout = t;
  }
}

__device__ inline float* dynamic_smem() {
  extern __shared__ __align__(16) float smem[];
  return smem;
}

// s Wsi, s Wsj and v Whi, v Whj of kNodeGroup nodes a block.
__global__ void __launch_bounds__(kThreads) prologue_kernel(const Args a) {
  const Dims& d = a.d;
  const int ds = d.ds, dv = d.dv, h0 = d.h0, N = d.N;
  const int n0 = blockIdx.x * kNodeGroup, rows = min(kNodeGroup, N - n0);
  float* XS = dynamic_smem();
  float* XV = XS + (size_t)kNodeGroup * ds;
  for (int i = threadIdx.x; i < rows * ds; i += blockDim.x) XS[i] = a.s[(size_t)n0 * ds + i];
  for (int i = threadIdx.x; i < 3 * rows * dv; i += blockDim.x) {
    const int comp = i / (rows * dv), rest = i % (rows * dv);
    XV[comp * kNodeGroup * dv + rest] = a.v[((size_t)comp * N + n0) * dv + rest];
  }
  __syncthreads();
  rowmm(XS, ds, rows, ds, a.w.w[WSI], ds,
      [&](int r, int c, float y) { a.nodes.P[(size_t)(n0 + r) * ds + c] = y; });
  rowmm(XS, ds, rows, ds, a.w.w[WSJ], ds,
      [&](int r, int c, float y) { a.nodes.Q[(size_t)(n0 + r) * ds + c] = y; });
  for (int comp = 0; comp < 3; ++comp) {
    const float* X = XV + comp * kNodeGroup * dv;
    const size_t base = (size_t)comp * N + n0;
    rowmm(X, dv, rows, dv, a.w.w[WHI], h0,
        [&](int r, int c, float y) { a.nodes.A[(base + r) * h0 + c] = y; });
    rowmm(X, dv, rows, dv, a.w.w[WHJ], h0,
        [&](int r, int c, float y) { a.nodes.B[(base + r) * h0 + c] = y; });
  }
}

// The forward: a block's G nodes, their rows through the three layers, then
// the masked mean over each node's K slots.
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Args a) {
  const Dims& d = a.d;
  const Smem sm = carve(dynamic_smem(), d);
  const int n0 = blockIdx.x * d.G, N = d.N, ds = d.ds, dv = d.dv, K = d.K;
  load_rows(a, sm, n0);
  __syncthreads();
  forward_rows<false>(a, sm, n0);
  for (int i = threadIdx.x; i < d.G * ds; i += blockDim.x) {
    const int g = i / ds, c = i % ds, n = n0 + g;
    if (n >= N) continue;
    float sum = 0.f, cnt = 0.f;
    for (int k = 0; k < K; ++k) {
      const int r = g * K + k;
      sum += sm.MA[r * ds + c] * sm.MK[r];
      cnt += sm.MK[r];
    }
    a.out_s[(size_t)n * ds + c] = sum / fmaxf(cnt, 1.f);
  }
  for (int i = threadIdx.x; i < 3 * d.G * dv; i += blockDim.x) {
    const int comp = i / (d.G * dv), g = (i / dv) % d.G, c = i % dv, n = n0 + g;
    if (n >= N) continue;
    float sum = 0.f, cnt = 0.f;
    for (int k = 0; k < K; ++k) {
      const int r = g * K + k;
      sum += sm.V[(size_t)comp * d.R * dv + r * dv + c] * sm.MK[r];
      cnt += sm.MK[r];
    }
    a.out_v[((size_t)comp * N + n) * dv + c] = sum / fmaxf(cnt, 1.f);
  }
}

// The reverse of layer l for the block's rows: GS and GV hold the cotangents
// of the layer's scalar and vector outputs; on return GNext and GV hold those
// of its inputs (layers 1, 2), or (layer 0) the row outputs and per-node sums
// are written.
__device__ void reverse_layer(const Args& a, const Smem& sm, int n0, int l, float* GS, float* GNext) {
  const Dims& d = a.d;
  const int H = hidden(d, l), R = d.R, ds = d.ds, dv = d.dv;
  const size_t NK = (size_t)d.N * d.K;
  const bool act = l < 2;
  float* GV = sm.V;
  for (int i = threadIdx.x; i < R * dv; i += blockDim.x) {
    const long long gr = grow(d, n0, i / dv);
    if (gr < 0) {
      sm.GT[i] = 0.f;
      for (int comp = 0; comp < 3; ++comp) sm.GVM[(size_t)comp * R * dv + i] = 0.f;
      continue;
    }
    const size_t o = (size_t)gr * dv + i % dv;
    const float gate = a.st.gate[l][o];
    float g_gate = 0.f;
    for (int comp = 0; comp < 3; ++comp) g_gate += GV[(size_t)comp * R * dv + i] * a.st.vmu[l][comp * NK * dv + o];
    const float gpre = act ? g_gate * gate * (1.f - gate) : g_gate;
    sm.GT[i] = gpre;
    a.st.gpre[l][o] = gpre;
    for (int comp = 0; comp < 3; ++comp) {
      const float gvm = GV[(size_t)comp * R * dv + i] * gate;
      sm.GVM[(size_t)comp * R * dv + i] = gvm;
      a.st.gvmu[l][comp * NK * dv + o] = gvm;
    }
  }
  __syncthreads();
  rowmm(sm.GT, dv, R, dv, a.wt.w[l == 0 ? WG0 : lw(l, LWG)], ds, [&](int r, int c, float y) {
    const long long gr = grow(d, n0, r);
    if (gr < 0) {
      GS[r * ds + c] = 0.f;
      return;
    }
    const size_t o = (size_t)gr * ds + c;
    const float g = (a.st.mid[l][o] > 0.f ? GS[r * ds + c] : 0.f) + y;
    GS[r * ds + c] = g;
    a.st.gmid[l][o] = g;
  });
  __syncthreads();
  rowmm(GS, ds, R, ds, a.wt.w[l == 0 ? WNRM0 : lw(l, LWNRM)], H,
      [&](int r, int c, float y) { sm.NRM[r * H + c] = y; });
  __syncthreads();
  // the three components as 3 R rows: GVM is [3, R, dv], VH [3, R, H]
  rowmm(sm.GVM, dv, 3 * R, dv, a.wt.w[l == 0 ? WMU0 : lw(l, LWMU)], H, [&](int rr, int c, float y) {
    const int comp = rr / R, r = rr % R;
    const long long gr = grow(d, n0, r);
    float g = 0.f;
    if (gr >= 0) {
      const size_t o = (size_t)gr * H + c;
      g = y + sm.NRM[r * H + c] * a.st.vh[l][comp * NK * H + o] / a.st.nrm[l][o];
      a.st.gvh[l][comp * NK * H + o] = g;
    }
    sm.VH[(size_t)rr * H + c] = g;
  });
  __syncthreads();
  if (l > 0) {
    rowmm(GS, ds, R, ds, a.wt.w[lw(l, LWS)], ds, [&](int r, int c, float y) { GNext[r * ds + c] = y; });
    rowmm(sm.VH, dv, 3 * R, dv, a.wt.w[lw(l, LWH)], dv, [&](int rr, int c, float y) { GV[(size_t)rr * dv + c] = y; });
    __syncthreads();
    return;
  }
  const int h0 = d.h0, K = d.K;
  const size_t N = d.N;
  rowmm(GS, ds, R, ds, a.wt.w[WRBF], d.nb, [&](int r, int c, float y) {
    const long long gr = grow(d, n0, r);
    if (gr >= 0) a.g_rbf[(size_t)gr * d.nb + c] = y;
  });
  const float* whu = a.w.w[WHU];
  for (int i = threadIdx.x; i < 3 * R; i += blockDim.x) {
    const int comp = i / R, r = i % R;
    const long long gr = grow(d, n0, r);
    if (gr < 0) continue;
    const float* g = sm.VH + (size_t)comp * R * h0 + (size_t)r * h0;
    float acc = 0.f;
    for (int h = 0; h < h0; ++h) acc = fmaf(g[h], whu[h], acc);
    a.g_u[comp * NK + gr] = acc;
  }
  for (int i = threadIdx.x; i < d.G * ds; i += blockDim.x) {
    const int g = i / ds, c = i % ds, n = n0 + g;
    if (n >= d.N) continue;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += GS[(g * K + k) * ds + c];
    a.nodes.gP[(size_t)n * ds + c] = acc;
  }
  for (int i = threadIdx.x; i < 3 * d.G * h0; i += blockDim.x) {
    const int comp = i / (d.G * h0), g = (i / h0) % d.G, c = i % h0, n = n0 + g;
    if (n >= d.N) continue;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += sm.VH[(size_t)comp * R * h0 + (size_t)(g * K + k) * h0 + c];
    a.nodes.gA[(comp * N + n) * h0 + c] = acc;
  }
}

// The recompute backward of a block's G nodes: the forward again, stashing
// its residuals, then the reverse sweep from the masked mean's cotangents.
__global__ void __launch_bounds__(kThreads) sweep_kernel(const Args a) {
  const Dims& d = a.d;
  const Smem sm = carve(dynamic_smem(), d);
  const int n0 = blockIdx.x * d.G, R = d.R, ds = d.ds, dv = d.dv, K = d.K;
  const size_t N = d.N;
  load_rows(a, sm, n0);
  __syncthreads();
  forward_rows<true>(a, sm, n0);
  // the mean's cotangents: (g / max(sum of the mask, 1)) on each live slot
  for (int i = threadIdx.x; i < R * ds; i += blockDim.x) {
    const int r = i / ds, n = n0 + r / K, g0 = (r / K) * K;
    float val = 0.f;
    if (n < d.N) {
      float cnt = 0.f;
      for (int k = 0; k < K; ++k) cnt += sm.MK[g0 + k];
      val = a.gs[(size_t)n * ds + i % ds] / fmaxf(cnt, 1.f) * sm.MK[r];
    }
    sm.MB[i] = val;
  }
  for (int i = threadIdx.x; i < 3 * R * dv; i += blockDim.x) {
    const int comp = i / (R * dv), r = (i / dv) % R, n = n0 + r / K, g0 = (r / K) * K;
    float val = 0.f;
    if (n < d.N) {
      float cnt = 0.f;
      for (int k = 0; k < K; ++k) cnt += sm.MK[g0 + k];
      val = a.gv[(comp * N + n) * dv + i % dv] / fmaxf(cnt, 1.f) * sm.MK[r];
    }
    sm.V[i] = val;
  }
  __syncthreads();
  reverse_layer(a, sm, n0, 2, sm.MB, sm.MA);
  reverse_layer(a, sm, n0, 1, sm.MA, sm.MB);
  reverse_layer(a, sm, n0, 0, sm.MB, sm.MA);
}

// The cotangents of s and v: per source m, the rows that gather m summed in
// ascending row order by one warp (gQ, gB), then g_s = gP Wsi^T + gQ Wsj^T and
// g_v = gA Whi^T + gB Whj^T.
__global__ void __launch_bounds__(kThreads) node_grad_kernel(const Args a) {
  const Dims& d = a.d;
  const int ds = d.ds, dv = d.dv, h0 = d.h0, K = d.K, N = d.N;
  const size_t NK = (size_t)N * K;
  const int m0 = blockIdx.x * kNodeGroup, rows = min(kNodeGroup, N - m0);
  float* XP = dynamic_smem();
  float* XQ = XP + (size_t)kNodeGroup * ds;
  float* XA = XQ + (size_t)kNodeGroup * ds;
  float* XB = XA + (size_t)3 * kNodeGroup * h0;
  for (int i = threadIdx.x; i < rows * ds; i += blockDim.x) XP[i] = a.nodes.gP[(size_t)m0 * ds + i];
  for (int i = threadIdx.x; i < 3 * rows * h0; i += blockDim.x) {
    const int comp = i / (rows * h0), rest = i % (rows * h0);
    XA[comp * kNodeGroup * h0 + rest] = a.nodes.gA[((size_t)comp * N + m0) * h0 + rest];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int width = ds + 3 * h0;
  for (int w = warp; w < rows; w += kWarps) {
    const int m = m0 + w;
    const int lo = max(0, m - d.W), hi = min(N - 1, m + d.W);
    const size_t base = (size_t)lo * K;
    const int ncand = (hi - lo + 1) * K;
    for (int c0 = 0; c0 < width; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.f;
      for (int p0 = 0; p0 < ncand; p0 += 32) {
        const int p = p0 + lane;
        const bool hit = p < ncand && a.mask[base + p] != 0 && a.nbrs[base + p] == m;
        unsigned bits = __ballot_sync(0xffffffffu, hit);
        while (bits) {
          const size_t rr = base + p0 + (__ffs(bits) - 1);
          bits &= bits - 1;
          if (c < ds) {
            acc += a.st.gmid[0][rr * ds + c];
          } else if (c < width) {
            const int comp = (c - ds) / h0, cc = (c - ds) % h0;
            acc += a.st.gvh[0][comp * NK * h0 + rr * h0 + cc];
          }
        }
      }
      if (c < ds) {
        XQ[w * ds + c] = acc;
        a.nodes.gQ[(size_t)m * ds + c] = acc;
      } else if (c < width) {
        const int comp = (c - ds) / h0, cc = (c - ds) % h0;
        XB[(comp * kNodeGroup + w) * h0 + cc] = acc;
        a.nodes.gB[((size_t)comp * N + m) * h0 + cc] = acc;
      }
    }
  }
  __syncthreads();
  rowmm(XP, ds, rows, ds, a.wt.w[WSI], ds,
      [&](int r, int c, float y) { a.g_s[(size_t)(m0 + r) * ds + c] = y; });
  for (int comp = 0; comp < 3; ++comp)
    rowmm(XA + comp * kNodeGroup * h0, h0, rows, h0, a.wt.w[WHI], dv,
        [&](int r, int c, float y) { a.g_v[((size_t)comp * N + m0 + r) * dv + c] = y; });
  __syncthreads();
  rowmm(XQ, ds, rows, ds, a.wt.w[WSJ], ds,
      [&](int r, int c, float y) { a.g_s[(size_t)(m0 + r) * ds + c] += y; });
  for (int comp = 0; comp < 3; ++comp)
    rowmm(XB + comp * kNodeGroup * h0, h0, rows, h0, a.wt.w[WHJ], dv,
        [&](int r, int c, float y) { a.g_v[((size_t)comp * N + m0 + r) * dv + c] += y; });
}

// One weight gradient: out[k, n] = sum over comp < ncomp and row < rows of
// X(comp, row, k) G(comp, row, n); X null reads 1 (a bias, k = 1); relu_x
// takes relu(X), the layer's scalar input from its predecessor's pre-activation.
struct Job {
  const float* X;
  const float* G;
  float* out;
  long long xcs, gcs;  // component strides
  long long part_off;  // the job's partials: [nchunk, k, n]
  long long elem_off;  // the job's first element in wgrad_reduce_kernel's index
  int ldx, ldg, k, n, rows, ncomp, relu_x;
  int tile_off;        // the job's first block in wgrad_partial_kernel
  int ntn, nchunk;
};

struct Jobs {
  Job j[kNW];
  float* part;
  int tiles;
  long long elems;
};

// A 64 x 64 tile of one job's gradient over one chunk of 1,024 rows, rows in
// ascending order, components in turn; 4 x 4 outputs a thread.
__global__ void __launch_bounds__(kThreads) wgrad_partial_kernel(const Jobs J) {
  int ji = 0;
  while (ji + 1 < kNW && (int)blockIdx.x >= J.j[ji + 1].tile_off) ++ji;
  const Job& job = J.j[ji];
  const int local = blockIdx.x - job.tile_off;
  const int chunk = local % job.nchunk, t = local / job.nchunk;
  const int kt = t / job.ntn, nt = t % job.ntn;
  __shared__ __align__(16) float xs[kSlab][kTile];
  __shared__ __align__(16) float gs[kSlab][kTile];
  const int tk = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int r_begin = chunk * kChunk, r_end = min(job.rows, r_begin + kChunk);
  for (int comp = 0; comp < job.ncomp; ++comp) {
    for (int rb = r_begin; rb < r_end; rb += kSlab) {
      for (int e = threadIdx.x; e < kSlab * kTile; e += blockDim.x) {
        const int rr = e / kTile, col = e % kTile, row = rb + rr;
        const int kg = kt * kTile + col, ng = nt * kTile + col;
        float x = 0.f, g = 0.f;
        if (row < r_end && kg < job.k) {
          x = job.X ? job.X[comp * job.xcs + (long long)row * job.ldx + kg] : 1.f;
          if (job.relu_x) x = fmaxf(x, 0.f);
        }
        if (row < r_end && ng < job.n) g = job.G[comp * job.gcs + (long long)row * job.ldg + ng];
        xs[rr][col] = x;
        gs[rr][col] = g;
      }
      __syncthreads();
      for (int rr = 0; rr < kSlab; ++rr) {
        const float4 x = *reinterpret_cast<const float4*>(&xs[rr][tk * 4]);
        const float4 g = *reinterpret_cast<const float4*>(&gs[rr][tn * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(lane4(x, i), lane4(g, j), acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* part = J.part + job.part_off + (long long)chunk * job.k * job.n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = kt * kTile + tk * 4 + i, ng = nt * kTile + tn * 4 + j;
      if (kg < job.k && ng < job.n) part[(long long)kg * job.n + ng] = acc[i][j];
    }
}

// Each gradient element: its chunks' partials added in ascending order.
__global__ void __launch_bounds__(kThreads) wgrad_reduce_kernel(const Jobs J) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= J.elems) return;
  int ji = 0;
  while (ji + 1 < kNW && e >= J.j[ji + 1].elem_off) ++ji;
  const Job& job = J.j[ji];
  const long long local = e - job.elem_off, size = (long long)job.k * job.n;
  float sum = 0.f;
  for (int c = 0; c < job.nchunk; ++c) sum += J.part[job.part_off + c * size + local];
  job.out[local] = sum;
}

// The backward's transposed weight copies, one launch for all of them.
struct Transposes {
  const float* src[kNW];
  float* dst[kNW];
  int rows[kNW], cols[kNW];  // src is [rows, cols]; 0 rows for a bias
  long long off[kNW + 1];    // first element of each in the flattened index
};

__global__ void __launch_bounds__(kThreads) transpose_kernel(const Transposes T) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= T.off[kNW]) return;
  int i = 0;
  while (e >= T.off[i + 1]) ++i;
  const long long local = e - T.off[i];
  const int r = (int)(local / T.cols[i]), c = (int)(local % T.cols[i]);
  T.dst[i][(long long)c * T.rows[i] + r] = T.src[i][local];
}

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

bool make_dims(int N, int K, int ds, int dv, int nb, int W, Dims& d) {
  if (N <= 0 || K <= 0 || ds <= 0 || dv <= 0 || nb <= 0 || W < 0) return false;
  d = Dims{N, K, ds, dv, nb, W, 2 * dv + 1 > dv ? 2 * dv + 1 : dv, 1, K};
  d.G = K < kRowsTarget ? kRowsTarget / K : 1;
  while (d.G > 1 && block_floats(d, d.G * K) * sizeof(float) > (size_t)kMaxSmem) --d.G;
  d.R = d.G * K;
  return block_floats(d, d.R) * sizeof(float) <= (size_t)kMaxSmem &&
         (size_t)kNodeGroup * (ds + 3 * dv) * sizeof(float) <= (size_t)kMaxSmem &&
         (size_t)kNodeGroup * (2 * ds + 6 * d.h0) * sizeof(float) <= (size_t)kMaxSmem;
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

void add_job(Jobs& J, int& ji, long long& part, const float* X, long long xcs, int ldx, bool relu_x,
             const float* G, long long gcs, int ldg, int k, int n, int rows, int ncomp, float* out) {
  Job& job = J.j[ji++];
  job = Job{X, G, out, xcs, gcs, part, J.elems, ldx, ldg, k, n, rows, ncomp, relu_x ? 1 : 0, J.tiles,
            (n + kTile - 1) / kTile, (rows + kChunk - 1) / kChunk};
  J.tiles += ((k + kTile - 1) / kTile) * job.ntn * job.nchunk;
  part += (long long)job.nchunk * k * n;
  J.elems += (long long)k * n;
}

// Lays out the backward's scratch at base (the transposed weights, nodes,
// stash, jobs, partials) and returns its size in floats; with gw null the
// jobs' outputs are left unset.
size_t bwd_layout(const Dims& d, float* base, const float* s, const float* v, const float* rbf, const float* u,
                  float* const* gw, Args& a, Jobs& J, Transposes& T) {
  Cursor cur{base};
  const size_t N = d.N, NK = N * d.K;
  const int ds = d.ds, dv = d.dv, h0 = d.h0;
  T = Transposes{};
  for (int i = 0; i < kNW; ++i) {
    weight_shape(d, i, T.rows[i], T.cols[i]);
    const long long size = (long long)T.rows[i] * T.cols[i];
    T.src[i] = a.w.w[i];
    T.dst[i] = size ? cur.take((size_t)size) : nullptr;
    a.wt.w[i] = T.dst[i];
    T.off[i + 1] = T.off[i] + size;
  }
  a.nodes = Nodes{cur.take(N * ds), cur.take(N * ds), cur.take(3 * N * h0), cur.take(3 * N * h0),
                  cur.take(N * ds), cur.take(N * ds), cur.take(3 * N * h0), cur.take(3 * N * h0)};
  for (int l = 0; l < 3; ++l) {
    const size_t H = hidden(d, l);
    a.st.vh[l] = cur.take(3 * NK * H);
    a.st.nrm[l] = cur.take(NK * H);
    a.st.mid[l] = cur.take(NK * ds);
    a.st.vmu[l] = cur.take(3 * NK * dv);
    a.st.gate[l] = cur.take(NK * dv);
    a.st.vin[l] = l > 0 ? cur.take(3 * NK * dv) : nullptr;
    a.st.gvh[l] = cur.take(3 * NK * H);
    a.st.gvmu[l] = cur.take(3 * NK * dv);
    a.st.gmid[l] = cur.take(NK * ds);
    a.st.gpre[l] = cur.take(NK * dv);
  }
  J = Jobs{};
  int ji = 0;
  long long part = 0;
  const int n = d.N, nk = (int)NK;
  const long long vcs = (long long)N * dv, hcs = (long long)N * h0;
  float* const* g = gw;
  float* none[kNW] = {};
  if (!g) g = none;
  const Stash& st = a.st;
  const Nodes& nd = a.nodes;
  add_job(J, ji, part, v, vcs, dv, false, nd.gA, hcs, h0, dv, h0, n, 3, g[WHI]);
  add_job(J, ji, part, v, vcs, dv, false, nd.gB, hcs, h0, dv, h0, n, 3, g[WHJ]);
  add_job(J, ji, part, u, (long long)NK, 1, false, st.gvh[0], (long long)NK * h0, h0, 1, h0, nk, 3, g[WHU]);
  add_job(J, ji, part, st.vh[0], (long long)NK * h0, h0, false, st.gvmu[0], (long long)NK * dv, dv, h0, dv, nk, 3,
          g[WMU0]);
  add_job(J, ji, part, s, 0, ds, false, nd.gP, 0, ds, ds, ds, n, 1, g[WSI]);
  add_job(J, ji, part, s, 0, ds, false, nd.gQ, 0, ds, ds, ds, n, 1, g[WSJ]);
  add_job(J, ji, part, rbf, 0, d.nb, false, st.gmid[0], 0, ds, d.nb, ds, nk, 1, g[WRBF]);
  add_job(J, ji, part, st.nrm[0], 0, h0, false, st.gmid[0], 0, ds, h0, ds, nk, 1, g[WNRM0]);
  add_job(J, ji, part, nullptr, 0, 1, false, st.gmid[0], 0, ds, 1, ds, nk, 1, g[BM0]);
  add_job(J, ji, part, st.mid[0], 0, ds, false, st.gpre[0], 0, dv, ds, dv, nk, 1, g[WG0]);
  add_job(J, ji, part, nullptr, 0, 1, false, st.gpre[0], 0, dv, 1, dv, nk, 1, g[BG0]);
  const long long dcs = (long long)NK * dv;
  for (int l = 1; l <= 2; ++l) {
    add_job(J, ji, part, st.vin[l], dcs, dv, false, st.gvh[l], dcs, dv, dv, dv, nk, 3, g[lw(l, LWH)]);
    add_job(J, ji, part, st.vh[l], dcs, dv, false, st.gvmu[l], dcs, dv, dv, dv, nk, 3, g[lw(l, LWMU)]);
    add_job(J, ji, part, st.mid[l - 1], 0, ds, true, st.gmid[l], 0, ds, ds, ds, nk, 1, g[lw(l, LWS)]);
    add_job(J, ji, part, st.nrm[l], 0, dv, false, st.gmid[l], 0, ds, dv, ds, nk, 1, g[lw(l, LWNRM)]);
    add_job(J, ji, part, nullptr, 0, 1, false, st.gmid[l], 0, ds, 1, ds, nk, 1, g[lw(l, LBM)]);
    add_job(J, ji, part, st.mid[l], 0, ds, false, st.gpre[l], 0, dv, ds, dv, nk, 1, g[lw(l, LWG)]);
    add_job(J, ji, part, nullptr, 0, 1, false, st.gpre[l], 0, dv, 1, dv, nk, 1, g[lw(l, LBG)]);
  }
  J.part = cur.take((size_t)part);
  return cur.off;
}

size_t fwd_layout(const Dims& d, float* base, Args& a) {
  Cursor cur{base};
  const size_t N = d.N;
  a.nodes = Nodes{};
  a.nodes.P = cur.take(N * d.ds);
  a.nodes.Q = cur.take(N * d.ds);
  a.nodes.A = cur.take(3 * N * d.h0);
  a.nodes.B = cur.take(3 * N * d.h0);
  return cur.off;
}

// each kernel's shared-memory opt-in, a bit per device: fwd, sweep, prologue, node_grad
uint64_t g_configured[4];

template <typename Arg>
cudaError_t launch(void (*kernel)(const Arg), long long blocks, size_t smem, cudaStream_t stream, const Arg& arg,
                   uint64_t* configured) {
  if (blocks <= 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem((const void*)kernel, kMaxSmem, *configured);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(arg);
  return cudaGetLastError();
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

size_t prologue_smem(const Dims& d) { return (size_t)kNodeGroup * (d.ds + 3 * d.dv) * sizeof(float); }
size_t node_smem(const Dims& d) { return (size_t)kNodeGroup * (2 * d.ds + 6 * d.h0) * sizeof(float); }
size_t block_smem(const Dims& d) { return block_floats(d, d.R) * sizeof(float); }
long long node_groups(const Dims& d) { return (d.N + kNodeGroup - 1) / kNodeGroup; }
long long row_groups(const Dims& d) { return (d.N + d.G - 1) / d.G; }

}  // namespace

extern "C" {

// 0 when the kernels take these shapes (a block's rows and the node groups fit
// shared memory), else cudaErrorInvalidValue.
int gvp_conv_supported(int N, int K, int ds, int dv, int nb) {
  Dims d;
  return make_dims(N, K, ds, dv, nb, 0, d) ? 0 : (int)cudaErrorInvalidValue;
}

// Floats of the scratch each entry needs at these shapes (0 when unsupported).
long long gvp_conv_fwd_scratch_floats(int N, int K, int ds, int dv, int nb) {
  Dims d;
  if (!make_dims(N, K, ds, dv, nb, 0, d)) return 0;
  Args a{};
  return (long long)fwd_layout(d, nullptr, a);
}

long long gvp_conv_bwd_scratch_floats(int N, int K, int ds, int dv, int nb) {
  Dims d;
  if (!make_dims(N, K, ds, dv, nb, 0, d)) return 0;
  Args a{};
  Jobs J;
  Transposes T;
  return (long long)bwd_layout(d, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, a, J, T);
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
  fwd_layout(d, scratch, a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch(prologue_kernel, node_groups(d), prologue_smem(d), st, a, &g_configured[2]);
  if (err == cudaSuccess) err = launch(fwd_kernel, row_groups(d), block_smem(d), st, a, &g_configured[0]);
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
  Jobs J;
  Transposes T;
  bwd_layout(d, scratch, s, v, rbf, u, gw, a, J, T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch(transpose_kernel, (T.off[kNW] + kThreads - 1) / kThreads, 0, st, T, nullptr);
  if (err == cudaSuccess) err = launch(prologue_kernel, node_groups(d), prologue_smem(d), st, a, &g_configured[2]);
  if (err == cudaSuccess) err = launch(sweep_kernel, row_groups(d), block_smem(d), st, a, &g_configured[1]);
  if (err == cudaSuccess) err = launch(node_grad_kernel, node_groups(d), node_smem(d), st, a, &g_configured[3]);
  if (err == cudaSuccess) err = launch(wgrad_partial_kernel, J.tiles, 0, st, J, nullptr);
  if (err == cudaSuccess)
    err = launch(wgrad_reduce_kernel, (J.elems + kThreads - 1) / kThreads, 0, st, J, nullptr);
  return (int)err;
}

const char* gvp_conv_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
