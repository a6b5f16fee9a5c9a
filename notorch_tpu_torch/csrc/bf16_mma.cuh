// A tile of C = A B on the tensor cores, with bf16 operands and f32 sums:
// the products of the D-MPNN kernels with matmul_dtype="bfloat16"
// (dense_mpnn_bwd.cu's two products of the reverse sweep, and
// dense_mpnn.cu's forward product relu(h) W with an m-major A, in rows 1b's
// and 7b's kernels).
//
// Shape<kM, kN, kWarpsM, kWarpsN, kK>: a kM x kN tile of 32 * kWarpsM *
// kWarpsN threads, each warp (kM / kWarpsM) x (kN / kWarpsN) outputs in m16 x
// n8 tiles of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, the sums
// in f32 registers (Shape::Tile). The k-loop stages bf16 k-slabs of kK of both
// operands in shared memory, two stages: while the warps multiply on one
// stage, each thread's share of the next slab is in flight (into registers,
// rounded to bf16 and stored after the products; or by cp.async straight
// into the other stage), one barrier a slab. Fragments come from shared
// memory by ldmatrix: non-transposed from an m-major A slab ([kM][kK]),
// transposed (.trans) from a k-major slab ([kK][kM] for A, [kK][kN] for B).
// Rows of each slab are padded by 8 halves, so the 8 rows of an ldmatrix
// lie in 8 distinct groups of 4 banks.
//
// An operand (RowsF32, RowsBf16, ColsF32, ColsBf16) names its source and where the
// tile sits in it, and stages a slab in two steps:
//   fetch(k, slab)  start loading the slab of k-rows [k, k + kK);
//   store(slab)     finish it into the slab (round to bf16, nearest, ties to
//                   even, and store what fetch holds in registers; or wait
//                   for fetch's cp.async);
// kKMajor says how its slab is laid out, kRelu whether its fragments take
// max(x, 0) after ldmatrix (an operand copied as it is). Rows past the
// operand's end are staged as zeros.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace mma {

template <int kTileM, int kTileN, int kWarpsM, int kWarpsN, int kSlabK>
struct Shape {
  static constexpr int kM = kTileM, kN = kTileN, kK = kSlabK;  // kK: the depth of a k-slab
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kWarpM = kM / kWarpsM, kWarpN = kN / kWarpsN;  // a warp's outputs
  static constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;           // its m16 and n8 tiles
  static constexpr int kLdRow = kK + 8;   // halves of a row of an m-major A slab [kM][kLdRow]
  static constexpr int kLdA = kM + 8;     // of a row of a k-major A slab [kK][kLdA]
  static constexpr int kLdB = kN + 8;     // of a row of a (k-major) B slab [kK][kLdB]
  static constexpr int kSlabA = kM * kLdRow > kK * kLdA ? kM * kLdRow : kK * kLdA;
  static constexpr int kStageHalfs = kSlabA + kK * kLdB;  // an A slab, then a B slab
  static constexpr int kSmemHalfs = 2 * kStageHalfs;      // two stages
  static_assert(kMT >= 1 && kNT % 2 == 0 && kWarpM % 16 == 0 && kK % 16 == 0, "warp tiles of m16 x (2 n8)");
  // The f32 sums a thread holds: acc[i][j][h] is the output at row
  // row0() + i * 16 + 8 * (h / 2), column col0() + j * 8 + h % 2.
  using Tile = float[kMT][kNT][4];
  __device__ static int row0() { return threadIdx.x / 32 / kWarpsN * kWarpM + threadIdx.x % 32 / 4; }
  __device__ static int col0() { return threadIdx.x / 32 % kWarpsN * kWarpN + 2 * (threadIdx.x % 4); }
};

__device__ inline unsigned shared_at(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ inline void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_at(p))
               : "memory");
}

__device__ inline void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_at(p))
               : "memory");
}

__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline unsigned relu_bf16x2(unsigned x) {
  unsigned out;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(x), "r"(0u));
  return out;
}

// Two f32 values rounded to bf16 (nearest, ties to even) as one bf16 pair.
__device__ inline unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// 4 f32 values rounded to bf16 into 8 bytes of shared memory.
__device__ inline void store_bf16x4(__nv_bfloat16* to, float4 v) {
  *reinterpret_cast<uint2*>(to) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// An m-major f32 operand: the tile's rows r0 + m (m < S::kM; zero from
// `rows` on) of a [rows, ld] source, its k-columns k..k + kK - 1; with
// kReluIn each value's max with 0 before it is rounded (x < 0 ? 0 : x, so a
// NaN passes, as torch.relu passes it).
template <typename S, bool kReluIn = false>
struct RowsF32 {
  static constexpr bool kKMajor = false, kRelu = false;
  static constexpr int kVecs = S::kM * S::kK / 4 / S::kThreads;
  static_assert(kVecs * 4 * S::kThreads == S::kM * S::kK, "a slab is whole 16-byte loads of every thread");
  const float* p;
  int ld, r0, rows;
  float4 x[kVecs];
  __device__ static float relu(float v) { return v < 0.f ? 0.f : v; }
  __device__ void fetch(int k, __nv_bfloat16*) {
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const int i = threadIdx.x + t * S::kThreads, m = r0 + i / (S::kK / 4), c = i % (S::kK / 4) * 4;
      float4 v = m < rows ? *reinterpret_cast<const float4*>(p + (size_t)m * ld + k + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kReluIn) v = make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
      x[t] = v;
    }
  }
  __device__ void store(__nv_bfloat16* slab) {
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const int i = threadIdx.x + t * S::kThreads;
      store_bf16x4(slab + i / (S::kK / 4) * S::kLdRow + i % (S::kK / 4) * 4, x[t]);
    }
  }
};

// A k-major f32 operand: its rows k.. k + kK - 1 (zero from k1 on) of a
// [rows, ld] source, the tile's columns c0 + c (c < kCols, a slab row kLd
// halves); with kReluIn each value's max with 0 before it is rounded.
template <typename S, int kCols, int kLd, bool kReluIn>
struct ColsF32 {
  static constexpr bool kKMajor = true, kRelu = false;
  static constexpr int kVecs = S::kK * kCols / 4 / S::kThreads;
  static_assert(kVecs * 4 * S::kThreads == S::kK * kCols, "a slab is whole 16-byte loads of every thread");
  const float* p;
  int ld, c0, k1;
  float4 x[kVecs];
  __device__ void fetch(int k, __nv_bfloat16*) {
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const int i = threadIdx.x + t * S::kThreads, r = k + i / (kCols / 4), c = i % (kCols / 4) * 4;
      float4 v = r < k1 ? *reinterpret_cast<const float4*>(p + (size_t)r * ld + c0 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kReluIn) v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      x[t] = v;
    }
  }
  __device__ void store(__nv_bfloat16* slab) {
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const int i = threadIdx.x + t * S::kThreads;
      store_bf16x4(slab + i / (kCols / 4) * kLd + i % (kCols / 4) * 4, x[t]);
    }
  }
};

// An m-major bf16 operand (the depth-fused forward's exchange of relu(h),
// rounded as it was written): the tile's rows r0 + m (zero from `rows` on)
// of a [rows, ld] source, its k-columns k.. k + kK - 1, copied as they are
// by cp.async.
template <typename S>
struct RowsBf16 {
  static constexpr bool kKMajor = false, kRelu = false;
  static constexpr int kPieces = S::kM * S::kK / 8 / S::kThreads;  // 16-byte pieces a thread
  static_assert(kPieces * 8 * S::kThreads == S::kM * S::kK, "a slab is whole 16-byte pieces of every thread");
  const __nv_bfloat16* p;
  int ld, r0, rows;
  __device__ void fetch(int k, __nv_bfloat16* slab) {
#pragma unroll
    for (int t = 0; t < kPieces; ++t) {
      const int i = threadIdx.x + t * S::kThreads, m = i / (S::kK / 8), c = i % (S::kK / 8) * 8;
      __nv_bfloat16* to = slab + m * S::kLdRow + c;
      if (r0 + m < rows)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_at(to)),
                     "l"(p + (size_t)(r0 + m) * ld + k + c));
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __device__ void store(__nv_bfloat16*) { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
};

// A k-major bf16 operand (the stash): its rows k.. (zero from k1 on), the
// tile's columns c0.. c0 + S::kM - 1, copied as they are by cp.async; the
// ReLU taken on the fragments.
template <typename S>
struct ColsBf16 {
  static constexpr bool kKMajor = true, kRelu = true;
  static constexpr int kPieces = S::kK * S::kM / 8 / S::kThreads;  // 16-byte pieces a thread
  const __nv_bfloat16* p;
  int ld, c0, k1;
  __device__ void fetch(int k, __nv_bfloat16* slab) {
#pragma unroll
    for (int t = 0; t < kPieces; ++t) {
      const int i = threadIdx.x + t * S::kThreads, r = k + i / (S::kM / 8), c = i % (S::kM / 8) * 8;
      __nv_bfloat16* to = slab + i / (S::kM / 8) * S::kLdA + c;
      if (r < k1)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_at(to)),
                     "l"(p + (size_t)r * ld + c0 + c));
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __device__ void store(__nv_bfloat16*) { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
};

// The products of one stage (S::kK deep) into acc.
template <typename S, bool kAKMajor, bool kRelu>
__device__ inline void stage_products(const __nv_bfloat16* As, const __nv_bfloat16* Bs, typename S::Tile& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (S::kN / S::kWarpN) * S::kWarpM, wn = warp % (S::kN / S::kWarpN) * S::kWarpN;
  const int q = lane / 8, r = lane % 8;  // the lane's matrix of an x4 load, and its row there
#pragma unroll
  for (int kk = 0; kk < S::kK; kk += 16) {
    unsigned b[S::kNT][2];
#pragma unroll
    for (int j = 0; j < S::kNT; j += 2) {  // matrices (k 0-7, n j), (k 8-15, n j), (k 0-7, n j+1), (k 8-15, n j+1)
      unsigned t[4];
      ldsm_x4_trans(t, Bs + (kk + q % 2 * 8 + r) * S::kLdB + wn + j * 8 + q / 2 * 8);
      b[j][0] = t[0];
      b[j][1] = t[1];
      b[j + 1][0] = t[2];
      b[j + 1][1] = t[3];
    }
#pragma unroll
    for (int i = 0; i < S::kMT; ++i) {
      const int m = wm + i * 16;
      unsigned a[4];
      if constexpr (kAKMajor)  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        ldsm_x4_trans(a, As + (kk + q / 2 * 8 + r) * S::kLdA + m + q % 2 * 8);
      else
        ldsm_x4(a, As + (m + lane % 16) * S::kLdRow + kk + lane / 16 * 8);
      if constexpr (kRelu)
#pragma unroll
        for (int t = 0; t < 4; ++t) a[t] = relu_bf16x2(a[t]);
#pragma unroll
      for (int j = 0; j < S::kNT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
    }
  }
}

// acc = the tile's products over k in [k0, k1) (k0 < k1), slab by slab from
// k0: A staged by `la` (its rows A's m), B by `lb`; smem holds S::kSmemHalfs
// halves, 16-byte aligned. The slabs' order of summation is fixed, so two
// runs give the same bits.
template <typename S, typename LoadA, typename LoadB>
__device__ inline void tile_products(int k0, int k1, __nv_bfloat16* smem, LoadA& la, LoadB& lb,
                                     typename S::Tile& acc) {
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.f;
  auto A = [&](int s) { return smem + s * S::kStageHalfs; };
  auto B = [&](int s) { return smem + s * S::kStageHalfs + S::kSlabA; };
  la.fetch(k0, A(0));
  lb.fetch(k0, B(0));
  la.store(A(0));
  lb.store(B(0));
  __syncthreads();
  int s = 0;
  for (int k = k0; k < k1; k += S::kK) {
    const bool more = k + S::kK < k1;
    if (more) {
      la.fetch(k + S::kK, A(s ^ 1));
      lb.fetch(k + S::kK, B(s ^ 1));
    }
    stage_products<S, LoadA::kKMajor, LoadA::kRelu>(A(s), B(s), acc);
    if (more) {
      la.store(A(s ^ 1));
      lb.store(B(s ^ 1));
    }
    __syncthreads();
    s ^= 1;
  }
}

}  // namespace mma
}  // namespace
