// Tiled 3x3 "same" convolution for Hopper (sm_90a): warpgroup tensor-core products
// (wgmma.mma_async m64nNk16, bf16 operands, float32 sums in registers) fed by a
// 3-stage cp.async ring, with the bf16 staging conversion and the epilogues, shared by
// rrdb.cu, rrdb_trunk.cu, chain3s.cu and conv.cu.
//
// The conv is an implicit GEMM: M = output pixels, N = COUT (16, 32, 48 or 64), K =
// 9 taps x cin (the wide float32 conv, below, turns it around).  The dense-block kernels
// keep their concats free: a dense block owns one NHWC bf16 buffer (B,H,W,ctot) holding
// [input | x1 | x2 | x3 | x4], and conv i reads a channel prefix of it.
//
// Tiles.  A block of two warpgroups computes a tile 16 pixels tall and 8 MT wide
// (MT = 1 or 2, a template parameter chosen per image width by with_mt so that the
// tiles waste no more columns than 8-wide ones: 16x16 at 80x80, 8x16 at 40x40 and
// 20x20, where 16-wide tiles would also leave the card underfilled: 48 blocks at
// 16x20x20).  Warpgroup g owns rows 8g..8g+7 and, in them, MT sub-tiles of 8x8 = 64
// pixels, one wgmma M tile each; more than one M tile per block amortises the halo
// (1.27x the output pixels at MT 2) and the weights.  A persistent variant whose ring
// ran on across a block's tiles (the next tile's chunks in flight during a tile's
// epilogue) measured 8-17% slower on the RRDB kernels than one tile a block with 2
// blocks per SM, which already overlap one block's fill with the other's products
// (PERF.md, PR 4); rrdb_trunk.cu loops over tiles because it must.
//
// The ring.  Per chunk of 16 input channels (one k16 step per tap; every cin the
// kernels take is a multiple of 16, which also covers the gc-16 RRDBs and chain3s's
// padded inputs, and needs no swizzle), one stage holds the tile with its 1-pixel halo
// and the chunk's 9 x 16 x COUT weights: 28.8 KB at COUT 64, 3 stages, 2 blocks/SM.
// All 256 threads copy with cp.async (16 bytes each, L2 only: .cg, so the persistent
// trunk kernel reads what other blocks wrote in the same launch), zero-filling the
// halo outside the image (src-size 0); the refill of chunk c+2 is issued just after
// the products of chunk c, and runs beside them.  (conv.cu's float32 input is the
// exception: its threads load it and store it rounded to bf16, which then waits
// behind the products, not in front of them; no bf16 copy of x is written and read
// back.)  cp.async over TMA because the halo's zero fill and both operand
// layouts below are a per-16-byte scatter that needs no tensor map (the dense
// buffers are allocated per call, and the cooperative trunk would need an
// async-proxy fence between one stage's stores and the next stage's TMA loads).  No
// warp specialisation: the block barrier that publishes chunk c also tells every
// thread that each warpgroup has waited out its products of chunk c-1, so that stage
// can be refilled (cp.async groups and __syncthreads instead of mbarriers).  What
// bounds the kernels is the copies, not the products (without the products an RRDB
// took 96-97% of its time; without the weight refills, 65-80%): every block reads each
// chunk's 5-18 KB of weights, so each tile starts at its own chunk (the tile's
// number modulo the chunk count), which spreads the blocks in flight over the
// weights' lines of L2 and took 12-19% off.
//
// Operand layouts (wgmma without swizzle: core matrices of 8 rows x 16 bytes).
// A, K-major from shared memory: the staged tile is [channel group of 8][halo pixel]
// [8 channels], so 8 consecutive pixels of a halo row are one core matrix; with 8x8
// sub-tiles, the next 8 rows of M are the next halo row at a uniform stride (SBO =
// halo row pitch), and the next 8 channels the next group's plane (LBO).  A shifted
// tap window is then just another start address.  (A 16-pixel-wide M row would
// alternate strides of 8 px and IW-8 px, which no descriptor expresses.)  A from
// registers (ldmatrix, then wgmma's RS form) was measured against this on the same
// tiles: with one ldmatrix a tap, reusing the fragment registers while an earlier
// product still reads them gave wrong sums unless each tap waits out its products
// (7% slower); holding all 9 taps' fragments spills (48% slower).  B, the weights,
// MN-major (transposed) from shared memory: the packed (9, cin, cout) [tap][ci][co]
// rows are scattered 16 bytes at a time into [tap][k group][n group][8 k][8 n], so
// the global pack is unchanged (SBO = 128 bytes between n groups, LBO = COUT x 16
// between k groups).
//
// Epilogues read the accumulator fragment in registers (each thread holds channel
// pairs of two pixels per 8x8 sub-tile) with the same float32 arithmetic and fmaf
// order as before; chain3s's coupling, which needs channels that sit in different
// threads, stages the sums through shared memory once (stage_acc).
//
// The float32 recipe (float32 dense buffers, which the kernels take when the weights are
// float pointers) computes what the plain version computes under exact_f32(): float32
// operands and sums, no rounding of the features.  The card has no float32 tensor-core
// product, so each product is split in TF32 ones: x = hi + lo with hi = rna(x) and lo =
// rna(x - hi) (TF32, to nearest, ties away from zero), and a*b ~ lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b, summed in float32: about 21 bits of each operand, an error of ~2^-21
// relative a product (single-pass TF32: 2^-11).  Each operand is split once, never in the
// tap loop: the weights when they are packed (nets.pack_tf32: a hi and a lo plane in
// device memory, K-major core matrices of 8 outputs x 4 inputs, which cp.async copies
// unchanged), the input once a stage: cp.async lands the float32 chunk as [channel group
// of 4][halo pixel][4 channels] (the bf16 layout with 4 channels to a 16-byte group, so a
// tap window is again a start address), and each thread splits the pieces it copied
// itself, in place, into a hi and a lo plane while the products of the chunk before run.
// A stage holds CK_F32 = 8 input channels (input hi + lo and weights hi + lo: 48.4 KB at
// COUT 64 on 16-wide tiles), 2 to 4 stages by COUT and MT (stages_f32), so that 2 blocks
// share an SM.  The products are wgmma m64nNk8 .tf32 with both operands from shared
// memory; that form takes only K-major operands, and both staged layouts are K-major
// core matrices (8 rows x 16 bytes) in either role, so the GEMM runs either way round:
//
// - narrow (conv_tile_f32; COUT 16, and chain3s.cu): M = a sub-tile's 64 pixels, N =
//   COUT, on the bf16 design's tiles and fragment (Acc, for_each_pair and the epilogues
//   serve both recipes); lo x hi, hi x lo, hi x hi a k8 step, and at COUT 16 hi x hi and
//   hi x lo as one product twice as wide (10% off the gc-16 RRDBs).
// - wide (conv_tile_f32w; COUT 32 and 64, wide_f32): M = the output channels, the weights
//   as A, N = the warpgroup's 16 x 8 pixel column (128; at MT 1 its 8 x 8 pixels, 64).  A
//   product from shared memory is bound by its reads, not by the tensor cores: m64nNk8
//   reads 2 KB of A and 32 N bytes of B for N / 8 clocks of tensor work, 192 bytes a clock
//   at the narrow N 32 and 128 at N 64 against an SM's 128, 96 at N 128.  At COUT 32
//   [W hi; W lo] is one A of 64 rows (each channel group's lo rows staged after its hi
//   rows), two products a k8 step give all four TF32 terms (lo x lo too, for free) and
//   the epilogue adds rows o and o + 32.  At COUT 16 [W hi; W lo] would fill 32 of M's 64
//   rows: it stays narrow.  The fragment's rows are channels and its columns pixels, so
//   the epilogues stage it through the freed ring (AccW, stage_accw, for_each_quad) and
//   store NHWC coalesced, with the narrow epilogues' arithmetic and fmaf order.
//
// Measured (PERF.md, H100): the wide conv took 8% off a float32 RRDB at nf 64 / gc 32
// (4-5% at gc 16); there one product a k8 step instead of two or three is 34% faster,
// the weights left unstaged 18-19%, the input left unsplit 2-4%.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace conv3x3 {
namespace {  // internal linkage: each kernel library has its own copy

using bf16 = __nv_bfloat16;

constexpr int NWG = 2, NTHREADS = 128 * NWG;  // two consumer warpgroups
constexpr int TH = 8 * NWG;                   // tile height: 8 rows per warpgroup
constexpr int MAX_MT = 2;                     // 8x8 sub-tiles per warpgroup (tile width 8 mt)
constexpr int CK = 16;                        // input channels per ring stage
constexpr int STAGES = 3;
constexpr int IH = TH + 2, MAX_IW = 8 * MAX_MT + 2;  // staged tile with its 1-pixel halo
constexpr int IN_BYTES = IH * MAX_IW * CK * 2;

template <int COUT>
__host__ __device__ constexpr int stage_bytes() { return IN_BYTES + 9 * CK * COUT * 2; }
template <int COUT>
__host__ __device__ constexpr int smem_bytes() { return STAGES * stage_bytes<COUT>(); }

// The float32 (3xTF32) ring: CK_F32 input channels a stage (one k8 step a tap per 8),
// A and B each as a hi and a lo TF32 plane; as many stages (2 to F32_STAGES) as let
// F32_BLOCKS blocks share an SM.  A plane of A holds the tile of width 8 MT with its halo.
constexpr int CK_F32 = 8, F32_BLOCKS = 2, F32_STAGES = 4;
// Whether a float32 dense-block conv of cout outputs runs the wide tile conv
// (conv_tile_f32w: output channels as wgmma's M, pixels as N) and not the narrow one
// (conv_tile_f32: pixels as M, the outputs as N): where [W hi; W lo] fills M's 64 rows.
// The kernel libraries export it (hcflow_rrdb_f32_wide) for the wrappers' counts.
__host__ __device__ constexpr bool wide_f32(int cout) { return 2 * cout >= 64; }
// Where COUT is at most F32_FUSE, the narrow conv runs hi x hi and hi x lo as one product
// of twice the width (see conv_tile_f32)
constexpr int F32_FUSE = 16;
template <int COUT>
__host__ __device__ constexpr bool fuse_f32() { return COUT <= F32_FUSE; }
// Whether each channel group's lo rows of the weights follow its hi rows in a stage: in
// the narrow conv where fused (B hi | B lo one operand 2 COUT wide), in the wide one at
// COUT 32 ([W hi; W lo] one A operand of 64 rows)
template <int COUT, bool WIDE>
__host__ __device__ constexpr bool interleaved_f32() {
  return WIDE ? COUT < 64 : fuse_f32<COUT>();
}
// The weights' rows (16 bytes: 4 input channels of an output) in a stage: [tap][channel
// group of 4][COUT outputs], b_k_rows apart from one group to the next, each lo row
// b_lo_rows after its hi row: the lo plane after the hi plane, or interleaved
template <int COUT, bool WIDE = false>
__host__ __device__ constexpr int b_k_rows() {
  return interleaved_f32<COUT, WIDE>() ? 2 * COUT : COUT;
}
template <int COUT, bool WIDE = false>
__host__ __device__ constexpr int b_lo_rows() {
  return interleaved_f32<COUT, WIDE>() ? COUT : 9 * CK_F32 / 4 * COUT;
}
constexpr int SM_SMEM = 233472;     // shared memory of an SM; 1 KB of it reserved a block
constexpr int BLOCK_SMEM = 232448;  // the most a block may have
template <int MT>
__host__ __device__ constexpr int a_plane_f32() { return IH * (8 * MT + 2) * CK_F32 * 4; }
template <int COUT>
__host__ __device__ constexpr int b_plane_f32() { return 9 * CK_F32 * COUT * 4; }
template <int COUT, int MT>
__host__ __device__ constexpr int stage_bytes_f32() {
  return 2 * a_plane_f32<MT>() + 2 * b_plane_f32<COUT>();
}
template <int COUT, int MT>
__host__ __device__ constexpr int stages_f32() {
  constexpr int sb = stage_bytes_f32<COUT, MT>();
  int s = 2;
  while (s < F32_STAGES && F32_BLOCKS * ((s + 1) * sb + 1024) <= SM_SMEM &&
         (s + 1) * sb <= BLOCK_SMEM)
    ++s;
  return s;
}
template <int COUT, int MT>
__host__ __device__ constexpr int smem_bytes_f32() {
  return stages_f32<COUT, MT>() * stage_bytes_f32<COUT, MT>();
}
// The dynamic shared memory of a tile-conv kernel whose dense buffers hold T
template <int COUT, class T, int MT>
__host__ __device__ constexpr int smem_for() {
  return std::is_same<T, float>::value ? smem_bytes_f32<COUT, MT>() : smem_bytes<COUT>();
}

// The elements of one packed conv's weights as the kernels read them: bf16 (9, cin,
// cout); float32 its two TF32 planes, (2, 9, cin / 4, cout, 4)
template <class T>
__host__ __device__ constexpr size_t w_elems(int cin, int cout) {
  return size_t(std::is_same<T, float>::value ? 2 : 1) * 9 * cin * cout;
}

// fn(std::integral_constant<int, MT>()) with the sub-tile count every launcher takes
// for image width W: 16-pixel-wide tiles where they waste no more columns than
// 8-pixel-wide ones.
template <class Fn>
cudaError_t with_mt(int W, Fn fn) {
  if ((W + 15) / 16 * 16 == (W + 7) / 8 * 8) return fn(std::integral_constant<int, 2>());
  return fn(std::integral_constant<int, 1>());
}

dim3 grid(int B, int H, int W, int mt) {
  return dim3((W + 8 * mt - 1) / (8 * mt), (H + TH - 1) / TH, B);
}

// ------------------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it through the
// async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// The float32 chain kernel's (chain.cu) split in registers and its mma.sync products.
// x = hi + lo, hi and lo TF32 values, the ones cvt.rna.tf32.f32 gives (round to nearest,
// ties away from zero): hi = rna(x), lo = rna(x - hi), x - hi exact in float32.  By bit
// arithmetic, four full-rate operations (two cvt.rna and a subtraction took 40% of the
// float32 chain kernel's time, PERF.md): a TF32 operand of mma is read from the top 19
// bits of its register, so adding half a TF32 ulp (0x1000) to a finite float's bits
// rounds its magnitude to nearest, ties away, once the product truncates the rest; hi's
// value for the subtraction has those bits cleared.  (A NaN x gives a NaN lo.)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x + 0x1000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}
// d += a (16 x 8, row) * b (8 x 8, col); TF32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a * b in float32 accuracy from split operands: the small products first
__device__ __forceinline__ void mma_3xtf32(float& d0, float& d1, float& d2, float& d3,
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(d0, d1, d2, d3, al, bh0, bh1);
  mma_tf32(d0, d1, d2, d3, ah, bl0, bl1);
  mma_tf32(d0, d1, d2, d3, ah, bh0, bh1);
}

// wgmma shared-memory descriptor without swizzle; lbo, sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 | uint64_t(sbo >> 4) << 32;
}

// d += A (64 x 16, K-major) * B (16 x N, MN-major), both from shared memory
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(1)
        : "memory");
  }
};

// d += A (64 x 8, K-major) * B (8 x N, K-major), TF32 operands from shared memory (the
// .tf32 form takes both K-major and has no transpose flags)
template <int N>
struct WgmmaTF32;

#define CONV3X3_ACC8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
// REGS: the accumulator's operand list; A, B, P: the operand numbers of a, b and the
// scale-d flag
#define CONV3X3_WGMMA_TF32(N, REGS, A, B, P, ...)                                          \
  template <>                                                                              \
  struct WgmmaTF32<N> {                                                                    \
    static __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " REGS ", " A    \
                   ", " B ", p, 1, 1;\n}\n"                                                 \
                   : __VA_ARGS__                                                           \
                   : "l"(a), "l"(b), "r"(1)                                                \
                   : "memory");                                                            \
    }                                                                                      \
  };

CONV3X3_WGMMA_TF32(16, "{%0, %1, %2, %3, %4, %5, %6, %7}", "%8", "%9", "%10", CONV3X3_ACC8(0))
CONV3X3_WGMMA_TF32(32,
                   "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}",
                   "%16", "%17", "%18", CONV3X3_ACC8(0), CONV3X3_ACC8(8))
CONV3X3_WGMMA_TF32(48,
                   "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                   "%16, %17, %18, %19, %20, %21, %22, %23}",
                   "%24", "%25", "%26", CONV3X3_ACC8(0), CONV3X3_ACC8(8), CONV3X3_ACC8(16))
CONV3X3_WGMMA_TF32(64,
                   "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
                   "%31}",
                   "%32", "%33", "%34", CONV3X3_ACC8(0), CONV3X3_ACC8(8), CONV3X3_ACC8(16),
                   CONV3X3_ACC8(24))
CONV3X3_WGMMA_TF32(128,
                   "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
                   "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
                   "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                   "%61, %62, %63}",
                   "%64", "%65", "%66", CONV3X3_ACC8(0), CONV3X3_ACC8(8), CONV3X3_ACC8(16),
                   CONV3X3_ACC8(24), CONV3X3_ACC8(32), CONV3X3_ACC8(40), CONV3X3_ACC8(48),
                   CONV3X3_ACC8(56))
#undef CONV3X3_WGMMA_TF32
#undef CONV3X3_ACC8

// ------------------------------------------------------------------ dense staging
// One or two float32 values into a dense buffer of T (bf16: rounded to nearest even)
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// dense[p, c] = T(x[p, c]) for the n = pixels * C values of x (C channels) into
// dense (ctot channels; its others are not written), four values a thread (16-byte
// loads; C and ctot are multiples of 4), grid-stride over the caller's grid.
template <class T>
__device__ __forceinline__ void to_dense(const float* __restrict__ x, T* __restrict__ dense,
                                         int ctot, int C, size_t n) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n / 4;
       i += size_t(gridDim.x) * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    const size_t e = 4 * i;
    T* d = dense + (e / C) * ctot + e % C;
    store2(d, v.x, v.y);
    store2(d + 2, v.z, v.w);
  }
}

template <class T>
__global__ void to_dense_kernel(const float* __restrict__ x, T* __restrict__ dense, int ctot,
                                int C, size_t n) {
  to_dense(x, dense, ctot, C, n);
}

template <class T>
cudaError_t launch_to_dense(const float* x, T* dense, int ctot, int C, size_t n,
                            cudaStream_t stream) {
  const size_t blocks = (n / 4 + 255) / 256;
  to_dense_kernel<T><<<unsigned(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(x, dense, ctot,
                                                                                 C, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------- tile conv
// One warpgroup's sums: v[s] is sub-tile s's 64 x COUT fragment (wgmma's accumulator
// layout: see for_each_pair).  MT, the sub-tiles a warpgroup owns, is a compile-time
// constant: with a run-time count, each wgmma sat under a branch and ptxas fenced
// every product (its note C7519); the constant took 5-11% off the kernels.
template <int COUT, int MT>
struct Acc {
  float v[MT][COUT / 2];
};

// Eight float32 channels x[c .. c+7] of one pixel (C channels; zero from C on) as
// eight bf16, round to nearest even; 16-byte loads where C is a multiple of 8.
__device__ __forceinline__ uint4 bf16x8(const float* __restrict__ x, int c, int C) {
  float f[8];
  if (C % 8 == 0 && c < C) {
    const float4 lo = *reinterpret_cast<const float4*>(x + c);
    const float4 hi = *reinterpret_cast<const float4*>(x + c + 4);
    f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
    f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = c + k < C ? x[c + k] : 0.f;
  }
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    u[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Stage chunk c0 .. c0+15 of the tile at (x0, y0) and its weights into one ring stage.
// The input `src` is a bf16 buffer of ctot channels (copied with cp.async) or, for
// conv.cu, float32 x of ctot = C channels, which the threads load and round to bf16
// themselves (channels from C on are zero).
template <int COUT, class In>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const In* src, int ctot, int c0,
                                           const bf16* w, int cin, int H, int W, int IW, int x0,
                                           int y0, size_t img) {
  constexpr int NG = COUT / 8;
  const uint32_t s_in = smem_addr(stage), s_w = s_in + IN_BYTES;
  const int npx = IH * IW;
  // input tile + halo, [channel group][pixel][8]; zero outside the image
  for (int i = threadIdx.x; i < 2 * npx; i += NTHREADS) {
    const int part = i & 1, q = i >> 1;
    const int gy = y0 - 1 + q / IW, gx = x0 - 1 + q % IW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t pix = img + size_t(gy) * W + gx;
    if constexpr (std::is_same<In, float>::value) {
      *reinterpret_cast<uint4*>(stage + (part * npx + q) * 16) =
          in ? bf16x8(src + pix * ctot, c0 + part * 8, ctot) : make_uint4(0, 0, 0, 0);
    } else {
      cp_async16(s_in + (part * npx + q) * 16, in ? src + pix * ctot + c0 + part * 8 : src, in);
    }
  }
  // weights (9, cin, COUT) [tap][ci][co] -> [tap][k group][n group][8 k][8 n]
  for (int e = threadIdx.x; e < 9 * CK * NG; e += NTHREADS) {
    const int tap = e / (CK * NG), r = e % (CK * NG), k = r / NG, ng = r % NG;
    cp_async16(s_w + (((tap * 2 + k / 8) * NG + ng) * 8 + k % 8) * 16,
               w + (size_t(tap) * cin + c0 + k) * COUT + ng * 8, true);
  }
}

// The conv of the tile at (x0, y0) of image `image` (width 8 MT, height TH): src
// (B,H,W,ctot) bf16 (or float32: see load_chunk), channels [0, cin) read (cin a
// multiple of 16); w (9, cin, COUT) bf16 [tap][ci][co].  smem holds
// smem_bytes<COUT>() (dynamic shared memory); the sums are left in acc.  Chunks, taps
// and k steps run in one fixed order, so every kernel that calls this gives
// bit-identical sums for the same inputs.
template <int COUT, int MT, class In>
__device__ __forceinline__ void conv_tile(Acc<COUT, MT>& acc, unsigned char* smem,
                                          const In* __restrict__ src, int ctot, int cin,
                                          const bf16* __restrict__ w, int H, int W, int x0,
                                          int y0, int image) {
  static_assert(COUT % 16 == 0 && COUT <= 64, "COUT must be 16, 32, 48 or 64");
  static_assert(MT >= 1 && MT <= MAX_MT, "MT must be 1 or 2");
  constexpr int SB = stage_bytes<COUT>(), IW = 8 * MT + 2;
  constexpr uint32_t lbo_a = IH * IW * 16, sbo_a = IW * 16;  // next 8 channels, next halo row
  const int nchunks = cin / CK, wg = threadIdx.x / 128;
  const size_t img = size_t(image) * H * W;
  // The chunks run in a rotated order, from the tile's number modulo nchunks: the
  // blocks in flight then read different weight chunks at once, not all the same few
  // lines of L2.  The order depends on the tile alone, as every kernel numbers them.
  const int tx = (W + 8 * MT - 1) / (8 * MT), ty = (H + TH - 1) / TH;
  const int first = ((image * ty + y0 / TH) * tx + x0 / (8 * MT)) % nchunks;
  auto c0 = [&](int c) { return (c + first) % nchunks * CK; };
#pragma unroll
  for (int s = 0; s < MT; ++s)
#pragma unroll
    for (int j = 0; j < COUT / 2; ++j) acc.v[s][j] = 0.f;

  __syncthreads();  // the ring's last contents (another tile, an epilogue) are consumed
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks)
      load_chunk<COUT>(smem + c * SB, src, ctot, c0(c), w, cin, H, W, IW, x0, y0, img);
    cp_async_commit();
  }
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    fence_proxy_async();          // (as have its own stores of a float32 input)
    __syncthreads();  // everyone's have; every warpgroup is done with chunk c-1's stage
    const uint32_t s_in = smem_addr(smem + c % STAGES * SB), s_w = s_in + IN_BYTES;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t b = desc(s_w + tap * 2 * COUT * 16, COUT * 16, 128);
#pragma unroll
      for (int s = 0; s < MT; ++s)
        Wgmma<COUT>::mma(acc.v[s],
                         desc(s_in + ((8 * wg + dy) * IW + 8 * s + dx) * 16, lbo_a, sbo_a), b);
    }
    wgmma_commit();
    // refill chunk c-1's stage while the products of chunk c run (a float32 input's
    // loads then wait behind the products, not in front of them)
    const int next = c + STAGES - 1;
    if (next < nchunks)
      load_chunk<COUT>(smem + next % STAGES * SB, src, ctot, c0(next), w, cin, H, W, IW, x0, y0,
                       img);
    cp_async_commit();
    wgmma_wait0();
#pragma unroll
    for (int s = 0; s < MT; ++s)
#pragma unroll
      for (int j = 0; j < COUT / 2; ++j) asm volatile("" : "+f"(acc.v[s][j])::"memory");
  }
}

// Stage chunk c0 .. c0+CK_F32-1 of the tile at (x0, y0) (float32, ctot channels) and its
// weights' TF32 planes w (2, 9, cin / 4, COUT, 4) into one float32 ring stage: the input
// into A's hi plane [channel group of 4][halo pixel][4 channels] (zero outside the
// image; split_chunk_f32 splits it), the planes as b_k_rows and b_lo_rows lay them out.
// Every copy is 16 bytes.  (load_input_f32, then load_weights_f32.)  A copy loop that is
// unrolled lets the compiler keep its addresses in registers from chunk to chunk: LEAN
// rolls both loops up for a caller that holds much of its own state across the conv (the
// resident trunk, which spilled up to 380 bytes, and 432 with the wide accumulator; the
// per-conv kernels ran 4% slower rolled up), WIDE the weights' loop (beside its
// accumulator, conv_tile_f32w's per-conv kernels spilled).
template <bool ROLLED, int N, class Fn>
__device__ __forceinline__ void for_each_thread(Fn fn) {  // fn(i), i < N, a thread's i
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = threadIdx.x; i < N; i += NTHREADS) fn(i);
  } else {
    for (int i = threadIdx.x; i < N; i += NTHREADS) fn(i);
  }
}

template <int MT, bool LEAN = false>
__device__ __forceinline__ void load_input_f32(unsigned char* stage, const float* src, int ctot,
                                               int c0, int H, int W, int x0, int y0, size_t img) {
  constexpr int IW = 8 * MT + 2, NPX = IH * IW, G = CK_F32 / 4;
  const uint32_t s_a = smem_addr(stage);
  for_each_thread<LEAN, G * NPX>([&](int i) {
    const int g = i % G, q = i / G;
    const int gy = y0 - 1 + q / IW, gx = x0 - 1 + q % IW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t pix = img + size_t(gy) * W + gx;
    cp_async16(s_a + (g * NPX + q) * 16, in ? src + pix * ctot + c0 + 4 * g : src, in);
  });
}

template <int COUT, int MT, bool WIDE = false, bool LEAN = false>
__device__ __forceinline__ void load_weights_f32(unsigned char* stage, int c0, const float* w,
                                                 int cin) {
  constexpr int G = CK_F32 / 4, ROWS = 9 * G * COUT;  // 16-byte rows of a plane a stage
  const uint32_t s_b = smem_addr(stage) + 2 * a_plane_f32<MT>();
  for_each_thread<WIDE || LEAN, 2 * ROWS>([&](int e) {
    const int p = e / ROWS, r = e % ROWS, tap = r / (G * COUT), kc = r % (G * COUT);
    const int row = r / COUT * b_k_rows<COUT, WIDE>() + p * b_lo_rows<COUT, WIDE>() + r % COUT;
    cp_async16(s_b + row * 16, w + (size_t(p * 9 + tap) * cin + c0) * COUT + kc * 4, true);
  });
}

// WIDE: for conv_tile_f32w, the weights laid out for it
template <int COUT, int MT, bool WIDE = false, bool LEAN = false>
__device__ __forceinline__ void load_chunk_f32(unsigned char* stage, const float* src, int ctot,
                                               int c0, const float* w, int cin, int H, int W,
                                               int x0, int y0, size_t img) {
  load_input_f32<MT, LEAN>(stage, src, ctot, c0, H, W, x0, y0, img);
  load_weights_f32<COUT, MT, WIDE, LEAN>(stage, c0, w, cin);
}

// The chunk a tile's float32 conv starts at (its number modulo the chunk count; see
// conv_tile)
template <int MT>
__device__ __forceinline__ int first_chunk_f32(int nchunks, int H, int W, int x0, int y0,
                                               int image) {
  const int tx = (W + 8 * MT - 1) / (8 * MT), ty = (H + TH - 1) / TH;
  return ((image * ty + y0 / TH) * tx + x0 / (8 * MT)) % nchunks;
}

// The weights of the chunks conv_tile_f32<COUT, MT, true> stages first (all but the
// last stage of its ring), copied ahead as one cp.async group, into a ring that no thread
// still reads: a caller that must wait before it may read the tile's input starts these
// copies before it waits.
template <int COUT, int MT>
__device__ __forceinline__ void prefetch_weights_f32(unsigned char* smem, const float* w, int cin,
                                                     int H, int W, int x0, int y0, int image) {
  constexpr int S = stages_f32<COUT, MT>(), SB = stage_bytes_f32<COUT, MT>();
  const int nchunks = cin / CK_F32, first = first_chunk_f32<MT>(nchunks, H, W, x0, y0, image);
  for (int c = 0; c < S - 1 && c < nchunks; ++c)
    load_weights_f32<COUT, MT>(smem + c * SB, (c + first) % nchunks * CK_F32, w, cin);
  cp_async_commit();
}

// x = hi + lo as TF32 bit patterns, the low 13 bits clear: hi = rna(x), lo = rna(x - hi)
// (x - hi exact; rna as in split_tf32), what nets.pack_tf32 gives the weights.
__device__ __forceinline__ void tf32_planes(uint32_t& x, uint32_t& lo) {
  const uint32_t hi = (x + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
  x = hi;
}

// Split the input of the stage that load_chunk_f32 filled into its hi and lo planes, in
// place: each thread splits the 16-byte pieces it copied itself, so it needs only its
// own cp.async wait, no barrier, before it.
template <int MT>
__device__ __forceinline__ void split_chunk_f32(unsigned char* stage) {
  constexpr int NPX = IH * (8 * MT + 2), G = CK_F32 / 4;
  uint4* a = reinterpret_cast<uint4*>(stage);
  for (int i = threadIdx.x; i < G * NPX; i += NTHREADS) {
    const int e = i % G * NPX + i / G;
    uint4 v = a[e], lo;
    tf32_planes(v.x, lo.x);
    tf32_planes(v.y, lo.y);
    tf32_planes(v.z, lo.z);
    tf32_planes(v.w, lo.w);
    a[e] = v;
    a[e + a_plane_f32<MT>() / 16] = lo;
  }
}

// conv_tile in float32, 3xTF32 on wgmma (see the top of this file): src (B,H,W,ctot)
// float32, channels [0, cin) read (cin a multiple of CK_F32); w the weights' TF32 planes
// (2, 9, cin / 4, COUT, 4) (nets.pack_tf32).  smem holds smem_bytes_f32<COUT, MT>(); the
// sums are left in acc, laid out as conv_tile's.  Each k8 step takes lo x hi, hi x lo and
// hi x hi into acc; where COUT <= F32_FUSE, it takes lo x hi into acc and hi x [B hi
// | B lo] as one product 2 COUT wide into a second accumulator (A hi then read once a
// step: a narrow product is bound by its reads of shared memory, not by the tensor
// cores), and the sums are (lo x hi + hi x lo) + hi x hi.  Chunks (in conv_tile's rotated
// order), taps, k steps and products run in one fixed order, so every kernel that calls
// this gives bit-identical sums for the same inputs.  PREFETCHED: the caller has copied
// the first chunks' weights (prefetch_weights_f32), and the ring stages only their input.
// LEAN: the copy loops rolled up (see for_each_thread).
template <int COUT, int MT, bool PREFETCHED = false, bool LEAN = false>
__device__ __forceinline__ void conv_tile_f32(Acc<COUT, MT>& acc, unsigned char* smem,
                                              const float* __restrict__ src, int ctot, int cin,
                                              const float* __restrict__ w, int H, int W, int x0,
                                              int y0, int image) {
  static_assert(COUT % 16 == 0 && COUT <= 64, "COUT must be 16, 32, 48 or 64");
  static_assert(MT >= 1 && MT <= MAX_MT, "MT must be 1 or 2");
  static_assert(CK_F32 % 8 == 0 && smem_bytes_f32<COUT, MT>() <= BLOCK_SMEM, "float32 ring");
  constexpr int S = stages_f32<COUT, MT>(), SB = stage_bytes_f32<COUT, MT>(), IW = 8 * MT + 2;
  constexpr uint32_t A_PLANE = a_plane_f32<MT>();
  constexpr uint32_t lbo_a = IH * IW * 16, sbo_a = IW * 16;  // next 4 channels, next halo row
  constexpr uint32_t lbo_b = b_k_rows<COUT>() * 16, sbo_b = 128;  // next 4 channels, 8 outputs
  constexpr bool FUSE = fuse_f32<COUT>();
  float hl[MT][FUSE ? COUT : 1];  // hi x [B hi | B lo] where fused
  // The chunk count, hidden from the optimizer: where cin is a compile-time constant (the
  // resident trunk's convs), the chunk loop below was otherwise unrolled in full on 8-wide
  // tiles, 20-24 copies of its 27 products, and the trunk spilled up to 2.7 KB.
  int nchunks = cin / CK_F32;
  asm volatile("" : "+r"(nchunks));
  const int wg = threadIdx.x / 128;
  const size_t img = size_t(image) * H * W;
  const int first = first_chunk_f32<MT>(nchunks, H, W, x0, y0, image);
  auto c0 = [&](int c) { return (c + first) % nchunks * CK_F32; };
#pragma unroll
  for (int s = 0; s < MT; ++s) {
#pragma unroll
    for (int j = 0; j < COUT / 2; ++j) acc.v[s][j] = 0.f;
#pragma unroll
    for (int j = 0; j < (FUSE ? COUT : 0); ++j) hl[s][j] = 0.f;
  }

  __syncthreads();  // the ring's last contents (another tile, an epilogue) are consumed
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nchunks) {
      if constexpr (PREFETCHED)
        load_input_f32<MT, LEAN>(smem + c * SB, src, ctot, c0(c), H, W, x0, y0, img);
      else
        load_chunk_f32<COUT, MT, false, LEAN>(smem + c * SB, src, ctot, c0(c), w, cin, H, W, x0,
                                              y0, img);
    }
    cp_async_commit();
  }
  cp_async_wait<S - 2>();  // this thread's copies of chunk 0 (and any prefetch) have landed
  split_chunk_f32<MT>(smem);
  fence_proxy_async();  // its stores and copies, before wgmma reads them
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every thread has split chunk c; each warpgroup waited out chunk c-1
    const uint32_t s_a = smem_addr(smem + c % S * SB), s_b = s_a + 2 * A_PLANE;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int k = 0; k < CK_F32 / 8; ++k) {
        const uint32_t ob = (tap * CK_F32 / 4 + 2 * k) * lbo_b;
        const uint64_t bh = desc(s_b + ob, lbo_b, sbo_b);  // (with FUSE: B hi | B lo)
        const uint64_t bl = desc(s_b + ob + b_lo_rows<COUT>() * 16, lbo_b, sbo_b);
#pragma unroll
        for (int s = 0; s < MT; ++s) {
          const uint32_t oa = ((8 * wg + dy) * IW + 8 * s + dx) * 16 + 2 * k * lbo_a;
          const uint64_t ah = desc(s_a + oa, lbo_a, sbo_a);
          const uint64_t al = desc(s_a + A_PLANE + oa, lbo_a, sbo_a);
          WgmmaTF32<COUT>::mma(acc.v[s], al, bh);
          if constexpr (FUSE) {
            WgmmaTF32<2 * COUT>::mma(hl[s], ah, bh);
          } else {
            WgmmaTF32<COUT>::mma(acc.v[s], ah, bl);
            WgmmaTF32<COUT>::mma(acc.v[s], ah, bh);
          }
        }
      }
    }
    wgmma_commit();
    // while the products of chunk c run: refill chunk c-1's stage, then split chunk c+1
    const int next = c + S - 1;
    if (next < nchunks)
      load_chunk_f32<COUT, MT, false, LEAN>(smem + next % S * SB, src, ctot, c0(next), w, cin, H,
                                            W, x0, y0, img);
    cp_async_commit();
    if (c + 1 < nchunks) {
      cp_async_wait<S - 2>();  // this thread's copies of chunk c+1 have landed
      split_chunk_f32<MT>(smem + (c + 1) % S * SB);
      fence_proxy_async();
    }
    wgmma_wait0();
#pragma unroll
    for (int s = 0; s < MT; ++s) {
#pragma unroll
      for (int j = 0; j < COUT / 2; ++j) asm volatile("" : "+f"(acc.v[s][j])::"memory");
#pragma unroll
      for (int j = 0; j < (FUSE ? COUT : 0); ++j) asm volatile("" : "+f"(hl[s][j])::"memory");
    }
  }
  if constexpr (FUSE) {  // hl[s][j] and hl[s][j + COUT / 2]: hi x hi and hi x lo of acc[s][j]
#pragma unroll
    for (int s = 0; s < MT; ++s)
#pragma unroll
      for (int j = 0; j < COUT / 2; ++j)
        acc.v[s][j] = acc.v[s][j] + hl[s][j + COUT / 2] + hl[s][j];
  }
}

// The wide float32 tile conv's sums (conv_tile_f32w): warpgroup g's 64 x 64 MT fragment
// of wgmma, rows the output channels (at COUT 32, rows o and o + 32 hold W hi and W lo
// times the input; the epilogue adds them) and columns its 64 MT pixels: at MT 2 tile
// column 8g + n % 8 of row n / 8, at MT 1 column n % 8 of row 8g + n / 8 (stage_accw).
template <int COUT, int MT>
struct AccW {
  float v[32 * MT];
};

// conv_tile_f32 turned around, for COUT 32 and 64 (wide_f32): the implicit GEMM is COUT x
// pixels.  A is the weights, K-major as load_weights_f32<COUT, MT, true> stages them (a
// core matrix is 8 outputs x 4 channels: SBO 128 bytes, LBO the next channel group); B
// is the input, K-major as staged (a core matrix is 8 pixels of a halo row x 4 channels),
// N running down the warpgroup's 8-pixel column of the tile, one core matrix a row (SBO
// the halo row pitch, LBO the next channel plane): N = 128 at MT 2, 64 at MT 1 (the
// warpgroup's 8 rows).  Each k8 step takes, at COUT 64, W lo x X hi, W hi x X lo and W hi
// x X hi; at COUT 32, [W hi; W lo] x X lo and [W hi; W lo] x X hi (the four products of
// a split operand pair in two: the epilogue adds rows o and o + 32).  The ring, the
// split, the tiles and the chunk order are conv_tile_f32's; chunks, taps, k steps and
// products run in one fixed order, so every kernel that calls this gives bit-identical
// sums for the same inputs.  LEAN: the input's copy loop rolled up too (see
// for_each_thread).
template <int COUT, int MT, bool LEAN = false>
__device__ __forceinline__ void conv_tile_f32w(AccW<COUT, MT>& acc, unsigned char* smem,
                                               const float* __restrict__ src, int ctot, int cin,
                                               const float* __restrict__ w, int H, int W,
                                               int x0, int y0, int image) {
  static_assert((COUT == 32 || COUT == 64) && wide_f32(COUT), "COUT must be 32 or 64");
  static_assert(MT >= 1 && MT <= MAX_MT, "MT must be 1 or 2");
  static_assert(CK_F32 % 8 == 0 && smem_bytes_f32<COUT, MT>() <= BLOCK_SMEM, "float32 ring");
  constexpr int S = stages_f32<COUT, MT>(), SB = stage_bytes_f32<COUT, MT>(), IW = 8 * MT + 2;
  constexpr int N = 64 * MT;
  constexpr uint32_t X_PLANE = a_plane_f32<MT>();
  constexpr uint32_t lbo_x = IH * IW * 16, sbo_x = IW * 16;  // next 4 channels, next halo row
  constexpr uint32_t lbo_w = b_k_rows<COUT, true>() * 16, sbo_w = 128;  // 4 channels, 8 outputs
  // The chunk count, hidden from the optimizer (see conv_tile_f32)
  int nchunks = cin / CK_F32;
  asm volatile("" : "+r"(nchunks));
  const int wg = threadIdx.x / 128;
  const int px0 = MT == 1 ? 8 * wg * IW : 8 * wg;  // the warpgroup's first halo pixel
  src += size_t(image) * H * W * ctot;  // the tile's image (one pointer live, not two)
  const int first = first_chunk_f32<MT>(nchunks, H, W, x0, y0, image);
  auto c0 = [&](int c) { return (c + first) % nchunks * CK_F32; };
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc.v[j] = 0.f;

  __syncthreads();  // the ring's last contents (another tile, an epilogue) are consumed
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nchunks)
      load_chunk_f32<COUT, MT, true, LEAN>(smem + c * SB, src, ctot, c0(c), w, cin, H, W, x0, y0,
                                           0);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();  // this thread's copies of chunk 0 have landed
  split_chunk_f32<MT>(smem);
  fence_proxy_async();  // its stores and copies, before wgmma reads them
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every thread has split chunk c; each warpgroup waited out chunk c-1
    const uint32_t s_x = smem_addr(smem + c % S * SB), s_w = s_x + 2 * X_PLANE;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int k = 0; k < CK_F32 / 8; ++k) {
        const uint32_t ow = (tap * CK_F32 / 4 + 2 * k) * lbo_w;
        const uint32_t ox = (px0 + dy * IW + dx) * 16 + 2 * k * lbo_x;
        const uint64_t wh = desc(s_w + ow, lbo_w, sbo_w);  // (at COUT 32: [W hi; W lo])
        const uint64_t xh = desc(s_x + ox, lbo_x, sbo_x);
        const uint64_t xl = desc(s_x + X_PLANE + ox, lbo_x, sbo_x);
        if constexpr (COUT == 64) {
          const uint64_t wl = desc(s_w + ow + b_lo_rows<COUT, true>() * 16, lbo_w, sbo_w);
          WgmmaTF32<N>::mma(acc.v, wl, xh);
        }
        WgmmaTF32<N>::mma(acc.v, wh, xl);
        WgmmaTF32<N>::mma(acc.v, wh, xh);
      }
    }
    wgmma_commit();
    // while the products of chunk c run: refill chunk c-1's stage, then split chunk c+1
    const int next = c + S - 1;
    if (next < nchunks)
      load_chunk_f32<COUT, MT, true, LEAN>(smem + next % S * SB, src, ctot, c0(next), w, cin, H,
                                           W, x0, y0, 0);
    cp_async_commit();
    if (c + 1 < nchunks) {
      cp_async_wait<S - 2>();  // this thread's copies of chunk c+1 have landed
      split_chunk_f32<MT>(smem + (c + 1) % S * SB);
      fence_proxy_async();
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < N / 2; ++j) asm volatile("" : "+f"(acc.v[j])::"memory");
  }
}

// The tile conv of a dense-block kernel whose buffers and weights hold T: bf16 on
// wgmma (conv_tile), float32 in 3xTF32 (conv_tile_f32; feature_tile and residual_tile
// take conv_tile_f32w where wide_f32).  LEAN: see for_each_thread.
template <bool LEAN, int COUT, int MT, class T>
__device__ __forceinline__ void conv_dense(Acc<COUT, MT>& acc, unsigned char* smem,
                                           const T* __restrict__ src, int ctot, int cin,
                                           const T* __restrict__ w, int H, int W, int x0, int y0,
                                           int image) {
  if constexpr (std::is_same<T, float>::value)
    conv_tile_f32<COUT, MT, false, LEAN>(acc, smem, src, ctot, cin, w, H, W, x0, y0, image);
  else
    conv_tile(acc, smem, src, ctot, cin, w, H, W, x0, y0, image);
}

// fn(pix, local, o, v0, v1) for each of this thread's accumulator pairs that lies in
// the image: pix the pixel's index in (B,H,W), local its index in the tile (row-major,
// width 8 MT), o the even output channel of v0 (v1 is channel o + 1).  In wgmma's
// fragment, lane l of warp q holds rows 16q + l/4 and 16q + l/4 + 8 of each M tile,
// channels 8p + 2(l%4) + {0, 1}; row m of sub-tile s is pixel (m/8, 8s + m%8).
template <int COUT, int MT, class Fn>
__device__ __forceinline__ void for_each_pair(const Acc<COUT, MT>& acc, int H, int W, int x0,
                                              int y0, int image, Fn fn) {
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  const int ty0 = 8 * wg + 2 * warp;
#pragma unroll
  for (int s = 0; s < MT; ++s) {
    const int tx = 8 * s + lane / 4;
    if (x0 + tx >= W) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ty = ty0 + h;
      if (y0 + ty >= H) continue;
      const size_t pix = (size_t(image) * H + y0 + ty) * W + x0 + tx;
#pragma unroll
      for (int p = 0; p < COUT / 8; ++p)
        fn(pix, ty * 8 * MT + tx, 8 * p + 2 * (lane % 4), acc.v[s][4 * p + 2 * h],
           acc.v[s][4 * p + 2 * h + 1]);
    }
  }
}

// The sums into shared memory as s_acc[local * COUT + o] (after a barrier that frees
// the ring; pixels outside the image are left unwritten).
template <int COUT, int MT>
__device__ __forceinline__ void stage_acc(const Acc<COUT, MT>& acc, float* s_acc, int H, int W,
                                          int x0, int y0, int image) {
  static_assert(TH * 8 * MT * COUT * 4 <= smem_bytes<COUT>() &&
                    TH * 8 * MT * COUT * 4 <= smem_bytes_f32<COUT, MT>(),
                "staging must fit the ring");
  for_each_pair(acc, H, W, x0, y0, image,
                      [&](size_t, int local, int o, float v0, float v1) {
                        *reinterpret_cast<float2*>(s_acc + local * COUT + o) = make_float2(v0, v1);
                      });
}

// A dense-block feature conv's epilogue: dense[..., out_off + o] = T(lrelu_0.2(conv + bias)).
template <int COUT, int MT, class T>
__device__ __forceinline__ void feature_store(const Acc<COUT, MT>& acc, T* dense, int ctot,
                                              const float* __restrict__ bias, int out_off, int H,
                                              int W, int x0, int y0, int image) {
  for_each_pair(acc, H, W, x0, y0, image,
                      [&](size_t pix, int, int o, float v0, float v1) {
                        v0 += bias[o];
                        v1 += bias[o + 1];
                        store2(dense + pix * ctot + out_off + o, v0 > 0.f ? v0 : 0.2f * v0,
                               v1 > 0.f ? v1 : 0.2f * v1);
                      });
}

// A dense block's conv5 epilogue (rrdb.cu, rrdb_trunk.cu): x = 0.2 * (conv + b) +
// xres; then, if xrrdb, x = 0.2 * x + xrrdb; xout = x and, if next, next[..., o] =
// T(x) (next has ctot channels).  xres, xout and xrrdb are (B,H,W,COUT) float and
// may alias one another: each element is read and then written by the same thread.
template <int COUT, int MT, class T>
__device__ __forceinline__ void residual_store(const Acc<COUT, MT>& acc, int ctot,
                                               const float* __restrict__ bias,
                                               const float* xres, float* xout,
                                               const float* xrrdb, T* next, int H, int W,
                                               int x0, int y0, int image) {
  for_each_pair(acc, H, W, x0, y0, image,
                      [&](size_t pix, int, int o, float v0, float v1) {
                        const size_t e = pix * COUT + o;
                        const float2 r = *reinterpret_cast<const float2*>(xres + e);
                        float a = fmaf(v0 + bias[o], 0.2f, r.x);
                        float b = fmaf(v1 + bias[o + 1], 0.2f, r.y);
                        if (xrrdb != nullptr) {
                          const float2 q = *reinterpret_cast<const float2*>(xrrdb + e);
                          a = fmaf(a, 0.2f, q.x);
                          b = fmaf(b, 0.2f, q.y);
                        }
                        *reinterpret_cast<float2*>(xout + e) = make_float2(a, b);
                        if (next != nullptr) store2(next + pix * ctot + o, a, b);
                      });
}

// The wide fragment (AccW) staged in shared memory as s[local * ACCW_LD + row]: local the
// pixel's index in the tile (row-major, width 8 MT), row the fragment's (0..63).  68
// floats a pixel: each of a warp's stores falls in 32 banks (lane l of warp q holds rows
// 16q + l/4 and 16q + l/4 + 8, columns 8i + 2(l%4) + {0, 1}), and a pixel's rows stay
// 16-byte aligned.
constexpr int ACCW_LD = 68;

template <int COUT, int MT>
__device__ __forceinline__ void stage_accw(const AccW<COUT, MT>& acc, float* s) {
  static_assert(TH * 8 * MT * ACCW_LD * 4 <= smem_bytes_f32<COUT, MT>(),
                "staging must fit the ring");
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  // column block i of the fragment is tile row i (MT 2) or 8g + i (MT 1)
  const int px = (MT == 1 ? 64 * wg : 8 * wg) + 2 * (lane % 4), row = 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < 8 * MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[(px + 8 * MT * i + j) * ACCW_LD + row + 8 * h] = acc.v[4 * i + 2 * h + j];
}

// After a barrier that frees the ring: the wide fragment into shared memory, then fn(pix,
// o, v) for each 4 output channels o .. o+3 of each tile pixel in the image, pix the
// pixel's index in (B,H,W), v their sums (at COUT 32, rows o and o + 32 added).
// Consecutive threads take consecutive channels of a pixel: the NHWC stores coalesce.
template <int COUT, int MT, class Fn>
__device__ __forceinline__ void for_each_quad(const AccW<COUT, MT>& acc, unsigned char* smem,
                                              int H, int W, int x0, int y0, int image, Fn fn) {
  constexpr int Q = COUT / 4, TW = 8 * MT;
  float* s = reinterpret_cast<float*>(smem);
  __syncthreads();  // both warpgroups' products are done with the ring
  stage_accw(acc, s);
  __syncthreads();
#pragma unroll 1  // unrolled, its loads and stores made the resident trunk spill more
  for (int e = threadIdx.x; e < TH * TW * Q; e += NTHREADS) {
    const int local = e / Q, o = 4 * (e % Q), gy = y0 + local / TW, gx = x0 + local % TW;
    if (gy >= H || gx >= W) continue;
    float4 v = *reinterpret_cast<const float4*>(s + local * ACCW_LD + o);
    if constexpr (COUT == 32) {  // W hi x X + W lo x X
      const float4 l = *reinterpret_cast<const float4*>(s + local * ACCW_LD + o + 32);
      v = make_float4(v.x + l.x, v.y + l.y, v.z + l.z, v.w + l.w);
    }
    fn((size_t(image) * H + gy) * W + gx, o, v);
  }
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.2f * v; }

// feature_store for the wide fragment (float32 dense buffers), through shared memory
template <int COUT, int MT>
__device__ __forceinline__ void feature_store(const AccW<COUT, MT>& acc, unsigned char* smem,
                                              float* dense, int ctot,
                                              const float* __restrict__ bias, int out_off, int H,
                                              int W, int x0, int y0, int image) {
  for_each_quad(acc, smem, H, W, x0, y0, image, [&](size_t pix, int o, float4 v) {
    *reinterpret_cast<float4*>(dense + pix * ctot + out_off + o) =
        make_float4(lrelu(v.x + bias[o]), lrelu(v.y + bias[o + 1]), lrelu(v.z + bias[o + 2]),
                    lrelu(v.w + bias[o + 3]));
  });
}

// residual_store for the wide fragment (float32 dense buffers), through shared memory;
// each element of xres, xrrdb and xout is read and then written by the same thread
template <int COUT, int MT>
__device__ __forceinline__ void residual_store(const AccW<COUT, MT>& acc, unsigned char* smem,
                                               int ctot, const float* __restrict__ bias,
                                               const float* xres, float* xout,
                                               const float* xrrdb, float* next, int H, int W,
                                               int x0, int y0, int image) {
  for_each_quad(acc, smem, H, W, x0, y0, image, [&](size_t pix, int o, float4 v) {
    const size_t e = pix * COUT + o;
    const float4 r = *reinterpret_cast<const float4*>(xres + e);
    float4 a = make_float4(fmaf(v.x + bias[o], 0.2f, r.x), fmaf(v.y + bias[o + 1], 0.2f, r.y),
                           fmaf(v.z + bias[o + 2], 0.2f, r.z), fmaf(v.w + bias[o + 3], 0.2f, r.w));
    if (xrrdb != nullptr) {
      const float4 q = *reinterpret_cast<const float4*>(xrrdb + e);
      a = make_float4(fmaf(a.x, 0.2f, q.x), fmaf(a.y, 0.2f, q.y), fmaf(a.z, 0.2f, q.z),
                      fmaf(a.w, 0.2f, q.w));
    }
    *reinterpret_cast<float4*>(xout + e) = a;
    if (next != nullptr) *reinterpret_cast<float4*>(next + pix * ctot + o) = a;
  });
}

// A dense-block feature conv on one tile (rrdb.cu, rrdb_trunk.cu): dense[..., out_off + o]
// = T(lrelu_0.2(conv + bias)), the float32 conv wide where wide_f32(COUT); LEAN for the
// resident trunk (see for_each_thread).
template <int COUT, int MT, bool LEAN = false, class T>
__device__ __forceinline__ void feature_tile(unsigned char* smem, T* dense, int ctot, int cin,
                                             const T* __restrict__ w,
                                             const float* __restrict__ bias, int out_off, int H,
                                             int W, int x0, int y0, int image) {
  if constexpr (std::is_same<T, float>::value && wide_f32(COUT)) {
    AccW<COUT, MT> acc;
    conv_tile_f32w<COUT, MT, LEAN>(acc, smem, dense, ctot, cin, w, H, W, x0, y0, image);
    feature_store(acc, smem, dense, ctot, bias, out_off, H, W, x0, y0, image);
  } else {
    Acc<COUT, MT> acc;
    conv_dense<LEAN>(acc, smem, dense, ctot, cin, w, H, W, x0, y0, image);
    feature_store(acc, dense, ctot, bias, out_off, H, W, x0, y0, image);
  }
}

// A dense block's conv5 on one tile (residual_store's arithmetic), reading all ctot
// channels of dense; the float32 conv wide where wide_f32(COUT), LEAN as feature_tile's.
template <int COUT, int MT, bool LEAN = false, class T>
__device__ __forceinline__ void residual_tile(unsigned char* smem, const T* dense, int ctot,
                                              const T* __restrict__ w,
                                              const float* __restrict__ bias, const float* xres,
                                              float* xout, const float* xrrdb, T* next, int H,
                                              int W, int x0, int y0, int image) {
  if constexpr (std::is_same<T, float>::value && wide_f32(COUT)) {
    AccW<COUT, MT> acc;
    conv_tile_f32w<COUT, MT, LEAN>(acc, smem, dense, ctot, ctot, w, H, W, x0, y0, image);
    residual_store(acc, smem, ctot, bias, xres, xout, xrrdb, next, H, W, x0, y0, image);
  } else {
    Acc<COUT, MT> acc;
    conv_dense<LEAN>(acc, smem, dense, ctot, ctot, w, H, W, x0, y0, image);
    residual_store(acc, ctot, bias, xres, xout, xrrdb, next, H, W, x0, y0, image);
  }
}

// Allow Kernel the dynamic shared memory it launches with (above 48 KB), once per
// card: the attribute then holds for the process.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<unsigned> allowed{0};  // bit d: done on card d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (err != cudaSuccess || (allowed.load() & bit)) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(Kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return err;
}

// Kernel<<<g, NTHREADS, bytes, stream>>>(args...) with `bytes` of dynamic shared memory.
template <auto Kernel, class... Args>
cudaError_t launch(dim3 g, int bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem<Kernel>(bytes);
  if (err != cudaSuccess) return err;
  Kernel<<<g, NTHREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// A dense-block feature conv: dense[..., out_off + o] = T(lrelu_0.2(conv + bias)).
template <int COUT, int MT, class T>
__global__ void __launch_bounds__(NTHREADS, 2)
feature_kernel(T* __restrict__ dense, int ctot, int cin, const T* __restrict__ w,
               const float* __restrict__ bias, int out_off, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int x0 = blockIdx.x * 8 * MT, y0 = blockIdx.y * TH;
  feature_tile<COUT, MT>(smem, dense, ctot, cin, w, bias, out_off, H, W, x0, y0, blockIdx.z);
}

template <int COUT, class T>
cudaError_t launch_feature(T* dense, int ctot, int cin, const T* w, const float* bias,
                           int out_off, int B, int H, int W, cudaStream_t stream) {
  return with_mt(W, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    return launch<feature_kernel<COUT, MT, T>>(grid(B, H, W, MT), smem_for<COUT, T, MT>(), stream,
                                               dense, ctot, cin, w, bias, out_off, H, W);
  });
}

template <class T>
cudaError_t launch_feature(int cout, T* dense, int ctot, int cin, const T* w,
                           const float* bias, int out_off, int B, int H, int W,
                           cudaStream_t stream) {
  switch (cout) {
    case 16: return launch_feature<16>(dense, ctot, cin, w, bias, out_off, B, H, W, stream);
    case 32: return launch_feature<32>(dense, ctot, cin, w, bias, out_off, B, H, W, stream);
    case 64: return launch_feature<64>(dense, ctot, cin, w, bias, out_off, B, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace conv3x3
