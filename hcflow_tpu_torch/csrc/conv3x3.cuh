// Tiled 3x3 "same" convolution for Hopper (sm_90a): warpgroup tensor-core products
// (wgmma.mma_async m64nNk16, bf16 operands, float32 sums in registers) fed by a
// 3-stage cp.async ring, with the bf16 staging conversion and the epilogues, shared by
// rrdb.cu, rrdb_trunk.cu, chain3s.cu and conv.cu.
//
// The conv is an implicit GEMM: M = output pixels, N = COUT (16, 32, 48 or 64), K =
// 9 taps x cin.  The dense-block kernels keep their concats free: a dense block owns
// one NHWC bf16 buffer (B,H,W,ctot) holding [input | x1 | x2 | x3 | x4], and conv i
// reads a channel prefix of it.
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

// ------------------------------------------------------------------ bf16 staging
// dense[p, c] = bf16(x[p, c]) for the n = pixels * C values of x (C channels) into
// dense (ctot channels; its others are not written), four values a thread (16-byte
// loads; C and ctot are multiples of 4), grid-stride over the caller's grid.
__device__ __forceinline__ void to_dense(const float* __restrict__ x, bf16* __restrict__ dense,
                                         int ctot, int C, size_t n) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n / 4;
       i += size_t(gridDim.x) * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    const size_t e = 4 * i;
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dense + (e / C) * ctot + e % C);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

__global__ void to_dense_kernel(const float* __restrict__ x, bf16* __restrict__ dense, int ctot,
                                int C, size_t n) {
  to_dense(x, dense, ctot, C, n);
}

cudaError_t launch_to_dense(const float* x, bf16* dense, int ctot, int C, size_t n,
                            cudaStream_t stream) {
  const size_t blocks = (n / 4 + 255) / 256;
  to_dense_kernel<<<unsigned(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(x, dense, ctot,
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
  static_assert(TH * 8 * MT * COUT * 4 <= smem_bytes<COUT>(), "staging must fit the ring");
  for_each_pair(acc, H, W, x0, y0, image,
                      [&](size_t, int local, int o, float v0, float v1) {
                        *reinterpret_cast<float2*>(s_acc + local * COUT + o) = make_float2(v0, v1);
                      });
}

// A dense-block feature conv's epilogue: dense[..., out_off + o] = bf16(lrelu_0.2(conv + bias)).
template <int COUT, int MT>
__device__ __forceinline__ void feature_store(const Acc<COUT, MT>& acc, bf16* dense, int ctot,
                                              const float* __restrict__ bias, int out_off, int H,
                                              int W, int x0, int y0, int image) {
  for_each_pair(acc, H, W, x0, y0, image,
                      [&](size_t pix, int, int o, float v0, float v1) {
                        v0 += bias[o];
                        v1 += bias[o + 1];
                        *reinterpret_cast<__nv_bfloat162*>(dense + pix * ctot + out_off + o) =
                            __floats2bfloat162_rn(v0 > 0.f ? v0 : 0.2f * v0,
                                                  v1 > 0.f ? v1 : 0.2f * v1);
                      });
}

// A dense block's conv5 epilogue (rrdb.cu, rrdb_trunk.cu): x = 0.2 * (conv + b) +
// xres; then, if xrrdb, x = 0.2 * x + xrrdb; xout = x and, if next, next[..., o] =
// bf16(x) (next has ctot channels).  xres, xout and xrrdb are (B,H,W,COUT) float and
// may alias one another: each element is read and then written by the same thread.
template <int COUT, int MT>
__device__ __forceinline__ void residual_store(const Acc<COUT, MT>& acc, int ctot,
                                               const float* __restrict__ bias,
                                               const float* xres, float* xout,
                                               const float* xrrdb, bf16* next, int H, int W,
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
                        if (next != nullptr)
                          *reinterpret_cast<__nv_bfloat162*>(next + pix * ctot + o) =
                              __floats2bfloat162_rn(a, b);
                      });
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

// A dense-block feature conv: dense[..., out_off + o] = bf16(lrelu_0.2(conv + bias)).
template <int COUT, int MT>
__global__ void __launch_bounds__(NTHREADS, 2)
feature_kernel(bf16* __restrict__ dense, int ctot, int cin, const bf16* __restrict__ w,
               const float* __restrict__ bias, int out_off, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int x0 = blockIdx.x * 8 * MT, y0 = blockIdx.y * TH;
  Acc<COUT, MT> acc;
  conv_tile(acc, smem, dense, ctot, cin, w, H, W, x0, y0, blockIdx.z);
  feature_store(acc, dense, ctot, bias, out_off, H, W, x0, y0, blockIdx.z);
}

template <int COUT>
cudaError_t launch_feature(bf16* dense, int ctot, int cin, const bf16* w, const float* bias,
                           int out_off, int B, int H, int W, cudaStream_t stream) {
  return with_mt(W, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    return launch<feature_kernel<COUT, MT>>(grid(B, H, W, MT), smem_bytes<COUT>(), stream, dense,
                                            ctot, cin, w, bias, out_off, H, W);
  });
}

cudaError_t launch_feature(int cout, bf16* dense, int ctot, int cin, const bf16* w,
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
