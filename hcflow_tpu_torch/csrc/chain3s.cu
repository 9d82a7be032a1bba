// Inverse rescaling main chain (alternating Affine3shift steps with DenseBlock nets)
// for Hopper (sm_90a).  bf16: one launch a flow step, the step's five dense-block convs
// fused in one block with the features x1..x4 in shared memory; float32: one persistent
// launch a chain.
//
// Replaces the TPU kernel hcflow_tpu/ops/pallas_chain3s.py (_make_kernel, called by
// inverse_chain).  z (B,H,W,c) float32 splits into the 3 LR channels z1 and the c-3
// others z2.  Step k, from k = K-1 down to 0:
//   even k: net input z1; the dense block gives p = [shift | scale] (c-3 each)
//           z2 = z2 * exp(-0.318 * atan(2 * scale)) - shift
//   odd k:  net input z2; the dense block gives 3 shifts,  z1 = z1 - shift
//   every k: z = z * exp(-logs) - bias                          (ActNorm inverse)
// The dense block is x_i = lrelu_0.2(conv_i(cat(x, x_1 .. x_{i-1})) + b_i) for
// i = 1..4 and p = conv_5(cat(x, x_1 .. x_4)) + b_5: bf16 operands, float32 sums.
//
// Bound: operations.  At c 12 / gc 32 a step is ~75 kMAC per pixel of bf16 convs,
// so the 8-step chain does ~1.2 MFLOP per pixel against the ~100 bytes per pixel it
// must move (z in and out), far above the card's ~295 FLOP/byte ridge.  The design
// before this one ran each conv as a launch of the shared wgmma tile conv
// (conv3x3.cuh) over a dense buffer in device memory: 1 + 5K launches a chain, ~1.2 KB a
// pixel a step through device memory, a floor of ~0.37 ms a request in bytes alone
// against the 0.164 ms bound in operations (PERF.md).
//
// Design (bf16).  A block of 3 warpgroups owns a th x tw output tile of one image and
// runs the whole step there (the TPU kernel kept a whole image resident for all K
// steps; a block's 227 KB cannot hold one, so each step is a launch and z alone goes
// through device memory between steps).  It stages the net input, rounded to bf16 and
// zero-padded to cinp channels, on the tile plus a 5-pixel halo, then computes x1 on
// the tile plus 4, x2 on the tile plus 3, x3 plus 2, x4 plus 1 and conv5 on the tile:
// each conv reads one more ring than it writes, so the halo is recomputed, never
// exchanged.  A region's pixels outside the image hold 0 (each conv is "same" with zero
// padding), not lrelu(bias); the net input is 0 there too.  x1..x4 live in shared memory
// only.  conv5's sums (plus bias) are staged in shared memory once every product is
// done, and the block applies the coupling and the ActNorm inverse to z in float32
// (expf/atanf, no fast math), a value a thread, and writes the step's z, which the next
// step reads.  Bound: still operations, but the step does 1.3-2x the tile's products
// (the halo and the blocks below) on a card whose tensor rate falls with the data (its
// products on zero features ran 1.5x faster than on real ones, PERF.md).
// - Products: wgmma m64nNk16 (N = gc, or conv5's width), A straight from the feature
//   arrays, B from a weight ring; an M tile is an 8x8-pixel block of a region (the last
//   block of a row or column moved back to end at the region's edge, so no read leaves
//   an array).  Regions are tw + 10 .. tw wide, so the blocks cover more than the region:
//   at 20x20 tiles 32, 32, 24, 24, 24 pixels a side for 28, 26, 24, 22, 20, 1.3x the
//   products of the exact regions.  (mma.sync on 16-pixel rows, tried first, wasted less
//   but was slower: its ldmatrix and address work per product, PERF.md.)
// - Features: one planar array a region, [8-channel unit][pixel] in 16-byte units: a
//   core matrix of wgmma's A is 8 pixels of a row in one unit (128 contiguous bytes; no
//   swizzle, no bank conflict), LBO the next unit's plane, SBO the next row.
// - Weights: a ring of 2 or 3 stages (cp.async), a stage one chunk of one conv (16 input
//   channels, all 9 taps, all outputs) in the tile conv's MN-major B layout; the chunks
//   of the step's five convs run as one sequence through the ring, a cursor every
//   thread advances, so that the next conv's first weights are in flight under the last
//   products of the one before.
// - Accumulators: a warpgroup keeps up to MAX_MG M tiles of a conv (at most ACC_FLOATS
//   floats a thread); a region with more M tiles than NWG MAX_MG runs in passes, each
//   over all the conv's chunks (conv5 in one, which the plan guarantees).  conv5's
//   outputs are ordered (the pack's blob) in blocks of 8, [shift 0..7 | scale 0..7 |
//   shift 8..15 | ...], as in the float32 recipe, where its sums go through shared memory
//   the same way.
// - No array is indexed at run time and no state lives behind a reference: every wgmma's
//   "memory" clobber made the compiler reload such values (2,000 local and generic loads
//   in a step kernel's code; with descriptors computed once a chunk, 10-13% of its time,
//   PERF.md).
// - Tiles: ops/chain3s.py's plan() picks th x tw and the ring's depth per step parity
//   (even and odd steps differ in cinp and conv5's width): of the plans whose shared
//   memory fits a block, the one that does the least work on the busiest SM (waves of
//   one block an SM x the products of a block's busiest warpgroup).  The kernel
//   recomputes the shared memory of the plan it is given and refuses one it cannot run.
//   At batch 16: 40x40 c 24 10x20 tiles (128 blocks), 80x80 c 12 20x20 (256 blocks, 2
//   waves), 155-218 KB, one block an SM.
// - Launches: one a step, K a chain; every step after the first with programmatic
//   stream serialization: its blocks copy their first weight chunks while the step
//   before ends, and wait (griddepcontrol.wait) for it before they read z.
//
// The float32 recipe (hcflow_chain3s_inverse_f32; the JAX kernel follows compute_dtype,
// at Precision.HIGHEST in float32) keeps the features in two float32 dense buffers in
// device memory and runs each conv as conv3x3.cuh's conv_tile_f32 (3xTF32 on wgmma from
// operands split once), but in one cooperative launch a chain, whose blocks take the
// chain's (conv, tile) items in order and wait only for the neighbouring tiles of the
// conv before (below): 1 launch a chain, against 1 + 5K for a launch a conv.  Fusing a
// step in float32 as bf16 does is not done: a float32 feature split to TF32 hi and lo
// takes 4x bf16's shared memory, which would shrink the tiles and multiply the recompute.
//
// Layouts: the weight blob holds, step k after step k-1, conv 1..5's weights: bf16 (9,
// cin_i, n_i) [tap][ci][co]; float32 the TF32 planes (2, 9, cin_i / 4, n_i, 4); cin_i =
// cinp + (i-1) gc with zero rows for the net input's padding, n_i = gc for i < 5 and n5
// for conv5 (even steps 2 rup8(c-3) in the blocks above; odd steps 16, the 3 shifts
// zero-padded).  The bias blob holds, step after step, 4 x gc then n5 floats (conv5's
// in its order).  an_s, an_b (K, c) float with an_s = exp(-logs).

#include <cooperative_groups.h>

#include "conv3x3.cuh"

namespace cg = cooperative_groups;

namespace {

using conv3x3::bf16;
using conv3x3::smem_addr;

constexpr int NTHREADS = 384;   // 3 warpgroups
constexpr int NWG = NTHREADS / 128;
constexpr int HALO = 5;         // the net input's halo: one ring a conv
constexpr int ACC_FLOATS = 64;  // accumulator floats a thread keeps in a pass
constexpr int MAX_MG = 3;       // M tiles a warpgroup keeps in a pass, at most
constexpr int MAX_TILE = 64;    // th, tw at most; at least 8 (the 8x8 M tiles)

__host__ __device__ constexpr int rup(int x, int m) { return (x + m - 1) / m * m; }

// M tiles (64 pixels) a warpgroup keeps for a conv of N outputs, 1 to MAX_MG: a pass of
// the conv covers NWG times as many
__host__ __device__ constexpr int mg(int n) {
  return ACC_FLOATS / (n / 2) > MAX_MG ? MAX_MG
                                       : (ACC_FLOATS / (n / 2) > 0 ? ACC_FLOATS / (n / 2) : 1);
}

// A step block's shared memory: the weight ring (stages x 9 x 16 x max(gc, n5) bf16),
// then the feature arrays f = 0 (the net input, halo 5) .. 4 (x4, halo 1), planar:
// 16-byte unit u (8 channels) of pixel p at off(f) + (u * npx(f) + p) * 16, each array
// 128-byte aligned.  Computed, never indexed: a run-time index would put these in local
// memory, which every wgmma's "memory" clobber makes the compiler reload.
// ops/chain3s.py's smem_bytes() computes the same bytes.
struct Geometry {
  int th, tw, cinp, gc, ring;  // ring: the weight ring's bytes, 128-aligned

  __host__ __device__ int npx(int f) const {
    return (th + 2 * (HALO - f)) * (tw + 2 * (HALO - f));
  }
  __host__ __device__ int width(int f) const { return tw + 2 * (HALO - f); }
  __host__ __device__ int off(int f) const {
    int o = ring;
    for (int j = 0; j < f; ++j) o += rup(npx(j) * (j == 0 ? cinp : gc) * 2, 128);
    return o;
  }
};

__host__ __device__ inline int stage_bytes(int gc, int n5) {
  return 9 * 16 * (gc > n5 ? gc : n5) * 2;
}

__host__ __device__ inline Geometry geometry(int th, int tw, int cinp, int gc, int n5, int stages) {
  return {th, tw, cinp, gc, rup(stages * stage_bytes(gc, n5), 128)};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The blob's elements of conv i (0-based) of a step, and of the convs before it (the
// float32 blob holds two TF32 planes a weight)
__host__ __device__ inline size_t conv_elems(int i, int cinp, int gc, int n5, bool f32) {
  return size_t(f32 ? 2 : 1) * 9 * (cinp + i * gc) * (i < 4 ? gc : n5);
}
__host__ __device__ inline size_t conv_offset(int i, int cinp, int gc, int n5, bool f32) {
  size_t o = 0;
  for (int j = 0; j < i; ++j) o += conv_elems(j, cinp, gc, n5, f32);
  return o;
}

struct StepArgs {
  const float* zin;   // the step's input z, not written
  float* zout;        // its output z
  const bf16* w;      // the step's five convs in the weight blob
  const float* bias;  // its biases: 4 x gc, then n5
  const float* an_s;  // its ActNorm (c each)
  const float* an_b;
  int H, W, c, even, cinp, th, tw, stages;
};

// The M tiles of conv i's region (0-based; halo 4 - i): 8x8-pixel blocks, the last of a
// row or column moved back to end at the region's edge
__device__ __forceinline__ int m_tiles(const Geometry& g, int i) {
  return ((g.width(i + 1) + 7) / 8) * ((g.th + 2 * (HALO - 1 - i) + 7) / 8);
}

// One chunk (input channels 16k .. 16k + 15, all 9 taps, all N outputs) of a conv's
// weights w (9, cin, N) [tap][ci][co] into the ring stage at shared address st, as
// wgmma's MN-major B: [tap][k group][n group][8 k][8 n] (conv3x3.cuh's tile conv's)
template <int N>
__device__ __forceinline__ void load_chunk(uint32_t st, const bf16* w, int cin, int k) {
  constexpr int NG = N / 8;
  for (int e = threadIdx.x; e < 9 * 16 * NG; e += NTHREADS) {
    const int tap = e / (16 * NG), kk = e / NG % 16, n = e % NG;
    conv3x3::cp_async16(st + (((tap * 2 + kk / 8) * NG + n) * 8 + kk % 8) * 16,
                        w + (size_t(tap) * cin + k * 16 + kk) * N + n * 8, true);
  }
}

// The ring of weight chunks.  The step's convs run one after the other, conv i (0-based)
// in passes of (cinp + i gc) / 16 chunks each, one sequence; copy() copies the next chunk
// of it (a cursor every thread advances in step) into its stage and commits a group (an
// empty one past the last chunk); wait(s) waits for chunk s, lets every thread pass the
// stage of chunk s - 1 (which the next copy() refills) and returns chunk s's stage, a
// byte offset.
template <int GC, int N5>
struct Ring {
  Geometry g;
  uint32_t s0;
  int stages, stage_bytes;
  const bf16* w;                         // conv i's weights
  int i = 0, pass = 0, k = 0, next = 0;  // the cursor: conv, pass, chunk; its sequence index

  __device__ __forceinline__ int passes(int conv) const {
    const int per = NWG * (conv < 4 ? mg(GC) : mg(N5));
    return (m_tiles(g, conv) + per - 1) / per;
  }
  __device__ __forceinline__ void copy() {
    if (i < 5) {
      const uint32_t st = s0 + next % stages * stage_bytes;
      const int cin = g.cinp + i * GC;
      if (i < 4)
        load_chunk<GC>(st, w, cin, k);
      else
        load_chunk<N5>(st, w, cin, k);
      ++next;
      if (++k == cin / 16) {
        k = 0;
        if (++pass == passes(i)) {
          pass = 0;
          w += conv_elems(i, g.cinp, GC, N5, false);
          ++i;
        }
      }
    }
    conv3x3::cp_async_commit();
  }
  __device__ __forceinline__ int wait(int s) const {
    if (stages == 3)
      conv3x3::cp_async_wait<1>();
    else
      conv3x3::cp_async_wait<0>();
    conv3x3::fence_proxy_async();  // this thread's copies and stores, before wgmma reads
    __syncthreads();
    return s % stages * stage_bytes;
  }
};

// A pass of conv i (0-based): this warpgroup's CNT M tiles (8x8-pixel blocks) mt0, mt0 +
// NWG, ... of the region (halo h = 4 - i, rw x rh), N outputs, over all the conv's chunks
// (16 input channels each); then epi(row, col, v) for each of this thread's pixels of the
// region with v[p][e] its sums of channels 8p + 2q + e.  A comes straight from the
// feature arrays (K-major, no swizzle: a core matrix is 8 pixels of a row in one 16-byte
// unit, LBO the next unit's plane, SBO the next row); B from the ring.  A tap moves a
// descriptor's start address by (dy wf + dx) 16 bytes, added to its 14-bit field (every
// address is below 256 KB, so it does not carry).
template <int N, int CNT, bool SYNC, class R, class Epi>
__device__ __forceinline__ void conv_pass(const Geometry& g, uint32_t s0, int i, int mt0, int& s,
                                          R& ring, Epi& epi) {
  const int h = HALO - 1 - i, rw = g.width(i + 1), rh = g.th + 2 * h;
  const int c0 = g.cinp / 16, cg = g.gc / 16, nch = c0 + i * cg, nbx = (rw + 7) / 8;
  float acc[CNT > 0 ? CNT : 1][N / 2];
  int by[CNT > 0 ? CNT : 1], bx[CNT > 0 ? CNT : 1];
#pragma unroll
  for (int m = 0; m < CNT; ++m) {
    const int mt = mt0 + NWG * m;
    by[m] = min(8 * (mt / nbx), rh - 8);
    bx[m] = min(8 * (mt % nbx), rw - 8);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[m][j] = 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < nch; ++k, ++s) {
    const int st = ring.wait(s);
    if constexpr (CNT > 0) {
      // the chunk's array f, its first unit u and the offset o of the array's pixel
      // from the region's, at tap (0, 0)
      const int f = k < c0 ? 0 : 1 + (k - c0) / cg, u = 2 * (k < c0 ? k : (k - c0) % cg);
      const int o = HALO - f - h - 1, wf = g.width(f), npx = g.npx(f);
      const uint32_t base = s0 + g.off(f) + (u * npx + o * wf + o) * 16;
      uint64_t da[CNT];
#pragma unroll
      for (int m = 0; m < CNT; ++m)
        da[m] = conv3x3::desc(base + (by[m] * wf + bx[m]) * 16, npx * 16, wf * 16);
      const uint64_t db = conv3x3::desc(s0 + st, N * 16, 128);
      conv3x3::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint64_t dt = (tap / 3) * wf + tap % 3;
#pragma unroll
        for (int m = 0; m < CNT; ++m)
          conv3x3::Wgmma<N>::mma(acc[m], da[m] + dt, db + tap * 2 * N);
      }
      conv3x3::wgmma_commit();
    }
    ring.copy();  // under the products
    if constexpr (CNT > 0) {
      conv3x3::wgmma_wait0();
#pragma unroll
      for (int m = 0; m < CNT; ++m)
#pragma unroll
        for (int j = 0; j < N / 2; ++j) asm volatile("" : "+f"(acc[m][j])::"memory");
    }
  }
  if constexpr (SYNC) __syncthreads();  // every warpgroup's products are done
  // wgmma's fragment: warp w of the warpgroup, lane l holds rows 16w + l/4 (+ 8) of the
  // M tile, i.e. pixel (2w (+ 1), l/4) of the block, channels 8p + 2(l%4) + {0, 1}
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < CNT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v[N / 8][2];
#pragma unroll
      for (int p = 0; p < N / 8; ++p) {
        v[p][0] = acc[m][4 * p + 2 * hh];
        v[p][1] = acc[m][4 * p + 2 * hh + 1];
      }
      epi(by[m] + 2 * warp + hh, bx[m] + lane / 4, v);
    }
}

// Conv i (0-based) of the step, N outputs on the region of halo 4 - i, pass by pass:
// each pass gives each warpgroup up to MG of the region's M tiles, the count a template
// argument, so that no product sits under a run-time branch (ptxas fences those).  SYNC:
// every thread waits for every warpgroup's products before its epilogue.
template <int N, int MG, bool SYNC = false, class R, class Epi>
__device__ __forceinline__ void dense_conv(const Geometry& g, uint32_t s0, int i, int& s, R& ring,
                                           Epi epi) {
  const int wg = threadIdx.x / 128, nmt = m_tiles(g, i);
#pragma unroll 1
  for (int p0 = 0; p0 < nmt; p0 += NWG * MG) {
    const int left = nmt - p0 - wg, cnt = left <= 0 ? 0 : min(MG, (left + NWG - 1) / NWG);
    auto run = [&](auto c) {
      conv_pass<N, decltype(c)::value, SYNC>(g, s0, i, p0 + wg, s, ring, epi);
    };
    switch (cnt) {
      case 0: run(std::integral_constant<int, 0>()); break;
      case 1: run(std::integral_constant<int, 1>()); break;
      case 2: if constexpr (MG >= 2) run(std::integral_constant<int, 2>()); break;
      default: if constexpr (MG >= 3) run(std::integral_constant<int, 3>()); break;
    }
  }
}

// One flow step on the th x tw tile (blockIdx.x, blockIdx.y) of image blockIdx.z.
// GC: the growth; N5: conv5's width (16 on odd steps).
template <int GC, int N5>
__global__ void __launch_bounds__(NTHREADS, 1) chain3s_step_kernel(const StepArgs a) {
  constexpr int MG_G = mg(GC), MG_5 = mg(N5);
  extern __shared__ __align__(128) unsigned char smem[];
  // the arguments as values (the wgmmas' "memory" clobber would reload a struct's)
  const float* __restrict__ zin = a.zin;
  float* __restrict__ zout = a.zout;
  const float* __restrict__ bias_g = a.bias;
  const float* __restrict__ an_s = a.an_s;
  const float* __restrict__ an_b = a.an_b;
  const int H = a.H, W = a.W, c = a.c, even = a.even, stages = a.stages;
  const Geometry g = geometry(a.th, a.tw, a.cinp, GC, N5, stages);
  const uint32_t s0 = smem_addr(smem);
  const int tid = threadIdx.x, q = tid % 4;
  const int x0 = blockIdx.x * g.tw, y0 = blockIdx.y * g.th;
  const size_t img = size_t(blockIdx.z) * H * W;

  Ring<GC, N5> ring{g, s0, stages, stage_bytes(GC, N5), a.w};
  // the first weight chunks before waiting for the step before (weights are constant)
  for (int j = 0; j < stages - 1; ++j) ring.copy();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // the net input (z1 on even steps, z2 on odd ones) on the tile plus the halo, in bf16,
  // zero outside the image and from its channel n on
  {
    const int w0 = g.width(0), npx = g.npx(0), U = g.cinp / 8, off0 = g.off(0);
    const int off = even ? 0 : 3, n = even ? 3 : c - 3;
    for (int e = tid; e < npx * U; e += NTHREADS) {
      const int p = e % npx, u = e / npx, gy = y0 - HALO + p / w0, gx = x0 - HALO + p % w0;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = zin + (in ? (img + size_t(gy) * W + gx) * c + off : 0);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = in && u * 8 + j < n ? src[u * 8 + j] : 0.f;
      *reinterpret_cast<uint4*>(smem + off0 + (u * npx + p) * 16) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }

  int s = 0;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    // x_{i+1} = bf16(lrelu_0.2(conv + b)) into array i + 1 (its region is the conv's), 0
    // at pixels outside the image
    const int h = HALO - 1 - i, rw = g.width(i + 1), npx = g.npx(i + 1);
    unsigned char* base = smem + g.off(i + 1);
    float bias[GC / 8][2];  // this thread's channels 8p + 2q + e
#pragma unroll
    for (int p = 0; p < GC / 8; ++p)
#pragma unroll
      for (int e = 0; e < 2; ++e) bias[p][e] = bias_g[i * GC + 8 * p + 2 * q + e];
    auto feature = [=](int ry, int rx, const auto& v) {
      const int gy = y0 - h + ry, gx = x0 - h + rx, r = ry * rw + rx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int p = 0; p < GC / 8; ++p) {
        float v0 = v[p][0] + bias[p][0], v1 = v[p][1] + bias[p][1];
        v0 = in ? (v0 > 0.f ? v0 : 0.2f * v0) : 0.f;
        v1 = in ? (v1 > 0.f ? v1 : 0.2f * v1) : 0.f;
        *reinterpret_cast<uint32_t*>(base + (p * npx + r) * 16 + 4 * q) = pack_bf16(v0, v1);
      }
    };
    dense_conv<GC, MG_G>(g, s0, i, s, ring, feature);
  }

  // conv5 on the tile, in one pass (plan_ok), its sums plus bias staged as s_p[pixel of
  // the tile][N5] over the ring and the first arrays once every product is done; then the
  // coupling and the ActNorm inverse, one z value a thread at a time (coalesced reads):
  // shift j in column 16 (j / 8) + j % 8 and scale j 8 columns on, on even steps; the 3
  // shifts in columns 0..2 on odd ones.
  float bias[N5 / 8][2];  // this thread's columns 8p + 2q + e
#pragma unroll
  for (int p = 0; p < N5 / 8; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[p][e] = bias_g[4 * GC + 8 * p + 2 * q + e];
  float* s_p = reinterpret_cast<float*>(smem);
  auto stage = [=](int ry, int rx, const auto& v) {
#pragma unroll
    for (int p = 0; p < N5 / 8; ++p)
      *reinterpret_cast<float2*>(s_p + (ry * g.tw + rx) * N5 + 8 * p + 2 * q) =
          make_float2(v[p][0] + bias[p][0], v[p][1] + bias[p][1]);
  };
  dense_conv<N5, MG_5, true>(g, s0, 4, s, ring, stage);
  __syncthreads();
  for (int e = tid; e < g.th * g.tw * c; e += NTHREADS) {
    const int local = e / c, ch = e % c, gy = y0 + local / g.tw, gx = x0 + local % g.tw;
    if (gy >= H || gx >= W) continue;
    const float* p = s_p + local * N5;
    const size_t zi = (img + size_t(gy) * W + gx) * c + ch;
    float v = zin[zi];
    if (ch < 3) {
      if (!even) v -= p[ch];
    } else if (even) {
      const int sh = 16 * ((ch - 3) / 8) + (ch - 3) % 8;
      v = v * expf(-0.318f * atanf(2.f * p[sh + 8])) - p[sh];
    }
    zout[zi] = v * an_s[ch] - an_b[ch];
  }
}

// ------------------------------------------------------------- the float32 recipe
// One cooperative launch a chain: a persistent grid (as many blocks as are co-resident,
// 2 an SM) works through the chain's stages, 5 a step (conv1..conv4, then conv5 with the
// coupling and the ActNorm inverse), each stage a pass of conv3x3.cuh's float32 tile conv
// (conv_tile_f32, 3xTF32 on wgmma) over every 16 x 8 MT tile, on two float32 dense
// buffers in device memory: the even and the odd steps' [net input, zero-padded to cinp
// | x1 | x2 | x3 | x4].  Work item e = s tiles + t is stage s on tile t; block b takes
// e = b, b + G, b + 2G, ... (G blocks), in order.  An item waits only for stage s - 1 on
// its tile and the 8 tiles around it (the halo its conv reads; per-tile counts of the
// stages done, release/acquire at the device's scope), not for the whole grid, so a
// block that has finished its tiles of one stage goes on to the next stage's.  Every
// dependence points to a smaller e and all blocks are resident, so the chain cannot
// deadlock.  Writes that a later item's reads could overtake are ordered by the same
// counts: a stage writes only its own tile, and before stage s runs on a tile every
// neighbour has finished stage s - 1, hence every stage of the steps before, which read
// what stage s overwrites.  The tile conv's cp.async.cg copies read the dense buffers
// through L2 only, and z is read with __ldcg, so no stale L1 line is read.  The net
// input's padding channels are written as zeros with it, so the buffers need no
// clearing.  The same tiles and the same arithmetic as the launch-a-conv design before
// it (the per-tile chunk rotation included), so the output is bit-identical to it.

// Block until stage s - 1 is done on tile t and its neighbours in the same image (tiles
// tx x ty an image): threads 0..8 each poll one tile's count of stages done
__device__ __forceinline__ void wait_tiles(const int* done, int s, int t, int tx, int ty) {
  if (s > 0 && threadIdx.x < 9) {
    const int l = t % (tx * ty), x = l % tx + int(threadIdx.x) % 3 - 1,
              y = l / tx + int(threadIdx.x) / 3 - 1;
    if (x >= 0 && x < tx && y >= 0 && y < ty) {
      const int* f = done + (t - l) + y * tx + x;
      int v;
      while (true) {
        asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory");
        if (v >= s) break;
        __nanosleep(32);
      }
    }
  }
  __syncthreads();
}

// Stage s is done on tile t: after every thread's stores (the barrier orders them
// before thread 0's release), publish s + 1 as its count
__device__ __forceinline__ void mark_done(int* done, int s, int t) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(done + t), "r"(s + 1) : "memory");
}

// conv5 of a step on one tile and its invertible tail, float32, z updated in place; if
// next, the next step's net input (z2 after an even step, z1 after an odd one) goes to
// next[..., j] for j < next_n and zeros up to next_cinp.  Shift j and scale j are in
// different threads of wgmma's fragment: the sums go through shared memory once
// (stage_acc).
template <int COUT, int MT>
__device__ __forceinline__ void coupling_tile_f32(unsigned char* smem, const float* dense, int ctot,
                                                  const float* w, const float* bias, float* z,
                                                  int c, bool even, const float* an_s,
                                                  const float* an_b, float* next, int next_ctot,
                                                  int next_cinp, int H, int W, int x0, int y0,
                                                  int image) {
  constexpr int TW = 8 * MT, TH = conv3x3::TH, NT = conv3x3::NTHREADS;
  conv3x3::Acc<COUT, MT> acc;
  conv3x3::conv_tile_f32<COUT, MT, true>(acc, smem, dense, ctot, ctot, w, H, W, x0, y0,
                                                image);
  float* s_acc = reinterpret_cast<float*>(smem);
  __syncthreads();  // both warpgroups' products are done with the ring
  conv3x3::stage_acc(acc, s_acc, H, W, x0, y0, image);
  __syncthreads();
  const int c2 = c - 3, next_n = even ? c2 : 3;
  for (int e = threadIdx.x; e < TH * TW * c; e += NT) {
    const int local = e / c, ch = e % c, gy = y0 + local / TW, gx = x0 + local % TW;
    if (gy >= H || gx >= W) continue;
    const float* p = s_acc + local * COUT;
    const size_t pix = (size_t(image) * H + gy) * W + gx;
    float v = __ldcg(z + pix * c + ch);
    if (ch < 3) {
      if (!even) v -= p[ch] + bias[ch];
    } else if (even) {
      const int j = ch - 3, sh = 16 * (j / 8) + j % 8;  // shift j; scale j at sh + 8
      const float ls = 0.318f * atanf(2.f * (p[sh + 8] + bias[sh + 8]));
      v = v * expf(-ls) - (p[sh] + bias[sh]);
    }
    v = v * an_s[ch] - an_b[ch];
    z[pix * c + ch] = v;
    if (next != nullptr && (even ? ch >= 3 : ch < 3))
      next[pix * next_ctot + (even ? ch - 3 : ch)] = v;
  }
  if (next == nullptr) return;
  const int pad = next_cinp - next_n;
  for (int e = threadIdx.x; e < TH * TW * pad; e += NT) {
    const int local = e / pad, gy = y0 + local / TW, gx = x0 + local % TW;
    if (gy < H && gx < W)
      next[((size_t(image) * H + gy) * W + gx) * next_ctot + next_n + e % pad] = 0.f;
  }
}

// The float32 launch's arguments, and what the host derives from them once: the kernel
// reads each from the parameter bank where it uses it, so that none holds a register
// across the tile conv (which needs up to 128 of them at 2 blocks an SM)
struct F32Args {
  const float* z;     // the chain's input, not written
  float* out;         // z, updated in place stage by stage
  float* dense_e;     // the even steps' dense buffer
  float* dense_o;     // the odd steps'
  int* done;          // stages done, a tile
  const float* w;     // the weight blob (TF32 planes)
  const float* b;     // the bias blob
  const float* an_s;  // (K, c)
  const float* an_b;
  int B, H, W, c, K;
  // derived: tiles across and down an image, tiles in all, items (5K stages x tiles);
  // the odd steps' net input width, the even steps' conv5 width; a step's weight and
  // bias elements, even and odd
  int tx, ty, tiles, items, cin_o, n5_e;
  size_t wstep_e, wstep_o, bstep_e, bstep_o;
};

// GC: the growth; MT: the tiles' 8x8 sub-tiles a warpgroup (conv3x3::with_mt); conv5's
// width (16 to 64) is chosen at run time
template <int GC, int MT>
__global__ void __launch_bounds__(conv3x3::NTHREADS, 2) chain3s_f32_kernel(const F32Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TW = 8 * MT, TH = conv3x3::TH, NT = conv3x3::NTHREADS, CIN_E = 16;

  // out = z; the first step's net input (z1 if it is even, z2 if odd) zero-padded; the
  // counts 0
  {
    const size_t pixels = size_t(a.B) * a.H * a.W, stride = size_t(gridDim.x) * NT;
    const size_t first = size_t(blockIdx.x) * NT + threadIdx.x;
    const bool even = (a.K - 1) % 2 == 0;
    const int cinp = even ? CIN_E : a.cin_o, off = even ? 0 : 3, n = even ? 3 : a.c - 3;
    float* d = even ? a.dense_e : a.dense_o;
    const int ctot = cinp + 4 * GC;
    for (size_t i = first; i < pixels * cinp; i += stride) {
      const size_t pix = i / cinp;
      const int j = int(i % cinp);
      d[pix * ctot + j] = j < n ? a.z[pix * a.c + off + j] : 0.f;
    }
    for (size_t i = first; i < pixels * a.c; i += stride) a.out[i] = a.z[i];
    for (size_t i = first; i < size_t(a.tiles); i += stride) a.done[i] = 0;
  }
  cg::this_grid().sync();

  // stage s on tile t (if prefetch, only the copies of its first weights)
  auto item = [&](int s, int t, bool prefetch) {
    const int k = a.K - 1 - s / 5, i = s % 5;
    const bool even = k % 2 == 0;
    const int cinp = even ? CIN_E : a.cin_o, n5 = even ? a.n5_e : 16, ctot = cinp + 4 * GC;
    float* d = even ? a.dense_e : a.dense_o;
    const int per = a.tx * a.ty, l = t % per;
    const int image = t / per, x0 = l % a.tx * TW, y0 = l / a.tx * TH;
    const size_t ne = (k + 1) / 2, no = k / 2;  // the even and odd steps before step k
    const float* w = a.w + ne * a.wstep_e + no * a.wstep_o + conv_offset(i, cinp, GC, n5, true);
    const float* b = a.b + ne * a.bstep_e + no * a.bstep_o + i * GC;
    if (i < 4) {
      if (prefetch) {
        conv3x3::prefetch_weights_f32<GC, MT>(smem, w, cinp + i * GC, a.H, a.W, x0, y0, image);
        return;
      }
      conv3x3::Acc<GC, MT> acc;
      conv3x3::conv_tile_f32<GC, MT, true>(acc, smem, d, ctot, cinp + i * GC, w, a.H,
                                                   a.W, x0, y0, image);
      conv3x3::feature_store(acc, d, ctot, b, cinp + i * GC, a.H, a.W, x0, y0, image);
      return;
    }
    float* next = k == 0 ? nullptr : (even ? a.dense_o : a.dense_e);
    const int next_cinp = even ? a.cin_o : CIN_E;
    auto coupling = [&](auto n) {
      if (prefetch) {
        conv3x3::prefetch_weights_f32<decltype(n)::value, MT>(smem, w, ctot, a.H, a.W, x0, y0,
                                                              image);
        return;
      }
      coupling_tile_f32<decltype(n)::value, MT>(
          smem, d, ctot, w, b, a.out, a.c, even, a.an_s + size_t(k) * a.c,
          a.an_b + size_t(k) * a.c, next, next_cinp + 4 * GC, next_cinp, a.H, a.W, x0, y0, image);
    };
    switch (n5) {
      case 16: coupling(std::integral_constant<int, 16>()); break;
      case 32: coupling(std::integral_constant<int, 32>()); break;
      case 48: coupling(std::integral_constant<int, 48>()); break;
      default: coupling(std::integral_constant<int, 64>()); break;
    }
  };

#pragma unroll 1
  for (int e = blockIdx.x; e < a.items; e += gridDim.x) {
    const int s = e / a.tiles, t = e - s * a.tiles;
    item(s, t, true);  // its first weights' copies, before it waits for its input
    wait_tiles(a.done, s, t, a.tx, a.ty);
    item(s, t, false);
    mark_done(a.done, s, t);
  }
}

template <int GC, int MT>
cudaError_t launch_f32(F32Args a, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(chain3s_f32_kernel<GC, MT>);
  constexpr int smem = conv3x3::smem_bytes_f32<GC, MT>() > conv3x3::smem_bytes_f32<64, MT>()
                           ? conv3x3::smem_bytes_f32<GC, MT>()
                           : conv3x3::smem_bytes_f32<64, MT>();
  static_assert(conv3x3::smem_bytes_f32<16, MT>() <= smem &&
                    conv3x3::smem_bytes_f32<32, MT>() <= smem &&
                    conv3x3::smem_bytes_f32<48, MT>() <= smem,
                "the widest conv's ring is the largest");
  const int c2 = a.c - 3;
  a.tx = (a.W + 8 * MT - 1) / (8 * MT);
  a.ty = (a.H + conv3x3::TH - 1) / conv3x3::TH;
  a.tiles = a.tx * a.ty * a.B;
  a.items = 5 * a.K * a.tiles;
  a.cin_o = rup(c2, 16);
  a.n5_e = 2 * rup(c2, 8);
  a.wstep_e = conv_offset(5, 16, GC, a.n5_e, true);
  a.wstep_o = conv_offset(5, a.cin_o, GC, 16, true);
  a.bstep_e = 4 * GC + a.n5_e;
  a.bstep_o = 4 * GC + 16;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = conv3x3::allow_smem<chain3s_f32_kernel<GC, MT>>(smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, conv3x3::NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = per_sm * sms < a.items ? per_sm * sms : a.items;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(conv3x3::NTHREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int chain3s_inverse_f32(const F32Args& a, int gc, cudaStream_t stream) {
  const int c2 = a.c - 3;
  if (a.B < 1 || a.H < 1 || a.W < 1 || a.K < 1 || c2 < 1 || c2 > 32 ||
      size_t(a.B) * ((a.H + 15) / 16) * ((a.W + 7) / 8) * 5 * a.K > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  return int(conv3x3::with_mt(a.W, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    switch (gc) {
      case 16: return launch_f32<16, MT>(a, stream);
      case 32: return launch_f32<32, MT>(a, stream);
      case 64: return launch_f32<64, MT>(a, stream);
      default: return cudaErrorInvalidValue;
    }
  }));
}

// ------------------------------------------------------------------------ launch
template <int N>
using Int = std::integral_constant<int, N>;

// fn(GC, N5) as std::integral_constants
template <class Fn>
cudaError_t with_n5(int n5, Fn fn) {
  switch (n5) {
    case 16: return fn(Int<16>());
    case 32: return fn(Int<32>());
    case 48: return fn(Int<48>());
    case 64: return fn(Int<64>());
    default: return cudaErrorInvalidValue;
  }
}

template <class Fn>
cudaError_t with_widths(int gc, int n5, Fn fn) {
  switch (gc) {
    case 16: return with_n5(n5, [&](auto n) { return fn(Int<16>(), n); });
    case 32: return with_n5(n5, [&](auto n) { return fn(Int<32>(), n); });
    case 64: return with_n5(n5, [&](auto n) { return fn(Int<64>(), n); });
    default: return cudaErrorInvalidValue;
  }
}

// A step plan {th, tw, stages, shared-memory bytes} the kernel can run: tiles of 8 (its
// 8x8 M tiles) to MAX_TILE, a ring of 2 or 3 stages, the bytes its geometry gives (the
// end of the last array), within a block's limit; conv5 in one pass, its staged sums
// within the ring and the first two arrays
bool plan_ok(const int* p, int cinp, int gc, int n5) {
  if (p[0] < 8 || p[1] < 8 || p[0] > MAX_TILE || p[1] > MAX_TILE || (p[2] != 2 && p[2] != 3))
    return false;
  const Geometry g = geometry(p[0], p[1], cinp, gc, n5, p[2]);
  // conv5 in one pass, its staged sums within the ring and the first two arrays
  return g.off(5) == p[3] && p[3] <= conv3x3::BLOCK_SMEM &&
         ((p[0] + 7) / 8) * ((p[1] + 7) / 8) <= NWG * mg(n5) &&
         p[0] * p[1] * n5 * 4 <= g.off(2);
}

int chain3s_inverse(const float* z, float* out, float* tmp, const bf16* wblob, const float* bblob,
                    const float* an_s, const float* an_b, int B, int H, int W, int c, int gc,
                    int K, const int* plan_e, const int* plan_o, cudaStream_t stream) {
  const int c2 = c - 3;
  if (B < 1 || H < 1 || W < 1 || K < 1 || c2 < 1 || c2 > 32 || B > 65535 ||
      (gc != 16 && gc != 32 && gc != 64))
    return int(cudaErrorInvalidValue);
  const int cin[2] = {16, rup(c2, 16)}, n5[2] = {2 * rup(c2, 8), 16};  // even, odd
  const int* plans[2] = {plan_e, plan_o};
  for (int t = 0; t < (K > 1 ? 2 : 1); ++t)
    if (!plan_ok(plans[t], cin[t], gc, n5[t])) return int(cudaErrorInvalidValue);
  const size_t wstep[2] = {conv_offset(5, cin[0], gc, n5[0], false),
                           conv_offset(5, cin[1], gc, n5[1], false)};
  const size_t bstep[2] = {size_t(4 * gc + n5[0]), size_t(4 * gc + n5[1])};
  const float* src = z;
  for (int n = 0; n < K; ++n) {
    const int k = K - 1 - n, t = k % 2;
    const int* p = plans[t];
    const size_t ne = (k + 1) / 2, no = k / 2;  // the even and odd steps before step k
    // the steps alternate between out and tmp so that step 0, the last, writes out
    const StepArgs a{src, k % 2 == 0 ? out : tmp, wblob + ne * wstep[0] + no * wstep[1],
                     bblob + ne * bstep[0] + no * bstep[1], an_s + size_t(k) * c,
                     an_b + size_t(k) * c, H, W, c, t == 0, cin[t], p[0], p[1], p[2]};
    cudaError_t err = with_widths(gc, n5[t], [&](auto gcv, auto n5v) {
      constexpr auto Kernel = chain3s_step_kernel<decltype(gcv)::value, decltype(n5v)::value>;
      cudaError_t e = conv3x3::allow_smem<Kernel>(conv3x3::BLOCK_SMEM);
      if (e != cudaSuccess) return e;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((W + p[1] - 1) / p[1], (H + p[0] - 1) / p[0], B);
      cfg.blockDim = dim3(NTHREADS);
      cfg.dynamicSmemBytes = p[3];
      cfg.stream = stream;
      cfg.attrs = attr;
      // the first step in stream order: no copy of weights that work queued before the
      // chain may still be writing
      cfg.numAttrs = n > 0 ? 1 : 0;
      return cudaLaunchKernelEx(&cfg, Kernel, a);
    });
    if (err != cudaSuccess) return int(err);
    src = a.zout;
  }
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// The K steps of one chain in bf16, k = K-1 .. 0.  z (B,H,W,c) float32 is not written;
// out (same shape) receives the result; tmp (same shape) is scratch for every other
// step's z (unused when K is 1).  wblob, bblob: the pack's weight and bias blobs (layout
// above).  plan_e, plan_o: {th, tw, ring stages, shared-memory bytes} of the even and
// the odd steps (ops/chain3s.py's plan); a plan the kernel cannot run, or one whose bytes
// are not its layout's, gives cudaErrorInvalidValue before any launch.  c - 3 is 1 ..
// 32, gc 16, 32 or 64.  Makes K launches; returns the first CUDA error.
int hcflow_chain3s_inverse(const float* z, float* out, float* tmp, const bf16* wblob,
                           const float* bblob, const float* an_s, const float* an_b, int B, int H,
                           int W, int c, int gc, int K, const int* plan_e, const int* plan_o,
                           cudaStream_t stream) {
  return chain3s_inverse(z, out, tmp, wblob, bblob, an_s, an_b, B, H, W, c, gc, K, plan_e, plan_o,
                         stream);
}

// The same chain in the float32 recipe (3xTF32 products), one cooperative launch: the
// blob holds the weights' TF32 planes; dense_e, dense_o: (B,H,W,cinp + 4 gc) float32
// scratch for the even and the odd steps (cinp 16 and rup16(c - 3)), done: B ceil(H /
// 16) ceil(W / 8) ints of scratch, any contents.  c - 3 is 1 .. 32.  Makes 1 launch;
// returns its CUDA error (cudaErrorNotSupported where the card has no cooperative
// launch).
int hcflow_chain3s_inverse_f32(const float* z, float* out, float* dense_e, float* dense_o,
                               int* done, const float* wblob, const float* bblob,
                               const float* an_s, const float* an_b, int B, int H, int W, int c,
                               int gc, int K, cudaStream_t stream) {
  F32Args a{z, out, dense_e, dense_o, done, wblob, bblob, an_s, an_b, B, H, W, c, K};
  return chain3s_inverse_f32(a, gc, stream);
}

}  // extern "C"
