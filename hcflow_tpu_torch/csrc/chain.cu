// Inverse flow-step chain for Hopper (sm_90a): one launch per flow step.
//
// Replaces the TPU kernel hcflow_tpu/ops/pallas_chain.py (_make_kernel, called by
// inverse_chain).  Each step of an Affine+FCN+invconv chain, from k = K-1 down to 0:
//   h1 = relu((conv3x3(z1) + uc_k + b1) * e1)
//   h2 = relu((h1 @ W2 + b2) * e2)
//   p  = conv3x3(h2) * g3 + bg3                    = [shift | scale]
//   z2 = z2 * exp(-0.318 * atan(2 * scale)) - shift
//   z  = Wt @ [z1; z2] - ab                        (float32 tail)
// z1, h1, h2 and the net weights are bf16 values; every sum is float32.
//
// Bound: operations, barely.  A step reads z (f32) and its cond term (64 bf16
// channels) and writes z, 50-450 bytes per pixel, for 19-91 kFLOP per pixel of bf16
// convs; the least time of a 13-step chain at the main path's shapes is 0.01-0.05 ms.
// What the work needs is little; what costs is latency: each block stages 35-95 KB
// of the step's weights from L2 and runs three dependent convs on a small tile.
//
// Design.  A block of 8 warps owns a TH x TW output tile.  It rounds z1 with a
// 2-pixel halo to bf16 in shared memory, runs conv1 and conv2 over the tile plus a
// 1-pixel halo (the h region), keeps h2 in shared memory, runs conv3 over the tile
// and the float32 tail, and writes only the new z: h1 and h2 never reach device
// memory; only z (f32) and the cond term (bf16) do.
// - Products on tensor cores: mma.sync m16n8k16 (bf16 in, float32 sums), all three
//   convs as implicit GEMMs with A gathered by ldmatrix (each lane gives one row's
//   address, so a row of M is any pixel of the region and a tap is an address
//   offset).  mma.sync rather than wgmma: the h region (e.g. 18x18 or 6x12 pixels) does
//   not fill 64-row tiles, N is as narrow as 8 per product (conv3 at c 6), and conv1's
//   accumulator fragment is, pair for pair, conv2's A fragment, so conv1's epilogue
//   (cond term + b1, x e1, ReLU, bf16) feeds conv2 in registers, which wgmma's
//   register-A form did not do safely on this card (PERF.md).  The products
//   wait on their ldmatrix loads, not on the tensor cores' rate (PERF.md), so
//   mma.sync's lower peak costs little.
//   conv1: M = the h region, N = 64, K = 9 taps x c1 padded to 8 (C1P), in k steps
//          of two 8-channel chunks (a last odd chunk meets zero weights).
//   conv2: M = the h region, N = 64, K = 64, A from conv1's registers.
//   conv3: M = the tile, N = [shift | scale], each half padded to 8 (S), K = 9 x 64.
//   The padded pack (ops/chain.py, padded=True) puts scale j at column S + j, so
//   shift j and scale j land in the same thread's fragment and the coupling runs
//   from registers.
// - Shared memory is one region reused across phases: z1, w1 and w2 during conv1/2,
//   then w3 and the tile's float32 z; h2, the per-channel vectors and Wt beside it.
//   So 67-95 KB a block and 2 blocks per SM at the main path's shapes.
// - Asynchronous copies: w1, w2, the vectors and Wt by cp.async before z1 is staged
//   (z1 is loaded by the threads, which round it to bf16 on the way, and zero outside
//   the image and in the padding channels); after conv2, the tile's z and w3.  The
//   other block on the SM runs its products during this block's copies.  Streaming w3
//   one tap a group under conv3's products (tap t waiting for its group only) was
//   slower than one wait for all of it, in a probe on an H100.
// - Programmatic dependent launch: every step after the first is launched with
//   programmatic stream serialization; a step lets the next one's grid launch once
//   all its blocks run, and waits (griddepcontrol.wait) for the previous step only
//   before it reads z or uc, so the next step's launch and weight copies overlap this
//   step's last blocks (PERF.md).  The launch count stays one a step.
// - Tiles sized per shape by pick_tile: the candidate that does the least padded work
//   among those whose grid covers the 132 SMs and of which two blocks fit an SM.
//   At batch 16 (grid, blocks per SM, shared memory):
//     80x80, c 6 / 12        16x16 tiles, 400 blocks, 2, 79.9 / 86.3 KB
//     40x40, c 12 / 21 / 24  8x20 tiles,  160 blocks, 2, 67.2 / 92.4 / 94.5 KB
//     20x20, c 45 / 48       4x10 tiles,  160 blocks, 2, 90.2 / 91.2 KB
//   (The candidates: 16x16, 8x20, 10x10, 8x16, 8x8, 4x10, 4x8.  16x16 tiles at 40x40
//   would compute a 48x48 region.)
// Where trouble was likely:
// - Odd and narrow widths: c1 is padded to 8 per tap, the products' K to 16 (c 6: c1
//   3 in 5 k steps; padding c1 to 16 took 9; folding the taps into K, 2, would need an
//   im2col copy) and shift and scale to 8 each (c 45: c2 23 -> S 24), with zero
//   weights, gains and biases; the tail runs over the c real channels.
// - Zero padding for conv3: conv2's epilogue stores 0 for h-region pixels outside
//   the image, not relu((b2 + ...) * e2).
// - Ragged tiles: A rows past the region read its last pixel and are dropped; the
//   tail and the coupling skip pixels outside the image, so no z is written there.
// - uc's stride: step k's term is at channels k*64 of a (B,H,W,K*64) tensor.
// - Bank conflicts: every bf16 row that ldmatrix reads has an odd number of 16-byte
//   units (h2, w1, w2: 72 elements; z1: C1P or C1P + 8; w3: 2S + 8).
// - Registers: conv1 and conv2 hold 16 pixels x 64 sums a warp (32 float32 and the
//   16 bf16 pairs of h1), conv3 16 pixels x one shift/scale pair of n8 tiles (8); the
//   tail, four outputs a thread, reads its operands from shared memory.  At
//   __launch_bounds__(256, 2) ptxas gives every instance 126-128 registers, and the
//   C1P 24 and 32 ones 4-12 bytes of spill (`-Xptxas -v`; chip_smoke.py prints it).
//
// Hidden widths: the coupling width HID (32 or 64) is a template parameter of the
// layout and both kernels; HID sets the row pitch HP = HID + 8 of h2, w1 and w2 (5 or 9
// 16-byte units, odd either way), every shared-memory offset, the products' N of conv1
// and conv2 and K of conv2 and conv3, and so the tile plan (pick_tile counts the
// products at either width).
//
// The float32 recipe (float32 pack and cond term) runs chain_step_f32_kernel: the same
// step with float32 operands and sums (the JAX kernel runs it at Precision.HIGHEST), in
// the bf16 kernel's shape on tensor cores: mma.sync m16n8k8 .tf32 with each product
// split in three TF32 ones (3xTF32, conv3x3.cuh: x = hi + lo, hi*hi + hi*lo + lo*hi, an
// error of ~2^-21 relative a product; no single-pass TF32), tiles by pick_tile, h1 in
// registers as conv2's A, h2 in shared memory as float32.  Bound: operations, 0.10
// TFLOP a x4 pass: 1.43 ms at the 67 TFLOP/s of float32 outside the tensor cores, 0.58
// at the 165 TFLOP/s that three TF32 products a product leave of the 495 TF32 peak.
// What bounds it (tools/probe_chain.py --f32, PERF.md): the products, 3 a product (one
// product instead of three: -42%), then the splits (-25% without them); staging w3 and
// the tail 3% each.  It replaced a CUDA-core design (fmaf, fixed 8x8 tiles, every block
// copying the step's weights: 7.70 ms a trained x4 pass) after an A/B on one card.
//
// Layouts: z is NHWC float32 (B,H,W,c); uc is NHWC (B,H,W,K*HID) in the pack's dtype,
// step k's term at channels k*HID..; the padded pack per step: w1 [9][C1P][HID], w2
// [HID in][HID out], w3 [9][HID][2S] as [shift (S) | scale (S)], vec = b1,e1,b2,e2 (HID
// each) then g3,bg3 (2S each), wt [c][c], ab [c].

#include "conv3x3.cuh"

namespace {

using conv3x3::bf16;
using conv3x3::smem_addr;

constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;
constexpr int MAX_SMEM = 232448;
using conv3x3::SM_SMEM;  // shared memory of an SM, 1 KB of it reserved a block

__host__ __device__ constexpr int up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory layout (byte offsets) of a th x tw tile at c channels.
template <int HID, int C1P, int N3P>
struct Layout {
  // row pitches (elements), odd numbers of 16-byte units: h2, w1 and w2; z1; w3
  static constexpr int HP = HID + 8, ZP = C1P / 8 % 2 ? C1P : C1P + 8, W3P = N3P + 8;
  // products a warp issues for 16 pixels: conv1 and conv2 (h region), conv3 (tile)
  static constexpr int MMA12 = (9 * C1P + 15) / 16 * HID / 8 + HID / 16 * HID / 8,
                       MMA3 = 9 * HID / 16 * 2;
  static constexpr int KS1 = (9 * C1P + 15) / 16;  // conv1's k steps: 9 taps x C1P
  int c, c1, c2, cq, th, tw, zw, hw2, hr, mt12, mt3, items3;
  int o_z1, o_w1, o_w2, o_w3, o_zz, o_h2, o_vec, o_wt, o_ab, bytes;

  __host__ __device__ Layout(int c_, int th_, int tw_) : c(c_), th(th_), tw(tw_) {
    c1 = c / 2;
    c2 = c - c1;
    cq = up(c, 4);  // the tail's row pitch of Wt
    zw = tw + 4;
    hw2 = tw + 2;
    hr = (th + 2) * hw2;
    mt12 = (hr + 15) / 16;
    mt3 = (th * tw + 15) / 16;
    items3 = mt3 * (N3P / 16);
    // region 1: z1, w1, w2 while conv1/2 run; then w3 and the tile's float32 z
    o_z1 = 0;
    o_w1 = (th + 4) * zw * ZP * 2;
    o_w2 = o_w1 + KS1 * 16 * HP * 2;
    const int r1a = o_w2 + HID * HP * 2;
    o_w3 = 0;
    o_zz = 9 * HID * W3P * 2;
    const int r1b = o_zz + th * tw * c * 4;
    o_h2 = up(r1a > r1b ? r1a : r1b, 16);
    o_vec = o_h2 + hr * HP * 2;
    o_wt = o_vec + (4 * HID + 2 * N3P) * 4;
    o_ab = o_wt + c * cq * 4;
    bytes = up(o_ab + c * 4, 16);
  }
};

// ------------------------------------------------------------------------------ PTX
// 4 bytes global -> shared (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d += a (16 x 16, row) * b (16 x 8, col); bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The fused invconv^-1 + actnorm^-1 of a th x tw tile, float32: z = Wt @ zz - ab, four
// outputs a thread (Wt transposed to [k][o] in shared memory, rows padded to cq, a
// multiple of 4); no z is written outside the image.
__device__ __forceinline__ void tail(const float* s_zz, const float* s_wt, const float* s_ab,
                                     float* __restrict__ zout, size_t img, int H, int W, int c,
                                     int cq, int x0, int y0, int th, int tw) {
  const int nq = cq / 4;
  for (int i = threadIdx.x; i < th * tw * nq; i += NTHREADS) {
    const int p = i / nq, o = (i - p * nq) * 4;
    const int gy = y0 + p / tw, gx = x0 + p % tw;
    if (gy >= H || gx >= W) continue;
    const float* zz = s_zz + p * c;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < c; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(s_wt + k * cq + o);
      const float z = zz[k];
      sum[0] = fmaf(w.x, z, sum[0]);
      sum[1] = fmaf(w.y, z, sum[1]);
      sum[2] = fmaf(w.z, z, sum[2]);
      sum[3] = fmaf(w.w, z, sum[3]);
    }
    float* dst = zout + (img + size_t(gy) * W + gx) * c + o;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (o + e < c) dst[e] = sum[e] - s_ab[o + e];
  }
}

// ---------------------------------------------------------------------- the step
// In mma's fragments lane l holds rows g = l/4 and g + 8 and columns 2q, 2q + 1
// (q = l%4) of each n8 tile; A (16 x 16) and B (16 x 8) come from ldmatrix.x4 with
// lane l giving row l%16 at column (l/16)*8.
template <int HID, int C1P, int N3P>
__global__ void __launch_bounds__(NTHREADS, 2)
chain_step_mma_kernel(const float* __restrict__ zin, float* __restrict__ zout,
                      const bf16* __restrict__ uc, int uc_stride, const bf16* __restrict__ w1,
                      const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                      const float* __restrict__ vec, const float* __restrict__ wt,
                      const float* __restrict__ ab, int H, int W, int c, int th, int tw) {
  using Lay = Layout<HID, C1P, N3P>;
  constexpr int HP = Lay::HP, ZP = Lay::ZP, W3P = Lay::W3P, S = N3P / 2, NG = S / 8,
                NVEC = 4 * HID + 2 * N3P;
  constexpr int NT = HID / 8, KH = HID / 16;  // n8 tiles of HID; k16 steps of HID
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CPT = C1P / 8;  // 8-channel chunks of z1 a tap
  const Lay L(c, th, tw);
  const uint32_t s0 = smem_addr(smem);
  float* s_zz = reinterpret_cast<float*>(smem + L.o_zz);
  const float* s_vec = reinterpret_cast<const float*>(smem + L.o_vec);
  const float* s_wt = reinterpret_cast<const float*>(smem + L.o_wt);
  const float* s_ab = reinterpret_cast<const float*>(smem + L.o_ab);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int c1 = L.c1, c2 = L.c2, x0 = blockIdx.x * tw, y0 = blockIdx.y * th;
  const size_t img = size_t(blockIdx.z) * H * W;

  // ---- w1, w2, the vectors, Wt (transposed to [k][o]) and ab by cp.async
  for (int i = tid; i < 9 * C1P * NT; i += NTHREADS)
    conv3x3::cp_async16(s0 + L.o_w1 + (i / NT) * HP * 2 + i % NT * 16,
                        w1 + (i / NT) * HID + i % NT * 8, true);
  for (int i = tid; i < (Lay::KS1 * 16 - 9 * C1P) * HID / 2; i += NTHREADS) {  // past 9 C1P
    uint32_t* row = reinterpret_cast<uint32_t*>(smem + L.o_w1 + (9 * C1P + i / (HID / 2)) * HP * 2);
    row[i % (HID / 2)] = 0;
  }
  for (int i = tid; i < HID * NT; i += NTHREADS)
    conv3x3::cp_async16(s0 + L.o_w2 + (i / NT) * HP * 2 + i % NT * 16,
                        w2 + (i / NT) * HID + i % NT * 8, true);
  for (int i = tid; i < NVEC / 4; i += NTHREADS)
    conv3x3::cp_async16(s0 + L.o_vec + i * 16, vec + 4 * i, true);
  for (int i = tid; i < c * c; i += NTHREADS)
    cp_async4(s0 + L.o_wt + ((i % c) * L.cq + i / c) * 4, wt + i);
  for (int i = tid; i < c; i += NTHREADS) cp_async4(s0 + L.o_ab + i * 4, ab + i);
  conv3x3::cp_async_commit();
  // Programmatic dependent launch: the next step's blocks may start their weight
  // copies while this grid runs; z and uc are read after the previous grid is done.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // ---- z1 with a 2-pixel halo as bf16, [pixel][ZP]; zero outside the image and
  // from channel c1 on
  for (int i = tid; i < (th + 4) * L.zw * CPT; i += NTHREADS) {
    const int px = i / CPT, part = i % CPT;
    const int gy = y0 - 2 + px / L.zw, gx = x0 - 2 + px % L.zw;
    float f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* src = zin + (img + size_t(gy) * W + gx) * c + part * 8;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (part * 8 + k < c1) f[k] = src[k];
    }
    *reinterpret_cast<uint4*>(smem + L.o_z1 + (px * ZP + part * 8) * 2) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                   pack_bf16(f[6], f[7]));
  }
  conv3x3::cp_async_wait<0>();
  __syncthreads();

  const float* b1 = s_vec;
  const float* e1 = s_vec + HID;
  const float* b2 = s_vec + 2 * HID;
  const float* e2 = s_vec + 3 * HID;
  const float* g3 = s_vec + 4 * HID;
  const float* bg3 = g3 + N3P;

  // ---- conv1 (+ cond term) and conv2 over the h region, 16 pixels a warp at a time
  for (int mt = warp; mt < L.mt12; mt += NWARPS) {
    const int ra = min(mt * 16 + lane % 16, L.hr - 1);  // this lane's A row (pixel)
    const uint32_t a1 = s0 + L.o_z1 + (ra / L.hw2 * L.zw + ra % L.hw2) * ZP * 2;
    const uint32_t bw1 = s0 + L.o_w1 + ((lane % 16) * HP + lane / 16 * 8) * 2;
    // the rows this thread's sums belong to: pixels r[h] = mt*16 + g + 8h
    bool in[2];
    size_t pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      const int gy = y0 - 1 + r / L.hw2, gx = x0 - 1 + r % L.hw2;
      in[h] = r < L.hr && gy >= 0 && gy < H && gx >= 0 && gx < W;
      pix[h] = in[h] ? img + size_t(gy) * W + gx : 0;
    }
    uint32_t u[NT][2];  // cond term, loaded ahead of the products
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        u[nt][h] = uc != nullptr && in[h] ? *reinterpret_cast<const uint32_t*>(
                                                uc + pix[h] * uc_stride + 8 * nt + 2 * q)
                                          : 0u;

    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    // k = tap * C1P + channel: k step ks takes 8-channel chunks 2 ks (lanes 0-15)
    // and 2 ks + 1 (lanes 16-31) of the 9 CPT; a chunk past the last (9 CPT odd)
    // reads chunk 0 against zero weights
    auto chunk = [&](int j) -> uint32_t {
      j = j < 9 * CPT ? j : 0;
      return ((j / CPT / 3) * L.zw + j / CPT % 3) * ZP * 2 + j % CPT * 16;
    };
#pragma unroll
    for (int ks = 0; ks < Lay::KS1; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a1 + chunk(2 * ks + lane / 16));
#pragma unroll
      for (int np = 0; np < KH; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, bw1 + (ks * 16 * HP + np * 16) * 2);
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    // conv1's epilogue straight into conv2's A fragments: n8 tiles 2ks and 2ks+1 of
    // conv1's sums are k step ks of conv2
    uint32_t ha[KH][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = 8 * nt + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 uf = unpack_bf16(u[nt][h]);
        const float v0 = fmaxf((acc[nt][2 * h] + uf.x + b1[j]) * e1[j], 0.f);
        const float v1 = fmaxf((acc[nt][2 * h + 1] + uf.y + b1[j + 1]) * e1[j + 1], 0.f);
        ha[nt / 2][nt % 2 * 2 + h] = pack_bf16(v0, v1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const uint32_t bw2 = s0 + L.o_w2 + ((lane % 16) * HP + lane / 16 * 8) * 2;
#pragma unroll
    for (int ks = 0; ks < KH; ++ks)
#pragma unroll
      for (int np = 0; np < KH; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, bw2 + (ks * 16 * HP + np * 16) * 2);
        mma(acc[2 * np], ha[ks], b[0], b[1]);
        mma(acc[2 * np + 1], ha[ks], b[2], b[3]);
      }
    // conv2's epilogue; zero outside the image (conv3's padding)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r >= L.hr) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(smem + L.o_h2 + (r * HP + 2 * q) * 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = 8 * nt + 2 * q;
        const float v0 = in[h] ? fmaxf((acc[nt][2 * h] + b2[j]) * e2[j], 0.f) : 0.f;
        const float v1 = in[h] ? fmaxf((acc[nt][2 * h + 1] + b2[j + 1]) * e2[j + 1], 0.f) : 0.f;
        dst[4 * nt] = pack_bf16(v0, v1);
      }
    }
  }
  __syncthreads();  // h2 is complete; z1, w1 and w2 are no longer read

  // ---- the tile's float32 z (rows of the tile are runs of z) and w3
  const int wv = min(tw, W - x0);
  for (int ty = 0; ty < th && y0 + ty < H; ++ty) {
    const float* src = zin + (img + size_t(y0 + ty) * W + x0) * c;
    for (int i = tid; i < wv * c; i += NTHREADS)
      cp_async4(s0 + L.o_zz + (ty * tw * c + i) * 4, src + i);
  }
  for (int i = tid; i < 9 * HID * (N3P / 8); i += NTHREADS)
    conv3x3::cp_async16(s0 + L.o_w3 + (i / (N3P / 8) * W3P + i % (N3P / 8) * 8) * 2,
                        w3 + i * 8, true);
  conv3x3::cp_async_commit();
  conv3x3::cp_async_wait<0>();
  __syncthreads();

  // ---- conv3 over the tile and the affine inverse on the staged z, float32:
  // z2 = z2 * exp(-logscale) - shift.  An item is 16 pixels (M tile it / NG) x the
  // shift and the scale n8 tiles of pair it % NG.
  for (int it = warp; it < L.items3; it += NWARPS) {
    const int mi = it / NG, pr = it % NG;
    const int ra = min(mi * 16 + lane % 16, th * tw - 1);
    const uint32_t a3 = s0 + L.o_h2 + ((ra / tw * L.hw2 + ra % tw) * HP + lane / 16 * 8) * 2;
    const uint32_t b3 = s0 + L.o_w3 + ((lane % 16) * W3P + (lane < 16 ? 8 * pr : S + 8 * pr)) * 2;
    float acc[2][4] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int ks = 0; ks < KH; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, a3 + ((tap / 3) * L.hw2 + tap % 3) * HP * 2 + ks * 32);
        ldsm_x4_t(b, b3 + (tap * HID + ks * 16) * W3P * 2);
        mma(acc[0], a, b[0], b[1]);
        mma(acc[1], a, b[2], b[3]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mi * 16 + g + 8 * h;
      if (p >= th * tw || y0 + p / tw >= H || x0 + p % tw >= W) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * pr + 2 * q + e;
        if (j >= c2) continue;
        const float shift = fmaf(acc[0][2 * h + e], g3[j], bg3[j]);
        const float scale = fmaf(acc[1][2 * h + e], g3[S + j], bg3[S + j]);
        const float ls = 0.318f * atanf(2.f * scale);
        float* zz = s_zz + p * c + c1 + j;
        *zz = *zz * expf(-ls) - shift;
      }
    }
  }
  __syncthreads();

  // ---- fused invconv^-1 + actnorm^-1
  tail(s_zz, s_wt, s_ab, zout, img, H, W, c, L.cq, x0, y0, th, tw);
}

// ------------------------------------------------------------- the float32 step
// Shared-memory layout (byte offsets) of the float32 kernel's th x tw tile, all float32.
// Region 1 holds z1 (with a 2-pixel halo), w1 and w2 while conv1/2 run, then a row of
// w3's taps and the tile's z; h2, the vectors, Wt and ab sit beside it.  Pitches (in
// floats): z1 and h2 rows C1P + 4 and HID + 4 (an odd number of 16-byte units, so that
// ldmatrix reads 8 pixels without bank conflicts); w1 and w3 rows HID + 8 and N3P + 8
// (8 mod 32: a warp's B-fragment loads, rows q and columns g, hit 32 banks); w2 rows HID
// + 4 (4 mod 32: conv2 reads rows 2q and 2q + 1, see below).
constexpr int MAX_MT3 = 2;  // conv3 M tiles a warp holds across the three tap rows

template <int HID, int C1P, int N3P>
struct LayoutF32 {
  static constexpr int ZP = C1P + 4, HP = HID + 4, W1P = HID + 8, W2P = HID + 4, W3P = N3P + 8;
  static constexpr int KS1 = 9 * C1P / 8;  // conv1's k8 steps: 9 taps x C1P
  // TF32 products a warp issues for 16 pixels (three a product): conv1 and conv2 (h
  // region), conv3 (tile)
  static constexpr int MMA12 = 3 * (KS1 + HID / 8) * (HID / 8), MMA3 = 3 * 9 * (HID / 8) * 2;
  int c, c1, c2, cq, th, tw, zw, hw2, hr, mt12, mt3;
  int o_z1, o_w1, o_w2, o_w3, o_zz, o_h2, o_vec, o_wt, o_ab, bytes;

  __host__ __device__ LayoutF32(int c_, int th_, int tw_) : c(c_), th(th_), tw(tw_) {
    c1 = c / 2;
    c2 = c - c1;
    cq = up(c, 4);
    zw = tw + 4;
    hw2 = tw + 2;
    hr = (th + 2) * hw2;
    mt12 = (hr + 15) / 16;
    mt3 = (th * tw + 15) / 16;
    o_z1 = 0;
    o_w1 = (th + 4) * zw * ZP * 4;
    o_w2 = o_w1 + 9 * C1P * W1P * 4;
    const int r1a = o_w2 + HID * W2P * 4;
    o_w3 = 0;
    o_zz = 3 * HID * W3P * 4;
    const int r1b = o_zz + th * tw * c * 4;
    o_h2 = up(r1a > r1b ? r1a : r1b, 16);
    o_vec = o_h2 + hr * HP * 4;
    o_wt = o_vec + (4 * HID + 2 * N3P) * 4;
    o_ab = o_wt + c * cq * 4;
    bytes = up(o_ab + c * 4, 16);
  }
};

// One step of the float32 recipe on the padded float32 pack, the bf16 kernel's design
// in float32: conv1, conv2 and conv3 as implicit GEMMs on mma.sync m16n8k8 .tf32, each
// product split in three TF32 ones (conv3x3::mma_3xtf32: x = hi + lo, hi*hi + hi*lo +
// lo*hi, float32 sums), A by ldmatrix from float32 rows (a tap is an address offset),
// split in registers; B loaded as scalars from the [k][n] weight rows and split too.
// conv1's accumulator is conv2's A in registers: in m16n8k8 a thread holds columns 2q
// and 2q + 1 of each n8 tile but A's fragment takes columns q and q + 4, so conv2's k
// step ks runs over h1 channels 8 ks + (0, 2, 4, 6, 1, 3, 5, 7) and reads w2's rows in
// that order.  conv3 streams w3 a row of three taps at a time; a warp's M tiles (16
// pixels x all [shift | scale] columns, so that each A fragment it splits serves every
// n8 tile) stay in registers across the rows.
template <int HID, int C1P, int N3P>
__global__ void __launch_bounds__(NTHREADS, 2)
chain_step_f32_kernel(const float* __restrict__ zin, float* __restrict__ zout,
                      const float* __restrict__ uc, int uc_stride, const float* __restrict__ w1,
                      const float* __restrict__ w2, const float* __restrict__ w3,
                      const float* __restrict__ vec, const float* __restrict__ wt,
                      const float* __restrict__ ab, int H, int W, int c, int th, int tw) {
  using Lay = LayoutF32<HID, C1P, N3P>;
  constexpr int ZP = Lay::ZP, HP = Lay::HP, W1P = Lay::W1P, W2P = Lay::W2P, W3P = Lay::W3P;
  constexpr int S = N3P / 2, NG = S / 8, NVEC = 4 * HID + 2 * N3P, NT = HID / 8, N3T = N3P / 8;
  constexpr int CPT = C1P / 8;  // 8-channel chunks of z1 a tap
  extern __shared__ __align__(128) unsigned char smem[];
  const Lay L(c, th, tw);
  const uint32_t s0 = smem_addr(smem);
  const float* s_w1 = reinterpret_cast<const float*>(smem + L.o_w1);
  const float* s_w2 = reinterpret_cast<const float*>(smem + L.o_w2);
  const float* s_w3 = reinterpret_cast<const float*>(smem + L.o_w3);
  float* s_z1 = reinterpret_cast<float*>(smem + L.o_z1);
  float* s_h2 = reinterpret_cast<float*>(smem + L.o_h2);
  float* s_zz = reinterpret_cast<float*>(smem + L.o_zz);
  const float* s_vec = reinterpret_cast<const float*>(smem + L.o_vec);
  const float* s_wt = reinterpret_cast<const float*>(smem + L.o_wt);
  const float* s_ab = reinterpret_cast<const float*>(smem + L.o_ab);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int c1 = L.c1, c2 = L.c2, x0 = blockIdx.x * tw, y0 = blockIdx.y * th;
  const size_t img = size_t(blockIdx.z) * H * W;

  // ---- w1, w2, the vectors, Wt (transposed to [k][o]) and ab by cp.async: independent
  // of the previous step, so copied before waiting for it
  for (int i = tid; i < 9 * C1P * NT * 2; i += NTHREADS)
    conv3x3::cp_async16(s0 + L.o_w1 + ((i / (2 * NT)) * W1P + i % (2 * NT) * 4) * 4,
                        w1 + i * 4, true);
  for (int i = tid; i < HID * NT * 2; i += NTHREADS)
    conv3x3::cp_async16(s0 + L.o_w2 + ((i / (2 * NT)) * W2P + i % (2 * NT) * 4) * 4,
                        w2 + i * 4, true);
  for (int i = tid; i < NVEC / 4; i += NTHREADS)
    conv3x3::cp_async16(s0 + L.o_vec + i * 16, vec + 4 * i, true);
  for (int i = tid; i < c * c; i += NTHREADS)
    cp_async4(s0 + L.o_wt + ((i % c) * L.cq + i / c) * 4, wt + i);
  for (int i = tid; i < c; i += NTHREADS) cp_async4(s0 + L.o_ab + i * 4, ab + i);
  conv3x3::cp_async_commit();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // ---- z1 with a 2-pixel halo, [pixel][ZP]; zero outside the image and from channel
  // c1 on
  for (int i = tid; i < (th + 4) * L.zw * CPT * 2; i += NTHREADS) {
    const int px = i / (2 * CPT), part = i % (2 * CPT);
    const int gy = y0 - 2 + px / L.zw, gx = x0 - 2 + px % L.zw;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* src = zin + (img + size_t(gy) * W + gx) * c + part * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (part * 4 + k < c1) f[k] = src[k];
    }
    *reinterpret_cast<float4*>(s_z1 + px * ZP + part * 4) = make_float4(f[0], f[1], f[2], f[3]);
  }
  conv3x3::cp_async_wait<0>();
  __syncthreads();

  const float* b1 = s_vec;
  const float* e1 = s_vec + HID;
  const float* b2 = s_vec + 2 * HID;
  const float* e2 = s_vec + 3 * HID;
  const float* g3 = s_vec + 4 * HID;
  const float* bg3 = g3 + N3P;

  // ---- conv1 (+ cond term) and conv2 over the h region, 16 pixels a warp at a time
  for (int mt = warp; mt < L.mt12; mt += NWARPS) {
    const int ra = min(mt * 16 + lane % 16, L.hr - 1);  // this lane's A row (pixel)
    const uint32_t a1 = s0 + L.o_z1 + ((ra / L.hw2 * L.zw + ra % L.hw2) * ZP + lane / 16 * 4) * 4;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    // k step j: tap j / CPT, channels 8 (j % CPT) ..; w1 row j * 8 + k
#pragma unroll 2
    for (int j = 0; j < Lay::KS1; ++j) {
      const int tap = j / CPT;
      uint32_t a[4], ah[4], al[4];
      conv3x3::ldsm_x4(a, a1 + (((tap / 3) * L.zw + tap % 3) * ZP + j % CPT * 8) * 4);
      conv3x3::split_tf32(a, ah, al);
      const float* wr = s_w1 + (j * 8 + q) * W1P + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        conv3x3::split_tf32(__float_as_uint(wr[8 * nt]), bh0, bl0);
        conv3x3::split_tf32(__float_as_uint(wr[4 * W1P + 8 * nt]), bh1, bl1);
        conv3x3::mma_3xtf32(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3], ah, al, bh0, bh1, bl0,
                            bl1);
      }
    }
    // the rows this thread's sums belong to: pixels r[h] = mt*16 + g + 8h
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      const int gy = y0 - 1 + r / L.hw2, gx = x0 - 1 + r % L.hw2;
      in[h] = r < L.hr && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* u = uc != nullptr && in[h] ? uc + (img + size_t(gy) * W + gx) * uc_stride
                                              : nullptr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = 8 * nt + 2 * q;
        const float2 uf = u != nullptr ? *reinterpret_cast<const float2*>(u + j)
                                       : make_float2(0.f, 0.f);
        acc[nt][2 * h] = fmaxf((acc[nt][2 * h] + uf.x + b1[j]) * e1[j], 0.f);
        acc[nt][2 * h + 1] = fmaxf((acc[nt][2 * h + 1] + uf.y + b1[j + 1]) * e1[j + 1], 0.f);
      }
    }
    // conv2: h1 (conv1's epilogue, in acc) is its A; k step ks = n8 tile ks of h1, A
    // fragment {c0, c2, c1, c3} = channels 8 ks + 2q (rows g, g + 8), 8 ks + 2q + 1
    float acc2[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const uint32_t a[4] = {__float_as_uint(acc[ks][0]), __float_as_uint(acc[ks][2]),
                             __float_as_uint(acc[ks][1]), __float_as_uint(acc[ks][3])};
      uint32_t ah[4], al[4];
      conv3x3::split_tf32(a, ah, al);
      const float* wr = s_w2 + (8 * ks + 2 * q) * W2P + g;
#pragma unroll
      for (int np = 0; np < NT; ++np) {
        uint32_t bh0, bl0, bh1, bl1;
        conv3x3::split_tf32(__float_as_uint(wr[8 * np]), bh0, bl0);
        conv3x3::split_tf32(__float_as_uint(wr[W2P + 8 * np]), bh1, bl1);
        conv3x3::mma_3xtf32(acc2[np][0], acc2[np][1], acc2[np][2], acc2[np][3], ah, al, bh0, bh1,
                            bl0, bl1);
      }
    }
    // conv2's epilogue into h2; zero outside the image (conv3's padding)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r >= L.hr) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = 8 * nt + 2 * q;
        const float v0 = in[h] ? fmaxf((acc2[nt][2 * h] + b2[j]) * e2[j], 0.f) : 0.f;
        const float v1 = in[h] ? fmaxf((acc2[nt][2 * h + 1] + b2[j + 1]) * e2[j + 1], 0.f) : 0.f;
        *reinterpret_cast<float2*>(s_h2 + r * HP + j) = make_float2(v0, v1);
      }
    }
  }
  __syncthreads();  // h2 is complete; z1, w1 and w2 are no longer read

  // ---- the tile's float32 z (rows of the tile are runs of z)
  const int wv = min(tw, W - x0);
  for (int ty = 0; ty < th && y0 + ty < H; ++ty) {
    const float* src = zin + (img + size_t(y0 + ty) * W + x0) * c;
    for (int i = tid; i < wv * c; i += NTHREADS)
      cp_async4(s0 + L.o_zz + (ty * tw * c + i) * 4, src + i);
  }
  // ---- conv3 over the tile, w3 a row of three taps at a time: M tile mi = warp + k
  // NWARPS of the tile x the N3T n8 tiles [shift (NG) | scale (NG)]
  float acc3[MAX_MT3][N3T][4];
#pragma unroll
  for (int k = 0; k < MAX_MT3; ++k)
#pragma unroll
    for (int n = 0; n < N3T; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[k][n][e] = 0.f;
  for (int row = 0; row < 3; ++row) {
    if (row) __syncthreads();  // the previous row's taps are no longer read
    for (int i = tid; i < 3 * HID * (N3P / 4); i += NTHREADS)
      conv3x3::cp_async16(s0 + L.o_w3 + ((i / (N3P / 4)) * W3P + i % (N3P / 4) * 4) * 4,
                          w3 + (size_t(row) * 3 * HID * N3P + i * 4), true);
    conv3x3::cp_async_commit();
    conv3x3::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_MT3; ++k) {
      const int mi = warp + k * NWARPS;
      if (mi >= L.mt3) break;
      const int ra = min(mi * 16 + lane % 16, th * tw - 1);
      const uint32_t a3 = s0 + L.o_h2 + ((ra / tw * L.hw2 + ra % tw) * HP + lane / 16 * 4) * 4;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const uint32_t at = a3 + ((row * L.hw2 + t) * HP) * 4;
        const float* wr = s_w3 + (t * HID + q) * W3P + g;
#pragma unroll 2
        for (int ks = 0; ks < HID / 8; ++ks) {
          uint32_t a[4], ah[4], al[4];
          conv3x3::ldsm_x4(a, at + ks * 32);
          conv3x3::split_tf32(a, ah, al);
#pragma unroll
          for (int n = 0; n < N3T; ++n) {
            const float* w = wr + ks * 8 * W3P + 8 * n;
            uint32_t bh0, bl0, bh1, bl1;
            conv3x3::split_tf32(__float_as_uint(w[0]), bh0, bl0);
            conv3x3::split_tf32(__float_as_uint(w[4 * W3P]), bh1, bl1);
            conv3x3::mma_3xtf32(acc3[k][n][0], acc3[k][n][1], acc3[k][n][2], acc3[k][n][3], ah,
                                al, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
  }
  // ---- the affine inverse on the staged z, float32: z2 = z2 * exp(-logscale) - shift
#pragma unroll
  for (int k = 0; k < MAX_MT3; ++k) {
    const int mi = warp + k * NWARPS;
    if (mi >= L.mt3) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mi * 16 + g + 8 * h;
      if (p >= th * tw || y0 + p / tw >= H || x0 + p % tw >= W) continue;
#pragma unroll
      for (int pr = 0; pr < NG; ++pr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 8 * pr + 2 * q + e;
          if (jj >= c2) continue;
          const float shift = fmaf(acc3[k][pr][2 * h + e], g3[jj], bg3[jj]);
          const float scale = fmaf(acc3[k][NG + pr][2 * h + e], g3[S + jj], bg3[S + jj]);
          const float ls = 0.318f * atanf(2.f * scale);
          float* zz = s_zz + p * c + c1 + jj;
          *zz = *zz * expf(-ls) - shift;
        }
    }
  }
  __syncthreads();

  // ---- fused invconv^-1 + actnorm^-1
  tail(s_zz, s_wt, s_ab, zout, img, H, W, c, L.cq, x0, y0, th, tw);
}

// ------------------------------------------------------------------------ launch
struct Plan {
  int th, tw, blocks, smem;
};

// The tile for a (B,H,W,c) step: of the candidates whose shared memory fits a block,
// the one that does the least padded work (M-tile rows x products of conv1/2 and
// conv3, over the grid) among those whose grid covers every SM with two blocks fitting
// an SM; else among those that cover every SM; else the one with the most blocks.
// Lay: the bf16 kernel's Layout or the float32 kernel's LayoutF32; CAP_MT3: only tiles
// whose conv3 M tiles fit the warps' registers (the float32 kernel holds them there).
template <class Lay, int N3P, bool CAP_MT3>
Plan pick_tile(int B, int H, int W, int c, int nsm) {
  static constexpr int TILES[][2] = {{16, 16}, {8, 20}, {10, 10}, {8, 16}, {8, 8}, {4, 10}, {4, 8}};
  Plan best{0, 0, 0, 0};
  long best_key[3] = {0, 0, 0};
  for (const auto& t : TILES) {
    const Lay L(c, t[0], t[1]);
    if (L.bytes > MAX_SMEM || (CAP_MT3 && L.mt3 > MAX_MT3 * NWARPS)) continue;
    const int blocks = B * ((H + t[0] - 1) / t[0]) * ((W + t[1] - 1) / t[1]);
    const long work = long(blocks) * (L.mt12 * Lay::MMA12 + L.mt3 * Lay::MMA3 * (N3P / 16));
    const bool covers = blocks >= nsm, two = 2 * (L.bytes + 1024) <= SM_SMEM;
    const long key[3] = {covers ? 0 : 1, covers && two ? 0 : 1, covers ? work : -blocks};
    if (best.blocks == 0 || key[0] < best_key[0] ||
        (key[0] == best_key[0] &&
         (key[1] < best_key[1] || (key[1] == best_key[1] && key[2] < best_key[2])))) {
      best = {t[0], t[1], blocks, L.bytes};
      for (int k = 0; k < 3; ++k) best_key[k] = key[k];
    }
  }
  return best;
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int N>
using Int = std::integral_constant<int, N>;

// fn(HID) as a std::integral_constant, for hid 32 or 64
template <class Fn>
cudaError_t with_hid(int hid, Fn fn) {
  if (hid == 32) return fn(Int<32>());
  if (hid == 64) return fn(Int<64>());
  return cudaErrorInvalidValue;
}

// fn(C1P, N3P) as std::integral_constants for c channels (C1P = c/2 padded to 8; N3P =
// 2S, twice c - c/2 padded to 8), c from 2 to 64
template <class Fn>
cudaError_t with_widths(int c, Fn fn) {
  const int c1p = up(c / 2, 8), n3p = 2 * up(c - c / 2, 8);
  if (c1p == 8 && n3p == 16) return fn(Int<8>(), Int<16>());
  if (c1p == 8 && n3p == 32) return fn(Int<8>(), Int<32>());
  if (c1p == 16 && n3p == 32) return fn(Int<16>(), Int<32>());
  if (c1p == 16 && n3p == 48) return fn(Int<16>(), Int<48>());
  if (c1p == 24 && n3p == 48) return fn(Int<24>(), Int<48>());
  if (c1p == 24 && n3p == 64) return fn(Int<24>(), Int<64>());
  if (c1p == 32 && n3p == 64) return fn(Int<32>(), Int<64>());
  return cudaErrorInvalidValue;
}

// The tile plan of one step: the bf16 kernel's or the float32 kernel's.
cudaError_t plan_step(int B, int H, int W, int c, int hid, bool f32, Plan* p) {
  return with_hid(hid, [&](auto h) {
    return with_widths(c, [&](auto c1p, auto n3p) {
      constexpr int HID = decltype(h)::value, C1P = decltype(c1p)::value,
                    N3P = decltype(n3p)::value;
      *p = f32 ? pick_tile<LayoutF32<HID, C1P, N3P>, N3P, true>(B, H, W, c, num_sms())
               : pick_tile<Layout<HID, C1P, N3P>, N3P, false>(B, H, W, c, num_sms());
      return p->blocks > 0 ? cudaSuccess : cudaErrorInvalidValue;
    });
  });
}

// The element type of a step kernel's cond term and net weights, as a value
template <class T>
struct Elem {
  using type = T;
};

// fn(kernel, Elem<T>) for the step kernel of (c, hid, f32), as a constant, and its
// element type T: bf16 or float
template <class Fn>
cudaError_t with_kernel(int c, int hid, bool f32, Fn fn) {
  return with_hid(hid, [&](auto h) {
    return with_widths(c, [&](auto c1p, auto n3p) {
      constexpr int HID = decltype(h)::value, C1P = decltype(c1p)::value,
                    N3P = decltype(n3p)::value;
      constexpr auto KB = &chain_step_mma_kernel<HID, C1P, N3P>;
      constexpr auto KF = &chain_step_f32_kernel<HID, C1P, N3P>;
      return f32 ? fn(std::integral_constant<decltype(KF), KF>(), Elem<float>())
                 : fn(std::integral_constant<decltype(KB), KB>(), Elem<bf16>());
    });
  });
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// The tile plan of one step at (B,H,W,c), coupling width hid, bf16 (f32 = 0) or
// float32 (f32 = 1) recipe: out = {th, tw, blocks, shared-memory bytes, blocks per SM}.
// Returns a CUDA error.
int hcflow_chain_plan(int B, int H, int W, int c, int hid, int f32, int* out) {
  if (c < 2 || c > 64) return int(cudaErrorInvalidValue);
  Plan p{0, 0, 0, 0};
  cudaError_t err = plan_step(B, H, W, c, hid, f32 != 0, &p);
  if (err != cudaSuccess) return int(err);
  return int(with_kernel(c, hid, f32 != 0, [&](auto k, auto) {
    constexpr auto Kernel = decltype(k)::value;
    cudaError_t e = conv3x3::allow_smem<Kernel>(MAX_SMEM);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, NTHREADS, p.smem);
    out[0] = p.th, out[1] = p.tw, out[2] = p.blocks, out[3] = p.smem, out[4] = per_sm;
    return e;
  }));
}

// Runs the K steps of one chain, k = K-1 .. 0, on the padded pack: bf16 net weights and
// cond term (f32 = 0) or float32 ones (f32 = 1).  zin is not written; the n-th step (n =
// 0 .. K-1) writes buf[n % 2], so the result is in buf[(K-1) % 2].  uc may be null (a
// chain without cond terms).  hid must be 32 or 64 and c 2 .. 64.  Returns the first
// CUDA error.
int hcflow_chain_inverse(const float* zin, float* buf0, float* buf1, const void* uc,
                         const void* w1, const void* w2, const void* w3, const float* vec,
                         const float* wt, const float* ab, int B, int H, int W, int c, int hid,
                         int K, int f32, cudaStream_t stream) {
  if (c < 2 || c > 64 || K < 1 || B < 1 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  Plan p{0, 0, 0, 0};
  cudaError_t err = plan_step(B, H, W, c, hid, f32 != 0, &p);
  if (err != cudaSuccess) return int(err);
  const int c1p = up(c / 2, 8), s = up(c - c / 2, 8);
  const size_t sw1 = size_t(9) * c1p * hid, sw2 = size_t(hid) * hid, sw3 = size_t(9) * hid * 2 * s,
               svec = size_t(4) * hid + 4 * s, es = f32 ? 4 : 2;  // element bytes of w and uc
  const char* cw1 = static_cast<const char*>(w1);
  const char* cw2 = static_cast<const char*>(w2);
  const char* cw3 = static_cast<const char*>(w3);
  const char* cuc = static_cast<const char*>(uc);
  return int(with_kernel(c, hid, f32 != 0, [&](auto k, auto elem) {
    constexpr auto Kernel = decltype(k)::value;
    using T = typename decltype(elem)::type;
    cudaError_t e = conv3x3::allow_smem<Kernel>(MAX_SMEM);
    if (e != cudaSuccess) return e;
    // Each step after the first may launch while the one before it runs (the kernel
    // waits for it before it reads z or uc).  The first launches in stream order, so
    // that no step copies weights that work queued before the chain is still writing.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((W + p.tw - 1) / p.tw, (H + p.th - 1) / p.th, B);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    float* bufs[2] = {buf0, buf1};
    const float* src = zin;
    for (int n = 0; n < K; ++n) {
      const int j = K - 1 - n;
      cfg.numAttrs = n > 0 ? 1 : 0;
      const void* ucj = uc ? cuc + size_t(j) * hid * es : nullptr;
      const void* w1j = cw1 + j * sw1 * es;
      const void* w2j = cw2 + j * sw2 * es;
      const void* w3j = cw3 + j * sw3 * es;
      e = cudaLaunchKernelEx(&cfg, Kernel, src, bufs[n % 2], static_cast<const T*>(ucj), K * hid,
                             static_cast<const T*>(w1j), static_cast<const T*>(w2j),
                             static_cast<const T*>(w3j), vec + j * svec, wt + size_t(j) * c * c,
                             ab + size_t(j) * c, H, W, c, p.th, p.tw);
      if (e != cudaSuccess) return e;
      src = bufs[n % 2];
    }
    return cudaSuccess;
  }));
}

}  // extern "C"
