// Tiled 3x3 "same" convolution on bf16 tensor cores (WMMA 16x16x16, float32 sums),
// with the bf16 staging conversion and the dense-block epilogues, shared by rrdb.cu,
// rrdb_trunk.cu, chain3s.cu and conv.cu.
//
// Both kernels keep a dense block's concats free: the block owns one NHWC bf16
// buffer (B,H,W,ctot) holding [input | x1 | x2 | x3 | x4], and conv i reads a channel
// prefix of it.  A block of 8 warps computes an 8x16-pixel output tile: per chunk of
// the input channels (32, or a 16-channel tail) it stages the tile with its 1-pixel
// halo and the chunk's 9 taps of weights in shared memory, then each warp runs the
// 9 taps' WMMA products for its 16-pixel row.  conv_tile leaves each warp's 16 x
// COUT sums in shared memory for the caller's epilogue.  The tile's position is an
// argument, so a kernel may take it from blockIdx or loop over tiles (a persistent
// kernel); the epilogues below are shared the same way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace conv3x3 {
namespace {  // internal linkage: each kernel library has its own copy

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TH = 8, TW = 16;             // output tile: one 16-pixel row per warp
constexpr int NWARPS = TH, NTHREADS = 32 * NWARPS;
constexpr int CK = 32;                     // input channels staged per chunk (at most)
constexpr int IH = TH + 2, IW = TW + 2;    // staged input tile with its 1-pixel halo
constexpr int MAX_COUT = 64;
constexpr int IN_ELEMS = IH * IW * CK;
constexpr int W_ELEMS = 9 * CK * MAX_COUT;
constexpr int SMEM_BYTES = (IN_ELEMS + W_ELEMS) * 2;
static_assert(NWARPS * 16 * MAX_COUT * 4 <= SMEM_BYTES, "epilogue staging must fit");

dim3 grid(int B, int H, int W) { return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B); }

// dense[p, c] = bf16(x[p, c]) for the n = pixels * C values of x (C channels) into
// dense (ctot channels; its others are not written), grid-stride over the caller's grid.
__device__ __forceinline__ void to_dense(const float* __restrict__ x, bf16* __restrict__ dense,
                                         int ctot, int C, size_t n) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x)
    dense[(i / C) * ctot + i % C] = __float2bfloat16(x[i]);
}

__global__ void to_dense_kernel(const float* __restrict__ x, bf16* __restrict__ dense, int ctot,
                                int C, size_t n) {
  to_dense(x, dense, ctot, C, n);
}

cudaError_t launch_to_dense(const float* x, bf16* dense, int ctot, int C, size_t n,
                            cudaStream_t stream) {
  const size_t blocks = (n + 255) / 256;
  to_dense_kernel<<<unsigned(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(x, dense, ctot,
                                                                                 C, n);
  return cudaGetLastError();
}

// The conv of the tile at (x0, y0) of image `image`: dense (B,H,W,ctot) bf16,
// channels [0, cin) read (cin a multiple of 16); w (9, cin, COUT) bf16 [tap][ci][co].
// Returns this warp's sums, s_acc[px * COUT + o] for the 16 pixels of output row
// y0 + warp, in smem (which must hold SMEM_BYTES).  COHERENT reads dense through L2
// only (ld.global.cg): a persistent kernel reads there what other blocks wrote during
// the same launch, which the read-only path may not see.
template <int COUT, bool COHERENT = false>
__device__ __forceinline__ const float* conv_tile(unsigned char* smem,
                                                  const bf16* __restrict__ dense,
                                                  int ctot, int cin, const bf16* __restrict__ w,
                                                  int H, int W, int x0, int y0, int image) {
  static_assert(COUT % 16 == 0 && COUT <= MAX_COUT, "COUT must be 16, 32, 48 or 64");
  constexpr int NFRAG = COUT / 16;
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_in + IN_ELEMS;
  const int warp = threadIdx.x / 32;
  const size_t img = size_t(image) * H * W;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFRAG];
#pragma unroll
  for (int n = 0; n < NFRAG; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int c0 = 0; c0 < cin; c0 += CK) {
    const int ck = cin - c0 < CK ? cin - c0 : CK;  // 32, or a 16-channel tail
    __syncthreads();  // the previous chunk's operands are consumed
    // input tile + halo, 8 channels (16 bytes) per copy; zero outside the image
    for (int i = threadIdx.x; i < IH * IW * (ck / 8); i += NTHREADS) {
      const int part = i % (ck / 8), q = i / (ck / 8);
      const int gy = y0 - 1 + q / IW, gx = x0 - 1 + q % IW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint4* src = reinterpret_cast<const uint4*>(
            dense + (img + size_t(gy) * W + gx) * ctot + c0 + part * 8);
        v = COHERENT ? __ldcg(src) : *src;
      }
      *reinterpret_cast<uint4*>(s_in + q * ck + part * 8) = v;
    }
    // the chunk's weights: 9 taps x ck input channels x COUT, [tap][ci][co]
    for (int i = threadIdx.x; i < 9 * ck * COUT / 8; i += NTHREADS) {
      const int e = i * 8, tap = e / (ck * COUT), r = e % (ck * COUT);
      *reinterpret_cast<uint4*>(s_w + e) =
          *reinterpret_cast<const uint4*>(w + (size_t(tap) * cin + c0) * COUT + r);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        if (kk >= ck) break;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, s_in + ((warp + dy) * IW + dx) * ck + kk, ck);
#pragma unroll
        for (int n = 0; n < NFRAG; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, s_w + (tap * ck + kk) * COUT + n * 16, COUT);
          wmma::mma_sync(acc[n], a, bfr, acc[n]);
        }
      }
    }
  }

  // stage each warp's 16 x COUT sums for the epilogue
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem) + warp * 16 * COUT;
#pragma unroll
  for (int n = 0; n < NFRAG; ++n)
    wmma::store_matrix_sync(s_acc + n * 16, acc[n], COUT, wmma::mem_row_major);
  __syncwarp();
  return s_acc;
}

// A dense-block feature conv's epilogue for the tile at (x0, y0) of image `image`:
// dense[..., out_off + o] = bf16(lrelu_0.2(conv + bias)).
template <int COUT>
__device__ __forceinline__ void feature_store(const float* s_acc, bf16* dense, int ctot,
                                              const float* __restrict__ bias, int out_off,
                                              int H, int W, int x0, int y0, int image) {
  const int lane = threadIdx.x % 32, gy = y0 + threadIdx.x / 32;
  if (gy >= H) return;
  const size_t row = size_t(image) * H * W + size_t(gy) * W;
  for (int e = lane; e < 16 * COUT; e += 32) {
    const int px = e / COUT, o = e % COUT, gx = x0 + px;
    if (gx >= W) continue;
    const float v = s_acc[e] + bias[o];
    dense[(row + gx) * ctot + out_off + o] = __float2bfloat16(v > 0.f ? v : 0.2f * v);
  }
}

// A dense block's conv5 epilogue (rrdb.cu, rrdb_trunk.cu): x = 0.2 * (conv + b) +
// xres; then, if xrrdb, x = 0.2 * x + xrrdb; xout = x and, if next, next[..., o] =
// bf16(x) (next has ctot channels).  xres, xout and xrrdb are (B,H,W,COUT) float and
// may alias one another: each element is read and then written by the same thread.
template <int COUT>
__device__ __forceinline__ void residual_store(const float* s_acc, int ctot,
                                               const float* __restrict__ bias,
                                               const float* xres, float* xout,
                                               const float* xrrdb, bf16* next, int H, int W,
                                               int x0, int y0, int image) {
  const int lane = threadIdx.x % 32, gy = y0 + threadIdx.x / 32;
  if (gy >= H) return;
  const size_t row = size_t(image) * H * W + size_t(gy) * W;
  for (int e = lane; e < 16 * COUT; e += 32) {
    const int px = e / COUT, o = e % COUT, gx = x0 + px;
    if (gx >= W) continue;
    const size_t pix = row + gx;
    float x = fmaf(s_acc[e] + bias[o], 0.2f, xres[pix * COUT + o]);
    if (xrrdb != nullptr) x = fmaf(x, 0.2f, xrrdb[pix * COUT + o]);
    xout[pix * COUT + o] = x;
    if (next != nullptr) next[pix * ctot + o] = __float2bfloat16(x);
  }
}

// A dense-block feature conv: dense[..., out_off + o] = bf16(lrelu_0.2(conv + bias)).
template <int COUT>
__global__ void __launch_bounds__(NTHREADS)
feature_kernel(bf16* __restrict__ dense, int ctot, int cin, const bf16* __restrict__ w,
               const float* __restrict__ bias, int out_off, int H, int W) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const float* s_acc = conv_tile<COUT>(smem, dense, ctot, cin, w, H, W, x0, y0, blockIdx.z);
  feature_store<COUT>(s_acc, dense, ctot, bias, out_off, H, W, x0, y0, blockIdx.z);
}

template <int COUT>
cudaError_t launch_feature(bf16* dense, int ctot, int cin, const bf16* w, const float* bias,
                           int out_off, int B, int H, int W, cudaStream_t stream) {
  feature_kernel<COUT><<<grid(B, H, W), NTHREADS, 0, stream>>>(dense, ctot, cin, w, bias,
                                                               out_off, H, W);
  return cudaGetLastError();
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
