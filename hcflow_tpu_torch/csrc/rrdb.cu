// One RRDB (3 residual dense blocks) for Hopper (sm_90a), as 3x3 convolutions on
// bf16 tensor cores (WMMA 16x16x16, float32 accumulation).
//
// Replaces the TPU kernel hcflow_tpu/ops/pallas_rdb.py (_make_kernel, called by
// rrdb_apply).  Per dense block, with x the block input:
//   x_i = lrelu_0.2(conv_i(cat(x, x_1 .. x_{i-1})) + b_i)      i = 1..4  (bf16 features)
//   x   = 0.2 * (conv_5(cat(x, x_1 .. x_4)) + b_5) + x              (float32 carry)
// and after the third block  out = 0.2 * x + x_rrdb_in.
//
// Bound: operations.  At nf 64 / gc 32 a dense block is 239,616 MAC per pixel
// against a few hundred bytes of activations, far above the card's ~295 FLOP/byte
// ridge, so the design's job is to feed the tensor cores.  The concats cost
// nothing: every dense block owns one NHWC bf16 buffer (B,H,W,nf+4gc) and each conv
// reads a channel prefix of it and writes its output into the next channel slice.
// Each conv is one launch (5 per block: a conv needs all of its predecessor's
// output, halos included).  A block of 8 warps computes an 8x16-pixel output tile:
// per 32-channel chunk of the input it stages the tile with a 1-pixel halo and the
// chunk's 9 taps of weights in shared memory, then each warp runs the 9 taps' WMMA
// products for its 16-pixel row.  The residual carries stay float32 in device
// memory; conv5's epilogue updates the carry in place (each element is read and
// written by one thread) and writes its bf16 copy into the next block's buffer (a
// second buffer, since neighbouring tiles still read this one).  Staging is not yet
// pipelined and the products are WMMA, not wgmma, which holds this first version far
// below the bound (PERF.md); cp.async/TMA rings, wgmma and a resident trunk are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TH = 8, TW = 16;             // output tile: one 16-pixel row per warp
constexpr int NWARPS = TH, NTHREADS = 32 * NWARPS;
constexpr int CK = 32;                     // input channels staged per chunk
constexpr int IH = TH + 2, IW = TW + 2;    // staged input tile with its 1-pixel halo
constexpr int MAX_COUT = 64;
constexpr int IN_ELEMS = IH * IW * CK;
constexpr int W_ELEMS = 9 * CK * MAX_COUT;
constexpr int SMEM_BYTES = (IN_ELEMS + W_ELEMS) * 2;
static_assert(NWARPS * 16 * MAX_COUT * 4 <= SMEM_BYTES, "epilogue staging must fit");

// dense (B,H,W,ctot) bf16; reads channels [0, cin); w (9, cin, COUT) bf16; bias float.
// conv1..4 (xout == nullptr): dense[..., out_off + o] = bf16(lrelu(acc + b)).
// conv5    (xout != nullptr): x = 0.2 * (acc + b) + xres; then, if xrrdb, x = 0.2 * x +
//          xrrdb; xout = x and, if next, next[..., o] = bf16(x).  xres, xout and xrrdb
//          are (B,H,W,COUT) float; xres may be xout (each element is read and written
//          by the same thread).
template <int COUT>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(bf16* __restrict__ dense, int ctot, int cin, const bf16* __restrict__ w,
               const float* __restrict__ bias, int out_off, const float* xres, float* xout,
               const float* __restrict__ xrrdb, bf16* __restrict__ next, int H, int W) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_in + IN_ELEMS;
  constexpr int NFRAG = COUT / 16;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const size_t img = size_t(b) * H * W;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFRAG];
#pragma unroll
  for (int n = 0; n < NFRAG; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();  // the previous chunk's operands are consumed
    // input tile + halo, 8 channels (16 bytes) per copy; zero outside the image
    for (int i = threadIdx.x; i < IH * IW * (CK / 8); i += NTHREADS) {
      const int part = i % (CK / 8), q = i / (CK / 8);
      const int gy = y0 - 1 + q / IW, gx = x0 - 1 + q % IW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(dense + (img + size_t(gy) * W + gx) * ctot + c0 +
                                            part * 8);
      *reinterpret_cast<uint4*>(s_in + q * CK + part * 8) = v;
    }
    // the chunk's weights: 9 taps x CK input channels x COUT, [tap][ci][co]
    for (int i = threadIdx.x; i < 9 * CK * COUT / 8; i += NTHREADS) {
      const int e = i * 8, tap = e / (CK * COUT), r = e % (CK * COUT);
      *reinterpret_cast<uint4*>(s_w + e) =
          *reinterpret_cast<const uint4*>(w + (size_t(tap) * cin + c0) * COUT + r);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, s_in + ((warp + dy) * IW + dx) * CK + kk, CK);
#pragma unroll
        for (int n = 0; n < NFRAG; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, s_w + (tap * CK + kk) * COUT + n * 16, COUT);
          wmma::mma_sync(acc[n], a, bfr, acc[n]);
        }
      }
    }
  }

  // epilogue: stage each warp's 16 x COUT sums, then one thread per element
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem) + warp * 16 * COUT;
#pragma unroll
  for (int n = 0; n < NFRAG; ++n)
    wmma::store_matrix_sync(s_acc + n * 16, acc[n], COUT, wmma::mem_row_major);
  __syncwarp();
  const int gy = y0 + warp;
  if (gy >= H) return;
  for (int e = lane; e < 16 * COUT; e += 32) {
    const int px = e / COUT, o = e % COUT, gx = x0 + px;
    if (gx >= W) continue;
    const size_t pix = img + size_t(gy) * W + gx;
    const float v = s_acc[e] + bias[o];
    if (xout == nullptr) {
      dense[pix * ctot + out_off + o] = __float2bfloat16(v > 0.f ? v : 0.2f * v);
    } else {
      float x = fmaf(v, 0.2f, xres[pix * COUT + o]);
      if (xrrdb != nullptr) x = fmaf(x, 0.2f, xrrdb[pix * COUT + o]);
      xout[pix * COUT + o] = x;
      if (next != nullptr) next[pix * ctot + o] = __float2bfloat16(x);
    }
  }
}

// dense[..., c] = bf16(x[..., c]) for c < nf
__global__ void to_dense_kernel(const float* __restrict__ x, bf16* __restrict__ dense, int ctot,
                                int nf, size_t n) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x)
    dense[(i / nf) * ctot + i % nf] = __float2bfloat16(x[i]);
}

struct Conv {
  bf16* dense;
  int ctot, cin;
  const bf16* w;
  const float* bias;
  int out_off;
  const float* xres;
  float* xout;
  const float* xrrdb;
  bf16* next;
};

template <int COUT>
cudaError_t launch(const Conv& a, int B, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv3x3_kernel<COUT><<<grid, NTHREADS, 0, stream>>>(a.dense, a.ctot, a.cin, a.w, a.bias,
                                                      a.out_off, a.xres, a.xout, a.xrrdb,
                                                      a.next, H, W);
  return cudaGetLastError();
}

cudaError_t launch(int cout, const Conv& a, int B, int H, int W, cudaStream_t stream) {
  switch (cout) {
    case 32: return launch<32>(a, B, H, W, stream);
    case 64: return launch<64>(a, B, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// One RRDB.  x, out: (B,H,W,nf) float32, distinct; dense0, dense1: (B,H,W,nf+4gc) bf16
// scratch.  w[r*5 + i], bias[r*5 + i] (arrays of 15 device pointers, in host memory):
// dense block r's conv i+1, weight (9, cin_i, cout_i) bf16, bias float.  Makes 16
// launches (one conversion, 15 convs); returns the first CUDA error.
int hcflow_rrdb_apply(const float* x, float* out, bf16* dense0, bf16* dense1,
                      const bf16* const* w, const float* const* bias, int B, int H, int W,
                      int nf, int gc, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || nf % CK || gc % CK || nf > MAX_COUT || gc > MAX_COUT)
    return int(cudaErrorInvalidValue);
  const int ctot = nf + 4 * gc;
  const size_t n = size_t(B) * H * W * nf;
  const size_t blocks = (n + 255) / 256;
  to_dense_kernel<<<unsigned(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(x, dense0, ctot,
                                                                                 nf, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bf16* dense[2] = {dense0, dense1};
  for (int r = 0; r < 3; ++r) {
    bf16* d = dense[r % 2];
    for (int i = 0; i < 4; ++i) {
      const Conv a{d, ctot, nf + i * gc, w[r * 5 + i], bias[r * 5 + i], nf + i * gc,
                   nullptr, nullptr, nullptr, nullptr};
      if ((err = launch(gc, a, B, H, W, stream)) != cudaSuccess) return int(err);
    }
    // conv5: the carry starts from the RRDB input and is then updated in place in out
    const Conv a{d, ctot, ctot, w[r * 5 + 4], bias[r * 5 + 4], 0, r == 0 ? x : out, out,
                 r == 2 ? x : nullptr, r == 2 ? nullptr : dense[(r + 1) % 2]};
    if ((err = launch(nf, a, B, H, W, stream)) != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

}  // extern "C"
