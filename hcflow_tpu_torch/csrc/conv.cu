// Standalone 3x3 "same" convolution for Hopper (sm_90a): bf16 operands on the tensor
// cores (WMMA 16x16x16), float32 output, an optional bias and an optional fused
// leaky ReLU.
//
// Replaces the TPU kernel hcflow_tpu/ops/pallas_conv.py (_conv3x3_kernel, called by
// conv3x3_pallas), which the JAX package keeps off every path as a tested building
// block; so does the port.
//
// Bound: bytes at the model's shapes, narrowly.  The function reads float32 x and
// writes float32 out, 4 (C + N) bytes per pixel, for 18 C N FLOP: 144 FLOP per byte
// at C 64, N 64 and 231 at C 262, under the card's ~295 FLOP/byte ridge, and 13 at
// C 3.  The conv is conv3x3.cuh's tile conv, as the dense-block kernels run it:
// 8x16-pixel output tiles, input channels staged 32 at a time with a 16-channel
// tail, up to 64 output channels per launch.  So the input is first copied to bf16
// with its channels zero-padded to a multiple of 16 (conv3x3.cuh's to_dense into a
// zeroed buffer: about 4 C more bytes per pixel, written and read back, which this
// first version pays), and the outputs are computed in chunks of at most 64 (the
// wrapper pads N to a multiple of 16 and packs each chunk's weights); the epilogue
// adds the bias and applies the leaky ReLU in float32 and writes only the real
// output channels, once.

#include "conv3x3.cuh"

namespace {

using conv3x3::bf16;
using conv3x3::NTHREADS;

// out[..., n0 + o] = act(conv + bias) for the chunk's o < COUT with n0 + o < N
template <int COUT>
__global__ void __launch_bounds__(NTHREADS)
conv_kernel(const bf16* __restrict__ staged, int cp, const bf16* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int N, int n0, int relu,
            float alpha, int H, int W) {
  __shared__ __align__(128) unsigned char smem[conv3x3::SMEM_BYTES];
  const int x0 = blockIdx.x * conv3x3::TW, y0 = blockIdx.y * conv3x3::TH;
  const float* s_acc = conv3x3::conv_tile<COUT>(smem, staged, cp, cp, w, H, W, x0, y0,
                                                blockIdx.z);
  const int lane = threadIdx.x % 32, gy = y0 + threadIdx.x / 32;
  if (gy >= H) return;
  const size_t row = size_t(blockIdx.z) * H * W + size_t(gy) * W;
  for (int e = lane; e < 16 * COUT; e += 32) {
    const int px = e / COUT, o = e % COUT, gx = x0 + px;
    if (gx >= W || n0 + o >= N) continue;
    float v = s_acc[e];
    if (bias != nullptr) v += bias[n0 + o];
    if (relu) v = v >= 0.f ? v : alpha * v;
    out[(row + gx) * N + n0 + o] = v;
  }
}

template <int COUT>
cudaError_t launch_conv(const bf16* staged, int cp, const bf16* w, const float* bias,
                        float* out, int N, int n0, int relu, float alpha, int B, int H, int W,
                        cudaStream_t stream) {
  conv_kernel<COUT><<<conv3x3::grid(B, H, W), NTHREADS, 0, stream>>>(
      staged, cp, w, bias, out, N, n0, relu, alpha, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// x (B,H,W,C) float32; staged (B,H,W,cp) bf16 scratch, cp = C rounded up to a multiple
// of 16, its channels C .. cp zero; w: host array of ceil(N / 64) device pointers,
// chunk q's weight (9, cp, cout_q) bf16 [tap][ci][co] for outputs 64 q .. 64 q +
// cout_q, cout_q = min(64, np - 64 q) with np = N rounded up to a multiple of 16
// (zero rows and columns for the padding); bias (N) float32 or null; out (B,H,W,N)
// float32.  relu: apply v >= 0 ? v : alpha * v after the bias.  Makes 1 + ceil(N /
// 64) launches; returns the first CUDA error.
int hcflow_conv3x3(const float* x, bf16* staged, const bf16* const* w, const float* bias,
                   float* out, int B, int H, int W, int C, int cp, int N, int relu, float alpha,
                   cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || N < 1 || cp % 16 != 0 || cp < C || cp - C >= 16)
    return int(cudaErrorInvalidValue);
  cudaError_t err = conv3x3::launch_to_dense(x, staged, cp, C, size_t(B) * H * W * C, stream);
  if (err != cudaSuccess) return int(err);
  const int np = (N + 15) / 16 * 16;
  for (int q = 0; 64 * q < np; ++q) {
    const int n0 = 64 * q, cout = np - n0 < 64 ? np - n0 : 64;
    switch (cout) {
      case 16: err = launch_conv<16>(staged, cp, w[q], bias, out, N, n0, relu, alpha, B, H, W,
                                     stream); break;
      case 32: err = launch_conv<32>(staged, cp, w[q], bias, out, N, n0, relu, alpha, B, H, W,
                                     stream); break;
      case 48: err = launch_conv<48>(staged, cp, w[q], bias, out, N, n0, relu, alpha, B, H, W,
                                     stream); break;
      default: err = launch_conv<64>(staged, cp, w[q], bias, out, N, n0, relu, alpha, B, H, W,
                                     stream); break;
    }
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

}  // extern "C"
