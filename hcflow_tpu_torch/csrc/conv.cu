// Standalone 3x3 "same" convolution for Hopper (sm_90a): bf16 operands on the
// warpgroup tensor cores (wgmma), float32 output, an optional bias and an optional
// fused leaky ReLU.
//
// Replaces the TPU kernel hcflow_tpu/ops/pallas_conv.py (_conv3x3_kernel, called by
// conv3x3_pallas), which the JAX package keeps off every path as a tested building
// block; so does the port.
//
// Bound: bytes at the model's shapes, narrowly.  The function reads float32 x and
// writes float32 out, 4 (C + N) bytes per pixel, for 18 C N FLOP: 144 FLOP per byte
// at C 64, N 64 and 231 at C 262, under the card's ~295 FLOP/byte ridge, and 13 at
// C 3.  The conv is conv3x3.cuh's wgmma tile conv, as the dense-block kernels run
// it: 16x16 or 8x16-pixel output tiles of two warpgroups, a 3-stage ring of
// 16-channel chunks, up to 64 output channels per launch.  It reads x itself, in
// float32, rounding each chunk to bf16 as it stages it (channels from C on are zero),
// so x is read once and no bf16 copy of it is written and read back.  One small
// launch first packs the float32 HWIO weights into bf16 chunks of at most 64
// outputs, N zero-padded to a multiple of 16; the caller's work per call is then a
// few allocations (at the model's shapes the host, not the card, bounded the first
// version's calls); the epilogue adds the bias and applies the leaky ReLU in float32,
// from the accumulator registers, and writes only the real output channels, once.

#include "conv3x3.cuh"

namespace {

using conv3x3::bf16;
using conv3x3::NTHREADS;

// out[..., n0 + o] = act(conv + bias) for the chunk's o < COUT with n0 + o < N; w holds
// the chunk's weights.
template <int COUT, int MT>
__global__ void __launch_bounds__(NTHREADS, 2)
conv_kernel(const float* __restrict__ x, int C, int cp, const bf16* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int N, int n0, int relu,
            float alpha, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int x0 = blockIdx.x * 8 * MT, y0 = blockIdx.y * conv3x3::TH;
  conv3x3::Acc<COUT, MT> acc;
  conv3x3::conv_tile(acc, smem, x, C, cp, w, H, W, x0, y0, blockIdx.z);
  conv3x3::for_each_pair(acc, H, W, x0, y0, blockIdx.z,
                               [&](size_t pix, int, int o, float v0, float v1) {
                                 const float v2[2] = {v0, v1};
#pragma unroll
                                 for (int i = 0; i < 2; ++i) {
                                   const int n = n0 + o + i;
                                   if (n >= N) continue;
                                   float v = v2[i];
                                   if (bias != nullptr) v += bias[n];
                                   if (relu) v = v >= 0.f ? v : alpha * v;
                                   out[pix * N + n] = v;
                                 }
                               });
}

struct ConvArgs {
  const float* x;
  int C, cp;
  const bf16* w;  // the chunk's weights
  const float* bias;
  float* out;
  int N, n0, relu;
  float alpha;
  int B, H, W;
};

template <int COUT>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  return conv3x3::with_mt(a.W, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    return conv3x3::launch<conv_kernel<COUT, MT>>(
        conv3x3::grid(a.B, a.H, a.W, MT), conv3x3::smem_bytes<COUT>(), stream, a.x, a.C, a.cp,
        a.w, a.bias, a.out, a.N, a.n0, a.relu, a.alpha, a.H, a.W);
  });
}

// wpack = the weights in bf16 chunks, 9 cp np elements: chunk q (9, cp, cq)
// [tap][ci][co] at 9 cp 64 q for outputs 64 q .. 64 q + cq, cq = min(64, np - 64 q),
// zero outside C x N.
__global__ void pack_kernel(const float* __restrict__ w, bf16* __restrict__ wpack, int C, int cp,
                            int N, int np) {
  const size_t nw = size_t(9) * cp * np, chunk = size_t(9) * cp * 64;
  for (size_t j = size_t(blockIdx.x) * blockDim.x + threadIdx.x; j < nw;
       j += size_t(gridDim.x) * blockDim.x) {
    const int q = int(j / chunk), r = int(j % chunk);
    const int cq = np - 64 * q < 64 ? np - 64 * q : 64;
    const int tap = r / (cp * cq), ci = r % (cp * cq) / cq, n = 64 * q + r % cq;
    wpack[j] = __float2bfloat16(ci < C && n < N ? w[(size_t(tap) * C + ci) * N + n] : 0.f);
  }
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// x (B,H,W,C) float32, 16-byte aligned; w (3,3,C,N) float32 HWIO; wpack (9 cp np)
// bf16 scratch, cp and np = C and N rounded up to multiples of 16; bias (N) float32
// or null; out (B,H,W,N) float32.  relu: apply v >= 0 ? v : alpha * v after the
// bias.  Makes 1 + ceil(N / 64) launches (the weight pack, then one per chunk of 64
// outputs); returns the first CUDA error.
int hcflow_conv3x3(const float* x, const float* w, bf16* wpack, const float* bias, float* out,
                   int B, int H, int W, int C, int N, int relu, float alpha,
                   cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || N < 1) return int(cudaErrorInvalidValue);
  const int cp = (C + 15) / 16 * 16, np = (N + 15) / 16 * 16;
  const size_t blocks = (size_t(9) * cp * np + 255) / 256;
  pack_kernel<<<unsigned(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(w, wpack, C, cp, N,
                                                                            np);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  for (int q = 0; 64 * q < np; ++q) {
    const int n0 = 64 * q, cout = np - n0 < 64 ? np - n0 : 64;
    const ConvArgs a{x, C, cp, wpack + size_t(9) * cp * n0, bias, out, N, n0, relu, alpha,
                     B, H, W};
    switch (cout) {
      case 16: err = launch_conv<16>(a, stream); break;
      case 32: err = launch_conv<32>(a, stream); break;
      case 48: err = launch_conv<48>(a, stream); break;
      default: err = launch_conv<64>(a, stream); break;
    }
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

}  // extern "C"
