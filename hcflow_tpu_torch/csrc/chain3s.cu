// Inverse rescaling main chain (alternating Affine3shift steps with DenseBlock nets)
// for Hopper (sm_90a): one launch per dense-block conv.
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
// must move (z in and out), far above the card's ~295 FLOP/byte ridge.  The TPU
// kernel kept a whole image
// resident for all K steps; on the card that exceeds shared memory and a fused halo
// would grow 5 pixels a step, so each conv is one launch of the shared wgmma tile
// conv (conv3x3.cuh), which recomputes nothing.  Every step owns one NHWC bf16 buffer
// [net input, zero-padded to 16 channels | x1 | x2 | x3 | x4] (the even and the odd
// steps alternate between two buffers, since their inputs differ in width), and
// conv i reads a channel prefix of it.  conv5's epilogue applies the coupling and
// the ActNorm inverse to z in float32 in place (one thread per pixel and channel;
// expf/atanf, no fast math) and writes the next step's net input, in bf16, into the
// other buffer; it needs shift j and scale c2+j together, which wgmma's accumulator
// fragment holds in different threads, so it stages the sums through shared memory
// once (conv3x3.cuh's stage_acc) and keeps the pack as it is.  The features go
// through device memory between launches; fusing a step's five convs is later work.
//
// The float32 recipe (hcflow_chain3s_inverse_f32; the JAX kernel follows compute_dtype,
// at Precision.HIGHEST in float32) runs the same launches on float32 dense buffers and
// features, its convs conv3x3.cuh's conv_tile_f32 (3xTF32 products on wgmma).
//
// Layouts: per step k, w[5k + i] is conv i+1's weight (9, cin_i, cout_i) bf16
// [tap][ci][co] (float32: its TF32 planes (2, 9, cin_i / 4, cout_i, 4)), cin_i = cin_pad + i *
// gc (zero rows for the padding) and conv5's outputs ordered [shift | scale] and
// zero-padded; bias[5k + i] float; an_s, an_b (K, c) float with an_s = exp(-logs).

#include "conv3x3.cuh"

namespace {

using conv3x3::bf16;
using conv3x3::NTHREADS;

// conv5 of a step and its invertible tail, float32, z updated in place; if next, the
// next step's net input (z2 after an even step, z1 after an odd one) goes to
// next[..., j] in bf16.
template <int COUT, int MT, class T>
__global__ void __launch_bounds__(NTHREADS, 2)
coupling_kernel(const T* __restrict__ dense, int ctot, const T* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ z, int c, int even,
                const float* __restrict__ an_s, const float* __restrict__ an_b,
                T* __restrict__ next, int next_ctot, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TW = 8 * MT;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * conv3x3::TH;
  conv3x3::Acc<COUT, MT> acc;
  conv3x3::conv_dense(acc, smem, dense, ctot, ctot, w, H, W, x0, y0, blockIdx.z);
  float* s_acc = reinterpret_cast<float*>(smem);
  __syncthreads();  // both warpgroups' products are done with the ring
  conv3x3::stage_acc(acc, s_acc, H, W, x0, y0, blockIdx.z);
  __syncthreads();
  const int c2 = c - 3;
  for (int e = threadIdx.x; e < conv3x3::TH * TW * c; e += NTHREADS) {
    const int local = e / c, ch = e % c, gy = y0 + local / TW, gx = x0 + local % TW;
    if (gy >= H || gx >= W) continue;
    const float* p = s_acc + local * COUT;
    const size_t pix = (size_t(blockIdx.z) * H + gy) * W + gx;
    float v = z[pix * c + ch];
    if (ch < 3) {
      if (!even) v -= p[ch] + bias[ch];
    } else if (even) {
      const int j = ch - 3;
      const float ls = 0.318f * atanf(2.f * (p[c2 + j] + bias[c2 + j]));
      v = v * expf(-ls) - (p[j] + bias[j]);
    }
    v = v * an_s[ch] - an_b[ch];
    z[pix * c + ch] = v;
    if (next != nullptr && (even ? ch >= 3 : ch < 3))
      conv3x3::store1(next + pix * next_ctot + (even ? ch - 3 : ch), v);
  }
}

template <int COUT, class T>
cudaError_t launch_coupling(const T* dense, int ctot, const T* w, const float* bias, float* z,
                            int c, int even, const float* an_s, const float* an_b, T* next,
                            int next_ctot, int B, int H, int W, cudaStream_t stream) {
  return conv3x3::with_mt(W, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    return conv3x3::launch<coupling_kernel<COUT, MT, T>>(
        conv3x3::grid(B, H, W, MT), conv3x3::smem_for<COUT, T, MT>(), stream, dense, ctot, w, bias,
        z, c, even, an_s, an_b, next, next_ctot, H, W);
  });
}

template <class T>
cudaError_t launch_coupling(int cout, const T* dense, int ctot, const T* w, const float* bias,
                            float* z, int c, int even, const float* an_s, const float* an_b,
                            T* next, int next_ctot, int B, int H, int W, cudaStream_t stream) {
  switch (cout) {
    case 16:
      return launch_coupling<16>(dense, ctot, w, bias, z, c, even, an_s, an_b, next, next_ctot,
                                 B, H, W, stream);
    case 32:
      return launch_coupling<32>(dense, ctot, w, bias, z, c, even, an_s, an_b, next, next_ctot,
                                 B, H, W, stream);
    case 48:
      return launch_coupling<48>(dense, ctot, w, bias, z, c, even, an_s, an_b, next, next_ctot,
                                 B, H, W, stream);
    case 64:
      return launch_coupling<64>(dense, ctot, w, bias, z, c, even, an_s, an_b, next, next_ctot,
                                 B, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

// out = z; first[..., j] = T(z[..., off + j]) for j < n (the first step's net input)
template <class T>
__global__ void prologue_kernel(const float* __restrict__ z, float* __restrict__ out,
                                T* __restrict__ first, int ctot, int c, int off, int n,
                                size_t total) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const float v = z[i];
    out[i] = v;
    const int ch = int(i % c) - off;
    if (ch >= 0 && ch < n) conv3x3::store1(first + (i / c) * ctot + ch, v);
  }
}

bool pad_ok(int padded, int n) { return padded % 16 == 0 && padded >= n && padded - n < 16; }

template <class T>
int chain3s_inverse(const float* z, float* out, T* dense_e, T* dense_o, const T* const* w,
                    const float* const* bias, const float* an_s, const float* an_b, int B, int H,
                    int W, int c, int gc, int K, int cin_e, int cin_o, int sp_e, int sp_o,
                    cudaStream_t stream) {
  const int c2 = c - 3;
  if (B < 1 || H < 1 || W < 1 || K < 1 || c2 < 1 || (gc != 16 && gc != 32 && gc != 64) ||
      !pad_ok(cin_e, 3) || !pad_ok(cin_o, c2) || !pad_ok(sp_e, 2 * c2) || !pad_ok(sp_o, 3))
    return int(cudaErrorInvalidValue);
  const int ctot_e = cin_e + 4 * gc, ctot_o = cin_o + 4 * gc;
  const bool first_even = (K - 1) % 2 == 0;
  const size_t total = size_t(B) * H * W * c;
  const size_t blocks = (total + 255) / 256;
  prologue_kernel<T><<<unsigned(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(
      z, out, first_even ? dense_e : dense_o, first_even ? ctot_e : ctot_o, c,
      first_even ? 0 : 3, first_even ? 3 : c2, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  for (int k = K - 1; k >= 0; --k) {
    const int even = k % 2 == 0;
    T* d = even ? dense_e : dense_o;
    const int ctot = even ? ctot_e : ctot_o, cin = even ? cin_e : cin_o;
    for (int i = 0; i < 4; ++i) {
      err = conv3x3::launch_feature(gc, d, ctot, cin + i * gc, w[5 * k + i], bias[5 * k + i],
                                    cin + i * gc, B, H, W, stream);
      if (err != cudaSuccess) return int(err);
    }
    err = launch_coupling(even ? sp_e : sp_o, d, ctot, w[5 * k + 4], bias[5 * k + 4], out, c,
                          even, an_s + size_t(k) * c, an_b + size_t(k) * c,
                          k > 0 ? (even ? dense_o : dense_e) : nullptr, even ? ctot_o : ctot_e,
                          B, H, W, stream);
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// The K steps of one chain, k = K-1 .. 0.  z (B,H,W,c) float32 is not written; out
// (same shape) receives the result.  dense_e, dense_o: (B,H,W,cin_e + 4 gc) and
// (B,H,W,cin_o + 4 gc) bf16 scratch for the even and the odd steps, zero on entry
// (their padding channels are read and never written).  cin_e, cin_o: the net input
// widths 3 and c-3, padded to multiples of 16; sp_e, sp_o: conv5's widths 2(c-3) and
// 3, padded likewise.  w, bias: host arrays of 5K device pointers (layout above).
// Makes 1 + 5K launches; returns the first CUDA error.
int hcflow_chain3s_inverse(const float* z, float* out, bf16* dense_e, bf16* dense_o,
                           const bf16* const* w, const float* const* bias, const float* an_s,
                           const float* an_b, int B, int H, int W, int c, int gc, int K,
                           int cin_e, int cin_o, int sp_e, int sp_o, cudaStream_t stream) {
  return chain3s_inverse(z, out, dense_e, dense_o, w, bias, an_s, an_b, B, H, W, c, gc, K, cin_e,
                         cin_o, sp_e, sp_o, stream);
}

// The same chain in the float32 recipe (3xTF32 products): float32 dense buffers, the
// weights' TF32 planes (2, 9, cin_i / 4, cout_i, 4).  1 + 5K launches.
int hcflow_chain3s_inverse_f32(const float* z, float* out, float* dense_e, float* dense_o,
                               const float* const* w, const float* const* bias,
                               const float* an_s, const float* an_b, int B, int H, int W, int c,
                               int gc, int K, int cin_e, int cin_o, int sp_e, int sp_o,
                               cudaStream_t stream) {
  return chain3s_inverse(z, out, dense_e, dense_o, w, bias, an_s, an_b, B, H, W, c, gc, K, cin_e,
                         cin_o, sp_e, sp_o, stream);
}

}  // extern "C"
