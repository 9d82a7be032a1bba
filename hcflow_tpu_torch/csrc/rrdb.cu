// One RRDB (3 residual dense blocks) for Hopper (sm_90a), as 3x3 convolutions on
// the tensor cores: wgmma bf16 in the bf16 recipe, 3xTF32 wgmma in the float32 one
// (float32 accumulation in both).
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
// Each conv is one launch of conv3x3.cuh's tile conv (5 per block: a conv needs all
// of its predecessor's output, halos included): wgmma products fed by a 3-stage
// cp.async ring of 16-channel chunks (so gc 16 works too), 16x16 or 8x16-pixel tiles
// of two warpgroups, epilogues from the accumulator registers.  The residual carries
// stay float32 in device memory; conv5's epilogue updates the carry in place (each
// element is read and written by one thread) and writes its bf16 copy into the next
// block's buffer (a second buffer, since neighbouring tiles still read this one).
// rrdb_trunk.cu runs a whole trunk of these RRDBs in one launch.
//
// The float32 recipe (hcflow_rrdb_apply_f32; the JAX kernel runs it at
// Precision.HIGHEST) keeps the same launches with float32 dense buffers and features
// (no rounding), the products of conv3x3.cuh's float32 tile convs: TF32 on wgmma, each
// operand split once (the weights at pack time), an error of float32's order.  Every
// conv of 32 or 64 outputs (the gc-32 feature convs, every conv5 at nf 32 and 64) runs
// the wide one, output channels x pixels (conv_tile_f32w); the gc-16 feature convs the
// narrow one, pixels x output channels (conv_tile_f32), where [W hi; W lo] would fill
// half of wgmma's 64 rows; hcflow_rrdb_f32_wide exports that rule.  Bound: operations,
// at the float32 rates: 2.58 TFLOP an x4 pass is 38.5 ms at the 67 TFLOP/s of float32
// outside the tensor cores, and 18.5 ms at the 140 TFLOP/s that the TF32 products leave
// of the 495 TF32 peak (three a product at COUT 64 and 16, four at COUT 32: 3.54 on
// average at nf 64 / gc 32, so a roofline share of the work at 495 TFLOP/s is ~28% at
// most).  Measured: the wide conv took 8% off an RRDB there; what is left is set about a
// third by the products and a sixth by the weights' copies (PERF.md).

#include "conv3x3.cuh"

namespace {

using conv3x3::bf16;
using conv3x3::NTHREADS;

// conv5 of a dense block (conv3x3.cuh's residual_store): x = 0.2 * (conv + b) + xres;
// then, if xrrdb, x = 0.2 * x + xrrdb; xout = x and, if next, next[..., o] = T(x).
template <int COUT, int MT, class T>
__global__ void __launch_bounds__(NTHREADS, 2)
residual_kernel(const T* __restrict__ dense, int ctot, const T* __restrict__ w,
                const float* __restrict__ bias, const float* xres, float* xout,
                const float* xrrdb, T* __restrict__ next, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int x0 = blockIdx.x * 8 * MT, y0 = blockIdx.y * conv3x3::TH;
  conv3x3::residual_tile<COUT, MT>(smem, dense, ctot, w, bias, xres, xout, xrrdb, next, H, W, x0,
                                   y0, blockIdx.z);
}

template <int COUT, class T>
cudaError_t launch_residual(const T* dense, int ctot, const T* w, const float* bias,
                            const float* xres, float* xout, const float* xrrdb, T* next,
                            int B, int H, int W, cudaStream_t stream) {
  return conv3x3::with_mt(W, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    return conv3x3::launch<residual_kernel<COUT, MT, T>>(
        conv3x3::grid(B, H, W, MT), conv3x3::smem_for<COUT, T, MT>(), stream, dense, ctot, w, bias,
        xres, xout, xrrdb, next, H, W);
  });
}

template <class T>
cudaError_t launch_residual(int nf, const T* dense, int ctot, const T* w, const float* bias,
                            const float* xres, float* xout, const float* xrrdb, T* next, int B,
                            int H, int W, cudaStream_t stream) {
  switch (nf) {
    case 16:
      return launch_residual<16>(dense, ctot, w, bias, xres, xout, xrrdb, next, B, H, W,
                                  stream);
    case 32:
      return launch_residual<32>(dense, ctot, w, bias, xres, xout, xrrdb, next, B, H, W,
                                  stream);
    case 64:
      return launch_residual<64>(dense, ctot, w, bias, xres, xout, xrrdb, next, B, H, W,
                                  stream);
    default: return cudaErrorInvalidValue;
  }
}

bool width_ok(int c) { return c == 16 || c == 32 || c == 64; }

// One RRDB with dense buffers and weights of T (the C entry points below)
template <class T>
int rrdb_apply(const float* x, float* out, T* dense0, T* dense1, const T* const* w,
               const float* const* bias, int B, int H, int W, int nf, int gc,
               cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || !width_ok(nf) || !width_ok(gc))
    return int(cudaErrorInvalidValue);
  const int ctot = nf + 4 * gc;
  cudaError_t err = conv3x3::launch_to_dense(x, dense0, ctot, nf, size_t(B) * H * W * nf, stream);
  if (err != cudaSuccess) return int(err);
  T* dense[2] = {dense0, dense1};
  for (int r = 0; r < 3; ++r) {
    T* d = dense[r % 2];
    for (int i = 0; i < 4; ++i) {
      err = conv3x3::launch_feature(gc, d, ctot, nf + i * gc, w[r * 5 + i], bias[r * 5 + i],
                                    nf + i * gc, B, H, W, stream);
      if (err != cudaSuccess) return int(err);
    }
    // conv5: the carry starts from the RRDB input and is then updated in place in out
    err = launch_residual(nf, d, ctot, w[r * 5 + 4], bias[r * 5 + 4], r == 0 ? x : out, out,
                          r == 2 ? x : nullptr, r == 2 ? nullptr : dense[(r + 1) % 2], B, H, W,
                          stream);
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// One RRDB, bf16 recipe.  x, out: (B,H,W,nf) float32, distinct; dense0, dense1:
// (B,H,W,nf+4gc) bf16 scratch.  w[r*5 + i], bias[r*5 + i] (arrays of 15 device pointers,
// in host memory): dense block r's conv i+1, weight (9, cin_i, cout_i) bf16 [tap][ci][co],
// bias float.  nf and gc are each 16, 32 or 64.  Makes 16 launches (one conversion, 15
// convs); returns the first CUDA error.
int hcflow_rrdb_apply(const float* x, float* out, bf16* dense0, bf16* dense1,
                      const bf16* const* w, const float* const* bias, int B, int H, int W,
                      int nf, int gc, cudaStream_t stream) {
  return rrdb_apply(x, out, dense0, dense1, w, bias, B, H, W, nf, gc, stream);
}

// One RRDB, float32 recipe (3xTF32 products): as hcflow_rrdb_apply with float32 dense
// buffers, w[r*5 + i] the weight's TF32 planes (2, 9, cin_i / 4, cout_i, 4)
// (nets.pack_tf32: [hi, lo][tap][ci / 4][co][ci % 4]).  16 launches.
int hcflow_rrdb_apply_f32(const float* x, float* out, float* dense0, float* dense1,
                          const float* const* w, const float* const* bias, int B, int H, int W,
                          int nf, int gc, cudaStream_t stream) {
  return rrdb_apply(x, out, dense0, dense1, w, bias, B, H, W, nf, gc, stream);
}

// 1 where the float32 recipe's conv of cout outputs runs the wide tile conv (output
// channels x pixels), 0 where the narrow one (pixels x output channels): the rule the
// kernels dispatch on (conv3x3::wide_f32), for the wrapper's counts.
int hcflow_rrdb_f32_wide(int cout) { return conv3x3::wide_f32(cout); }

}  // extern "C"
