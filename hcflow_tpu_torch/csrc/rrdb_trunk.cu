// A whole RRDB trunk (nb RRDBs of 3 residual dense blocks) in one cooperative launch
// for Hopper (sm_90a), on the tensor cores (wgmma bf16 in the bf16 recipe, 3xTF32
// wgmma in the float32 one; float32 accumulation in both).
//
// Replaces the TPU kernel hcflow_tpu/ops/pallas_rdb.py (_make_kernel_trunk, called
// through _build_call_trunk by trunk_apply when the JAX package packs the trunk as one
// stacked dict, HCFLOW_RDB_TRUNK=1).  It computes what rrdb.cu computes nb times in a
// row (the same dense blocks, the same float32 carries), in one launch per trunk.
//
// Bound: operations.  At nf 64 / gc 32 an RRDB is 718,848 MAC per pixel against the
// 512 bytes per pixel the trunk must move (its float32 input and output), so the
// least time is the tensor cores' (~2 ms for the six trunks of an x8 pass at batch
// 16).  What the TPU kernel kept on chip, a whole image's carries, does not fit in
// an SM's 227 KB of shared memory at 80x80, and a halo fused over a trunk's 15 nb
// convs would be far too wide.  So this is a persistent kernel: a grid of at most as
// many blocks as can be co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs; no more than a stage has tiles), each looping over the output tiles of one
// conv stage (conv3x3.cuh's wgmma tile conv with its cp.async ring and its
// epilogues, with the same tiles as rrdb.cu), then waiting at a grid-wide barrier
// before the next stage: one stage converts the input to bf16, then 15 per RRDB.
// At 2 blocks/SM (up to 99.3 KB of shared memory and 128 registers each) the trunk holds
// its own loop state across every conv, which the per-conv kernels do not: ptxas spills
// 24-376 bytes in the bf16 recipe; the float32 convs roll their copy loops up (LEAN),
// which left 0-216 bytes (0 at nf 64, gc 32; unrolled, up to 380 bytes; PERF.md).
// 8-wide tiles at 80x80 took 30% longer in bf16 (PERF.md).  The
// state stays in device memory, allocated once per call: the float32 carry, the
// float32 RRDB base (the output buffer: each RRDB's third conv5 writes 0.2 x + base
// there, the next RRDB's input) and two bf16 dense buffers; each RRDB's last conv5
// writes the next RRDB's bf16 input directly, so no conversion pass runs between
// RRDBs.  The epilogues' fmaf order is rrdb.cu's, so the output is bit-identical to
// the per-RRDB kernel's.  The tile conv's cp.async.cg copies read the dense buffers
// through L2 only: other blocks wrote them earlier in the same launch (the writes are
// ordinary stores and the copies are not in the async proxy, so grid.sync() orders
// them without a proxy fence).  Not carried over from the TPU kernel: its
// scatter-by-source layout and its bf16 RRDB base (_FIT16), VMEM workarounds.
//
// The float32 recipe (hcflow_rrdb_trunk_apply_f32) is the same kernel on float32 dense
// buffers and the weights' TF32 planes, its convs conv3x3.cuh's float32 tile convs (wide
// at 32 and 64 outputs, narrow at 16, as rrdb.cu's), bit-identical to the float32
// per-RRDB kernel as the bf16 one is to its own, 2 blocks/SM.
//
// Layouts: x, out, carry (B,H,W,nf) float32; dense0, dense1 (B,H,W,nf+4gc) bf16
// (float32); w[i] (3nb, 9, nf+i*gc, cout_i) bf16 [block][tap][ci][co] (float32: the TF32
// planes (3nb, 2, 9, (nf+i*gc) / 4, cout_i, 4)), cout_i = gc for i < 4 and nf for i = 4; b[i]
// (3nb, cout_i) float32; dense block j = 3 * rrdb + r.

#include <cooperative_groups.h>

#include "conv3x3.cuh"

namespace cg = cooperative_groups;

namespace {

using conv3x3::bf16;
using conv3x3::NTHREADS;
using conv3x3::TH;

// T: the dense buffers' and weights' type, bf16 or float (the float32 recipe)
template <class T>
struct TrunkArgs {
  const float* x;  // the trunk's input, not written
  float* out;      // the RRDB base, then the trunk's output
  float* carry;    // the dense block's float32 carry
  T* dense[2];     // dense block j works in dense[j % 2]
  const T* w[5];   // conv i+1 of every dense block
  const float* b[5];
  int B, H, W, nb;
};

template <int NF, int GC, class T, int MT>
constexpr int trunk_smem() {
  constexpr int gc = conv3x3::smem_for<GC, T, MT>(), nf = conv3x3::smem_for<NF, T, MT>();
  return gc > nf ? gc : nf;
}

// MT: 8x8 sub-tiles per warpgroup (conv3x3::with_mt)
template <int NF, int GC, int MT, class T>
__global__ void __launch_bounds__(NTHREADS, 2) trunk_kernel(const TrunkArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CTOT = NF + 4 * GC, TW = 8 * MT;
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, W = a.W;
  const int tx = (W + TW - 1) / TW, ty = (H + TH - 1) / TH, tiles = tx * ty * a.B;

  // stage 0: the first dense block's input in bf16
  conv3x3::to_dense(a.x, a.dense[0], CTOT, NF, size_t(a.B) * H * W * NF);

  const int blocks = 3 * a.nb;
  for (int j = 0; j < blocks; ++j) {
    T* d = a.dense[j % 2];
    for (int i = 0; i < 4; ++i) {
      grid.sync();  // conv i reads its predecessors' outputs, halos included
      const int cin = NF + i * GC;
      const T* w = a.w[i] + size_t(j) * conv3x3::w_elems<T>(cin, GC);
      const float* bias = a.b[i] + size_t(j) * GC;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int x0 = t % tx * TW, y0 = t / tx % ty * TH, image = t / (tx * ty);
        conv3x3::feature_tile<GC, MT, true>(smem, d, CTOT, cin, w, bias, cin, H, W, x0, y0, image);
      }
    }
    grid.sync();
    // conv5: the carry starts from the RRDB's input (its base); the third block's
    // conv5 writes the RRDB's output over the base and, unless it is the trunk's
    // last, the next RRDB's bf16 input into the other dense buffer
    const int r = j % 3;
    const float* base = j < 3 ? a.x : a.out;
    const float* xres = r == 0 ? base : a.carry;
    float* xout = r == 2 ? a.out : a.carry;
    const float* xrrdb = r == 2 ? base : nullptr;
    T* next = j + 1 < blocks ? a.dense[(j + 1) % 2] : nullptr;
    const T* w = a.w[4] + size_t(j) * conv3x3::w_elems<T>(CTOT, NF);
    const float* bias = a.b[4] + size_t(j) * NF;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int x0 = t % tx * TW, y0 = t / tx % ty * TH, image = t / (tx * ty);
      conv3x3::residual_tile<NF, MT, true>(smem, d, CTOT, w, bias, xres, xout, xrrdb, next, H, W,
                                           x0, y0, image);
    }
  }
}

template <int NF, int GC, int MT, class T>
cudaError_t launch_trunk(TrunkArgs<T> a, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(trunk_kernel<NF, GC, MT, T>);
  constexpr int smem = trunk_smem<NF, GC, T, MT>();
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = conv3x3::allow_smem<trunk_kernel<NF, GC, MT, T>>(smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 g = conv3x3::grid(a.B, a.H, a.W, MT);
  const int tiles = int(g.x * g.y * g.z);
  const int blocks = per_sm * sms < tiles ? per_sm * sms : tiles;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(NTHREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NF, int GC, class T>
cudaError_t launch_trunk(const TrunkArgs<T>& a, cudaStream_t stream) {
  return conv3x3::with_mt(a.W, [&](auto mt) {
    return launch_trunk<NF, GC, decltype(mt)::value>(a, stream);
  });
}

template <int NF, class T>
cudaError_t launch_trunk(int gc, const TrunkArgs<T>& a, cudaStream_t stream) {
  switch (gc) {
    case 16: return launch_trunk<NF, 16>(a, stream);
    case 32: return launch_trunk<NF, 32>(a, stream);
    case 64: return launch_trunk<NF, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
int trunk_apply(const float* x, float* out, float* carry, T* dense0, T* dense1,
                const T* const* w, const float* const* b, int B, int H, int W, int nf, int gc,
                int nb, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || nb < 1) return int(cudaErrorInvalidValue);
  TrunkArgs<T> a{x, out, carry, {dense0, dense1}, {}, {}, B, H, W, nb};
  for (int i = 0; i < 5; ++i) {
    a.w[i] = w[i];
    a.b[i] = b[i];
  }
  switch (nf) {
    case 16: return int(launch_trunk<16>(gc, a, stream));
    case 32: return int(launch_trunk<32>(gc, a, stream));
    case 64: return int(launch_trunk<64>(gc, a, stream));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// A trunk of nb RRDBs, bf16 recipe.  x (B,H,W,nf) float32 is not written; out (same
// shape) receives the result; carry (same shape) float32 and dense0, dense1
// (B,H,W,nf+4gc) bf16 are scratch.  w, b: host arrays of 5 device pointers (layouts
// above).  nf and gc are each 16, 32 or 64.  One cooperative launch; returns its CUDA
// error (cudaErrorNotSupported where the card has no cooperative launch).
int hcflow_rrdb_trunk_apply(const float* x, float* out, float* carry, bf16* dense0,
                            bf16* dense1, const bf16* const* w, const float* const* b, int B,
                            int H, int W, int nf, int gc, int nb, cudaStream_t stream) {
  return trunk_apply(x, out, carry, dense0, dense1, w, b, B, H, W, nf, gc, nb, stream);
}

// The same trunk in the float32 recipe (3xTF32 products): float32 dense buffers, w[i] the
// weights' TF32 planes (3nb, 2, 9, (nf+i*gc) / 4, cout_i, 4).  One cooperative launch.
int hcflow_rrdb_trunk_apply_f32(const float* x, float* out, float* carry, float* dense0,
                                float* dense1, const float* const* w, const float* const* b,
                                int B, int H, int W, int nf, int gc, int nb,
                                cudaStream_t stream) {
  return trunk_apply(x, out, carry, dense0, dense1, w, b, B, H, W, nf, gc, nb, stream);
}

// conv3x3::wide_f32, as rrdb.cu exports it: 1 where the float32 recipe's conv of cout
// outputs runs the wide tile conv, 0 where the narrow one.
int hcflow_rrdb_f32_wide(int cout) { return conv3x3::wide_f32(cout); }

}  // extern "C"
