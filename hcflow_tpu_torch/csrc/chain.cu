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
// Bound: bytes and operations about even.  A step reads z (f32) and its cond term
// (hid bf16 channels) and writes z, ~300 bytes per pixel, for ~45 kFLOP per pixel of
// bf16 convs: ~150 FLOP/byte against the card's ~295 FLOP/byte ridge.  The design
// keeps everything but z and the cond term out of device memory: a block owns an
// 8x8 output tile, loads z1 with a 2-pixel halo into shared memory, builds h1 and h2
// on the tile plus a 1-pixel halo in shared memory, and writes only the new z.  The
// step's weights are staged once per block in shared memory.  This first version
// runs the convs as CUDA-core FMAs out of shared memory, which is what bounds it
// now; tensor-core tiles are later work.
//
// Layouts: z is NHWC float32 (B,H,W,c); uc is NHWC bf16 (B,H,W,K*hid), step k's
// term at channels k*hid..; per step: w1 [9][c1][hid], w2 [hid_in][hid_out],
// w3 [9][hid][2*c2] with outputs ordered [shift | scale], vec = b1,e1,b2,e2 (hid
// each) then g3,bg3 (2*c2 each), wt [c][c], ab [c].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8, TW = 8;            // output tile
constexpr int HH = TH + 2, HWD = TW + 2; // h1/h2 region (1-pixel halo for conv3)
constexpr int ZH = TH + 4, ZW = TW + 4;  // z1 region (2-pixel halo)
constexpr int NTHREADS = 256;

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) { return __float2bfloat16(v); }

struct Layout {
  int c, c1, c2, fout, hid;
  // float region, then bf16 region (element offsets within each)
  int f_z1, f_p, f_zz, f_vec, f_wt, f_ab, n_f;
  int b_h1, b_h2, b_w1, b_w2, b_w3, n_b;

  __host__ __device__ Layout(int c_, int hid_) : c(c_), hid(hid_) {
    c1 = c / 2;
    c2 = c - c1;
    fout = 2 * c2;
    f_z1 = 0;
    f_p = f_z1 + ZH * ZW * c1;
    f_zz = f_p + TH * TW * fout;
    f_vec = f_zz + TH * TW * c;
    f_wt = f_vec + 4 * hid + 2 * fout;
    f_ab = f_wt + c * c;
    n_f = f_ab + c;
    b_h1 = 0;
    b_h2 = b_h1 + HH * HWD * hid;
    b_w1 = b_h2 + HH * HWD * hid;
    b_w2 = b_w1 + 9 * c1 * hid;
    b_w3 = b_w2 + hid * hid;
    n_b = b_w3 + 9 * hid * fout;
  }
  __host__ __device__ size_t bytes() const { return size_t(n_f) * 4 + size_t(n_b) * 2; }
};

__global__ void __launch_bounds__(NTHREADS)
chain_step_kernel(const float* __restrict__ zin, float* __restrict__ zout,
                  const __nv_bfloat16* __restrict__ uc, int uc_stride,
                  const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
                  const __nv_bfloat16* __restrict__ w3, const float* __restrict__ vec,
                  const float* __restrict__ wt, const float* __restrict__ ab,
                  int H, int W, int c, int hid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(c, hid);
  float* s_f = reinterpret_cast<float*>(smem);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem + size_t(L.n_f) * 4);
  float* s_z1 = s_f + L.f_z1;
  float* s_p = s_f + L.f_p;
  float* s_zz = s_f + L.f_zz;
  float* s_vec = s_f + L.f_vec;
  float* s_wt = s_f + L.f_wt;
  float* s_ab = s_f + L.f_ab;
  __nv_bfloat16* s_h1 = s_b + L.b_h1;
  __nv_bfloat16* s_h2 = s_b + L.b_h2;
  __nv_bfloat16* s_w1 = s_b + L.b_w1;
  __nv_bfloat16* s_w2 = s_b + L.b_w2;
  __nv_bfloat16* s_w3 = s_b + L.b_w3;

  const int c1 = L.c1, c2 = L.c2, fout = L.fout;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const size_t img = size_t(b) * H * W;

  // ---- stage the step's weights and the z1 tile (+2 halo, zero outside the image)
  for (int i = tid; i < 9 * c1 * hid; i += NTHREADS) s_w1[i] = w1[i];
  for (int i = tid; i < hid * hid; i += NTHREADS) s_w2[i] = w2[i];
  for (int i = tid; i < 9 * hid * fout; i += NTHREADS) s_w3[i] = w3[i];
  for (int i = tid; i < 4 * hid + 2 * fout; i += NTHREADS) s_vec[i] = vec[i];
  for (int i = tid; i < c * c; i += NTHREADS) s_wt[i] = wt[i];
  for (int i = tid; i < c; i += NTHREADS) s_ab[i] = ab[i];
  for (int i = tid; i < ZH * ZW * c1; i += NTHREADS) {
    const int ch = i % c1, q = i / c1;
    const int gy = y0 - 2 + q / ZW, gx = x0 - 2 + q % ZW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = zin[(img + size_t(gy) * W + gx) * c + ch];
    s_z1[i] = bf2f(f2bf(v));  // conv1 takes bf16 operands
  }
  __syncthreads();

  const float* b1 = s_vec;
  const float* e1 = s_vec + hid;
  const float* b2 = s_vec + 2 * hid;
  const float* e2 = s_vec + 3 * hid;
  const float* g3 = s_vec + 4 * hid;
  const float* bg3 = g3 + fout;

  // ---- conv1 (+ cond term) + actnorm + relu over the tile and its 1-pixel halo
  for (int i = tid; i < HH * HWD * hid; i += NTHREADS) {
    const int j = i % hid, q = i / hid;
    const int hy = q / HWD, hx = q % HWD;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float acc = 0.f;
      for (int t = 0; t < 9; ++t) {
        const float* zr = s_z1 + ((hy + t / 3) * ZW + hx + t % 3) * c1;
        const __nv_bfloat16* wr = s_w1 + t * c1 * hid + j;
        for (int ch = 0; ch < c1; ++ch) acc = fmaf(zr[ch], bf2f(wr[ch * hid]), acc);
      }
      if (uc != nullptr) acc += bf2f(uc[(img + size_t(gy) * W + gx) * uc_stride + j]);
      v = fmaxf((acc + b1[j]) * e1[j], 0.f);
    }
    s_h1[i] = f2bf(v);
  }
  __syncthreads();

  // ---- conv2 (1x1) + actnorm + relu; zero outside the image = conv3's padding
  for (int i = tid; i < HH * HWD * hid; i += NTHREADS) {
    const int j = i % hid, q = i / hid;
    const int gy = y0 - 1 + q / HWD, gx = x0 - 1 + q % HWD;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const __nv_bfloat16* hr = s_h1 + q * hid;
      float acc = 0.f;
      for (int k = 0; k < hid; ++k) acc = fmaf(bf2f(hr[k]), bf2f(s_w2[k * hid + j]), acc);
      v = fmaxf((acc + b2[j]) * e2[j], 0.f);
    }
    s_h2[i] = f2bf(v);
  }
  __syncthreads();

  // ---- conv3 (Conv2dZeros, gain folded) over the tile: [shift | scale]
  for (int i = tid; i < TH * TW * fout; i += NTHREADS) {
    const int o = i % fout, q = i / fout;
    const int ty = q / TW, tx = q % TW;
    float acc = 0.f;
    for (int t = 0; t < 9; ++t) {
      const __nv_bfloat16* hr = s_h2 + ((ty + t / 3) * HWD + tx + t % 3) * hid;
      const __nv_bfloat16* wr = s_w3 + t * hid * fout + o;
      for (int k = 0; k < hid; ++k) acc = fmaf(bf2f(hr[k]), bf2f(wr[k * fout]), acc);
    }
    s_p[i] = fmaf(acc, g3[o], bg3[o]);
  }
  __syncthreads();

  // ---- affine inverse: [z1; z2 * exp(-logscale) - shift], float32
  for (int i = tid; i < TH * TW * c; i += NTHREADS) {
    const int ch = i % c, q = i / c;
    const int gy = y0 + q / TW, gx = x0 + q % TW;
    float v = 0.f;
    if (gy < H && gx < W) {
      const float z = zin[(img + size_t(gy) * W + gx) * c + ch];
      if (ch < c1) {
        v = z;
      } else {
        const float* p = s_p + q * fout;
        const float ls = 0.318f * atanf(2.f * p[c2 + ch - c1]);
        v = z * expf(-ls) - p[ch - c1];
      }
    }
    s_zz[i] = v;
  }
  __syncthreads();

  // ---- fused invconv^-1 + actnorm^-1: z = Wt @ zz - ab, float32
  for (int i = tid; i < TH * TW * c; i += NTHREADS) {
    const int o = i % c, q = i / c;
    const int gy = y0 + q / TW, gx = x0 + q % TW;
    if (gy >= H || gx >= W) continue;
    const float* zz = s_zz + q * c;
    const float* wr = s_wt + o * c;
    float acc = 0.f;
    for (int k = 0; k < c; ++k) acc = fmaf(wr[k], zz[k], acc);
    zout[(img + size_t(gy) * W + gx) * c + o] = acc - s_ab[o];
  }
}

}  // namespace

extern "C" {

const char* hcflow_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// Runs the K steps of one chain, k = K-1 .. 0.  zin is not written; the n-th
// step (n = 0 .. K-1) writes buf[n % 2], so the result is in buf[(K-1) % 2].
// uc may be null (a chain without cond terms).  Returns the first CUDA error.
int hcflow_chain_inverse(const float* zin, float* buf0, float* buf1, const __nv_bfloat16* uc,
                         const __nv_bfloat16* w1, const __nv_bfloat16* w2,
                         const __nv_bfloat16* w3, const float* vec, const float* wt,
                         const float* ab, int B, int H, int W, int c, int hid, int K,
                         cudaStream_t stream) {
  if (c < 2 || hid < 1 || K < 1 || B < 1 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  const Layout L(c, hid);
  const size_t smem = L.bytes();
  cudaError_t err = cudaFuncSetAttribute(chain_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const size_t sw1 = size_t(9) * L.c1 * hid, sw2 = size_t(hid) * hid,
               sw3 = size_t(9) * hid * L.fout, svec = size_t(4) * hid + 2 * L.fout;
  float* bufs[2] = {buf0, buf1};
  const float* src = zin;
  for (int n = 0; n < K; ++n) {
    const int k = K - 1 - n;
    chain_step_kernel<<<grid, NTHREADS, smem, stream>>>(
        src, bufs[n % 2], uc ? uc + size_t(k) * hid : nullptr, K * hid, w1 + k * sw1,
        w2 + k * sw2, w3 + k * sw3, vec + k * svec, wt + size_t(k) * c * c, ab + size_t(k) * c,
        H, W, c, hid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    src = bufs[n % 2];
  }
  return int(cudaSuccess);
}

}  // extern "C"
