// The fused MLP's heads, read out of its packed output and differentiated
// in one pass each way, plain C interface (sm_90a; no Hopper-only
// instruction, so any card runs the same code).
//
// No TPU twin: the JAX package leaves these elementwise expressions to XLA,
// which fuses them into its neighbours (intrinsicnerf_tpu/ops/fused_mlp.py,
// `fused_eval_points`).  In PyTorch's eager autograd the same expressions
// cast the whole [P, 128] bf16 output to fp32, and their backward fills a
// zero [P, 128] fp32 tensor for each of the five slices, sums the five and
// casts the sum back to bf16: ~1.6 GB of elementwise traffic a Replica
// step for 8 + C useful columns.
//
// Column layout of the packed output (kernel 1, fused_mlp_fwd.cu):
//   [0] sigma, [1:4] albedo logits, [4] shading logit, [5:8] residual
//   logits, [8:8+C] semantic logits, [8+C:128] zero padding.
//
// Forward, `packed_heads_fwd_kernel`: one thread a point reads columns 0-7
// as one 16-byte load and writes contiguous fp32
//   sigma [P], albedo [P, 3], shading [P], residual [P, 3], rgb [P, 3],
// and the block then copies its points' semantic logits, columns 8 to
// 8 + C - 1, into a contiguous sem [P, C] (C > 0), a warp a row and a lane
// a class (no integer division per value).  The values are bitwise those
// of the eager expressions they replace: sigma and the logits are the
// exact fp32 of the bf16; each sigmoid is ATen's fp32 formula
// 1 / (1 + expf(-x)) (IEEE division and expf: this library is built
// without --use_fast_math); and
// rgb = albedo * shading + residual rounds its product and its sum
// separately (__fmul_rn, __fadd_rn), as the two eager kernels do, where
// nvcc would otherwise contract them into one FMA.
//
// Backward, `packed_heads_bwd_kernel`: the bf16 cotangent [P, 128] of the
// packed output, written once; each thread writes one 16-byte chunk (8
// columns) of a row, so a warp stores 512 contiguous bytes.  The gradients
// of the six outputs may each be absent (a null pointer, read as zero),
// and it reads the three sigmoid outputs the forward saved.  Each logit's
// gradient is formed in fp32 as autograd forms it from the eager
// expressions:
//   albedo:   g_albedo + g_rgb * shading
//   residual: g_residual + g_rgb
//   shading:  g_shading + ((g_rgb0 * albedo0 + g_rgb2 * albedo2) + g_rgb1 * albedo1)
// (the three-term sum in the order ATen's reduction of a 3-wide last
// dimension takes, measured on the card), then through ATen's
// sigmoid_backward, g * (1 - y) * y, every product and sum rounded on its
// own; sigma and the semantic logits pass through.  Each value is then
// rounded once to bf16 (round to nearest even, as a .to(torch.bfloat16)
// does), after adding +0: the eager backward sums five zero-filled slice
// gradients, which turns a -0 into +0.  Columns 8 + C to 127 are zero.  So
// the cotangent is bitwise the eager one wherever ATen sums the three
// products in the order above; the order lives in one place
// (`shading_sum`), and the card test holds the shading column to one bf16
// ulp of the eager column and every other column to its bits.
//
// Bound, on an H100 (3.35 TB/s; no matrix work).  Bytes a point at C
// classes: the forward reads the output's first 16 + 2C bytes, in whole
// 32-byte sectors of each 256-byte row (48 B at C = 0, 96 B at C = 27), and
// writes 44 + 4C B; the backward reads 44 + 4C B of gradients and 28 B of
// saved sigmoids and writes 256 B.  At the Replica step's 262,144 points a
// step (C = 27, 684 B a point both ways): 179 MB, ~54 us at the memory's
// rate, against the ~1.1 ms of eager elementwise work it replaces.  Both kernels are bound by these
// bytes; neither uses shared memory or synchronises inside the block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT_W = 128;       // packed output width (bf16 columns)
constexpr int CHUNKS = OUT_W / 8;  // 16-byte chunks a row
constexpr int FWD_THREADS = 256;  // points a forward block
constexpr int BWD_THREADS = 256;  // chunks a backward block: 16 rows

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);  // exact
}

// ATen's fp32 sigmoid (UnarySpecialOpsKernel.cu): 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_aten(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// ATen's sigmoid_backward: g * (1 - y) * y, left to right
__device__ __forceinline__ float sigmoid_backward_aten(float g, float y) {
  return __fmul_rn(__fmul_rn(g, __fsub_rn(1.0f, y)), y);
}

// the shading logit's share of g_rgb: sum_k g_rgb_k * albedo_k in the
// order of ATen's reduction of a 3-wide last dimension ((x0 + x2) + x1)
__device__ __forceinline__ float shading_sum(const float p[3]) {
  return __fadd_rn(__fadd_rn(p[0], p[2]), p[1]);
}

__device__ __forceinline__ float load_or_zero(const float* __restrict__ g, long long i) {
  return g != nullptr ? g[i] : 0.0f;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(__fadd_rn(lo, 0.0f), __fadd_rn(hi, 0.0f));  // no -0
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(FWD_THREADS) packed_heads_fwd_kernel(
    const __nv_bfloat16* __restrict__ out, long long n, int c, float* __restrict__ sigma,
    float* __restrict__ albedo, float* __restrict__ shading, float* __restrict__ residual,
    float* __restrict__ rgb, float* __restrict__ sem) {
  const long long base = (long long)blockIdx.x * FWD_THREADS;
  const long long p = base + threadIdx.x;
  if (p < n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(out + p * OUT_W);  // columns 0-7
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float v[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_bits_to_float(w[k] & 0xffffu);
      v[2 * k + 1] = bf16_bits_to_float(w[k] >> 16);
    }
    const float s = sigmoid_aten(v[4]);
    sigma[p] = v[0];
    shading[p] = s;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = sigmoid_aten(v[1 + k]);
      const float r = sigmoid_aten(v[5 + k]);
      albedo[3 * p + k] = a;
      residual[3 * p + k] = r;
      rgb[3 * p + k] = __fadd_rn(__fmul_rn(a, s), r);
    }
  }
  if (c > 0) {  // the block's rows of sem [P, C], a warp a row, a lane a class
    const int rows = n - base < FWD_THREADS ? (int)(n - base) : FWD_THREADS;
    const int lane = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < rows; r += FWD_THREADS / 32) {
      const __nv_bfloat16* __restrict__ src = out + (base + r) * OUT_W + 8;
      float* __restrict__ dst = sem + (base + r) * c;
      for (int k = lane; k < c; k += 32) dst[k] = __bfloat162float(src[k]);
    }
  }
}

__global__ void __launch_bounds__(BWD_THREADS) packed_heads_bwd_kernel(
    const float* __restrict__ g_sigma, const float* __restrict__ g_albedo,
    const float* __restrict__ g_shading, const float* __restrict__ g_residual,
    const float* __restrict__ g_rgb, const float* __restrict__ g_sem,
    const float* __restrict__ albedo, const float* __restrict__ shading,
    const float* __restrict__ residual, long long n, int c, __nv_bfloat16* __restrict__ gout) {
  const long long t = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  const long long p = t / CHUNKS;
  const int j = (int)(t % CHUNKS);
  if (p >= n) return;
  float v[8];
  if (j == 0) {  // columns 0-7: sigma and the three sigmoid heads
    const float s = shading[p];
    float prod[3];
    v[0] = load_or_zero(g_sigma, p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const long long i = 3 * p + k;
      const float a = albedo[i];
      const float gr = load_or_zero(g_rgb, i);
      prod[k] = __fmul_rn(gr, a);
      v[1 + k] = sigmoid_backward_aten(__fadd_rn(load_or_zero(g_albedo, i), __fmul_rn(gr, s)), a);
      v[5 + k] = sigmoid_backward_aten(__fadd_rn(load_or_zero(g_residual, i), gr), residual[i]);
    }
    v[4] = sigmoid_backward_aten(__fadd_rn(load_or_zero(g_shading, p), shading_sum(prod)), s);
  } else {  // columns 8j to 8j + 7: semantic logits 8j - 8 to 8j - 1, zero past C
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = 8 * (j - 1) + k;
      v[k] = (g_sem != nullptr && col < c) ? g_sem[p * c + col] : 0.0f;
    }
  }
  uint4 chunk;
  chunk.x = pack_bf16x2(v[0], v[1]);
  chunk.y = pack_bf16x2(v[2], v[3]);
  chunk.z = pack_bf16x2(v[4], v[5]);
  chunk.w = pack_bf16x2(v[6], v[7]);
  reinterpret_cast<uint4*>(gout)[t] = chunk;
}

}  // namespace

// out: bf16 [n, 128], 16-byte aligned; sigma, shading: fp32 [n]; albedo,
// residual, rgb: fp32 [n, 3]; sem: fp32 [n, c] (unused at c = 0).  Launches
// on `stream` and returns the launch's cudaError_t.
extern "C" int packed_heads_fwd(const void* out, long long n, int c, void* sigma, void* albedo,
                                void* shading, void* residual, void* rgb, void* sem,
                                void* stream) {
  const long long blocks = (n + FWD_THREADS - 1) / FWD_THREADS;
  packed_heads_fwd_kernel<<<(unsigned)blocks, FWD_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(out), n, c, static_cast<float*>(sigma),
      static_cast<float*>(albedo), static_cast<float*>(shading), static_cast<float*>(residual),
      static_cast<float*>(rgb), static_cast<float*>(sem));
  return (int)cudaGetLastError();
}

// The gradients g_* in the forward's layouts (each may be null: zero), the
// forward's albedo, shading and residual, and gout: bf16 [n, 128], 16-byte
// aligned, every byte written.  Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int packed_heads_bwd(const void* g_sigma, const void* g_albedo, const void* g_shading,
                                const void* g_residual, const void* g_rgb, const void* g_sem,
                                const void* albedo, const void* shading, const void* residual,
                                long long n, int c, void* gout, void* stream) {
  const long long blocks = (n * CHUNKS + BWD_THREADS - 1) / BWD_THREADS;
  packed_heads_bwd_kernel<<<(unsigned)blocks, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(g_sigma), static_cast<const float*>(g_albedo),
      static_cast<const float*>(g_shading), static_cast<const float*>(g_residual),
      static_cast<const float*>(g_rgb), static_cast<const float*>(g_sem),
      static_cast<const float*>(albedo), static_cast<const float*>(shading),
      static_cast<const float*>(residual), n, c, static_cast<__nv_bfloat16*>(gout));
  return (int)cudaGetLastError();
}
