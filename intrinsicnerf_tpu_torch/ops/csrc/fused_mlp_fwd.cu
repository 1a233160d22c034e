// Fused IntrinsicNeRF MLP forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (with `_compute_feat` and
// `_forward_tile`) of intrinsicnerf_tpu/ops/fused_mlp.py, launched there by
// `_run_fwd`.  Per point it computes
//   feat = m*sin(z) + (1-m)*z,  z = in8 @ F           (fp32, on chip)
//   8x256 ReLU trunk, skip: layer 5 = h@w5h + feat@w5x
//   heads a1, s1, m1 (256->128, ReLU), f = H@w_f, v = relu(f@wv_f + feat@wv_d)
//   out[128] = H@w_sig + a1@w_a2 + s1@w_s2 + v@w_r + m1@w_m2 + biases
// and writes `out` as bf16 [P, 128].  Every product takes bf16 operands
// with fp32 accumulation; activations are rounded to bf16 exactly where
// the Pallas kernel's `_mm` casts them.
//
// Bound: operations.  The network needs 695,680 multiply-adds per point
// with 27 semantic classes (1.39 MFLOP) against 32 bytes in and 256 bytes
// out, about 4,800 FLOP per byte of device memory, far above the H100's
// ~295 FLOP/B balance point for bf16 tensor cores.  The padded packed
// layout (PE rows 63 -> 128, head outputs -> 128 columns) makes this kernel
// do 835,584 multiply-adds per point, 20% more than the network needs.
//
// Design (simple first version): one block of 8 warps owns a tile of 64
// points and keeps every activation of the tile in shared memory: the PE
// features (64x128), two ping-pong trunk buffers (64x256) and one
// 64x128 head buffer, all bf16 with padded row strides against bank
// conflicts; 108 KB, so two blocks fit on an SM.  The products run on the
// tensor cores through nvcuda::wmma bf16 16x16x16 fragments with fp32
// accumulators; each warp owns a 32-column (or 16-column) stripe of every
// layer's output.  Weight fragments are read straight from global memory:
// the 1.7 MB of bf16 weights stay resident in the 50 MB L2, and each block
// reuses each weight fragment for its 64 points.  The ragged tail is
// masked (rows past P read as zero and are not stored).  The PE angles are
// separately rounded fp32 multiplies and adds (no tensor core, no TF32),
// so they match the plain PyTorch version bit for bit; sinf is the
// accurate libdevice sine (build without --use_fast_math).  The layouts,
// the PE and the product helpers are shared with the backward kernel
// through fused_mlp_common.cuh.

#include <climits>

#include "fused_mlp_common.cuh"

namespace {

using namespace fmlp;

constexpr int SMEM_BYTES =
    (TILE_M * LDF + 2 * TILE_M * LDA + TILE_M * LDC) * (int)sizeof(bf16) +
    NWARPS * 256 * (int)sizeof(float);

__global__ void __launch_bounds__(NTHREADS, 2)
fused_mlp_fwd_kernel(const float* __restrict__ in8, const float* __restrict__ pe_mat,
                     const float* __restrict__ sin_mask, const bf16* __restrict__ w,
                     const float* __restrict__ b, bf16* __restrict__ out, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* feat = reinterpret_cast<bf16*>(smem);  // [64, LDF]
  bf16* bufA = feat + TILE_M * LDF;            // [64, LDA]
  bf16* bufB = bufA + TILE_M * LDA;            // [64, LDA]
  bf16* bufC = bufB + TILE_M * LDA;            // [64, LDC]
  const int warp = threadIdx.x >> 5;
  float* stage = reinterpret_cast<float*>(bufC + TILE_M * LDC) + warp * 256;
  const long long row0 = (long long)blockIdx.x * TILE_M;

  compute_feat(feat, in8, pe_mat, sin_mask, row0, n);
  __syncthreads();

  const int c256 = warp * 32;  // this warp's columns of a 256-wide output
  const int c128 = warp * 16;  // ... of a 128-wide output
  FragC acc2[4][2];
  FragC acc1[4][1];

  // trunk: 0 feat->A, 1 A->B, 2 B->A, 3 A->B, 4 B->A, 5 (A, feat)->B,
  // 6 B->A, 7 A->B; H ends in bufB
  const bf16* src = feat;
  int lds = LDF, K = IN_W;
  bf16* dst = bufA;
  for (int l = 0; l < 8; ++l) {
    zero(acc2);
    const long off = l == 0 ? OFF_W0 : l < 5 ? OFF_W1 + (l - 1) * (long)W * W
                   : l == 5 ? OFF_W5H : l == 6 ? OFF_W6 : OFF_W7;
    mma_acc(acc2, src, lds, K, w + off, W, c256);
    if (l == 5) mma_acc(acc2, feat, LDF, IN_W, w + OFF_W5X, W, c256);
    store_act(acc2, b + B_TRUNK + l * W, true, dst, LDA, c256, stage);
    __syncthreads();
    src = dst;
    lds = LDA;
    K = W;
    dst = dst == bufA ? bufB : bufA;
  }
  const bf16* Hs = bufB;

  // f = H@w_f + b_f -> bufA (no ReLU)
  zero(acc2);
  mma_acc(acc2, Hs, LDA, W, w + OFF_WF, W, c256);
  store_act(acc2, b + B_F, false, bufA, LDA, c256, stage);
  __syncthreads();
  // v = relu(f@wv_f + feat@wv_d + b_v) -> bufC
  zero(acc1);
  mma_acc(acc1, bufA, LDA, W, w + OFF_WVF, HW, c128);
  mma_acc(acc1, feat, LDF, IN_W, w + OFF_WVD, HW, c128);
  store_act(acc1, b + B_V, true, bufC, LDC, c128, stage);
  __syncthreads();

  // packed output: H@w_sig + v@w_r, then the albedo/shading/semantic heads
  FragC o[4][1];
  zero(o);
  mma_acc(o, Hs, LDA, W, w + OFF_WSIG, OUT_W, c128);
  mma_acc(o, bufC, LDC, HW, w + OFF_WR, OUT_W, c128);
  zero(acc1);
  mma_acc(acc1, Hs, LDA, W, w + OFF_WA1, HW, c128);
  store_act(acc1, b + B_A1, true, bufA, LDA, c128, stage);
  zero(acc1);
  mma_acc(acc1, Hs, LDA, W, w + OFF_WS1, HW, c128);
  store_act(acc1, b + B_S1, true, bufA + HW, LDA, c128, stage);
  __syncthreads();
  mma_acc(o, bufA, LDA, HW, w + OFF_WA2, OUT_W, c128);
  mma_acc(o, bufA + HW, LDA, HW, w + OFF_WS2, OUT_W, c128);
  zero(acc1);
  mma_acc(acc1, Hs, LDA, W, w + OFF_WM1, HW, c128);
  store_act(acc1, b + B_M1, true, bufC, LDC, c128, stage);
  __syncthreads();
  mma_acc(o, bufC, LDC, HW, w + OFF_WM2, OUT_W, c128);

  // out = bf16(o + summed output biases), rows past n masked
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    wmma::store_matrix_sync(stage, o[r][0], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int i = e >> 4, col = c128 + (e & 15);
      const long long p = row0 + r * 16 + i;
      if (p < n) out[p * OUT_W + col] = __float2bfloat16(stage[e] + __ldg(b + B_OUT + col));
    }
    __syncwarp();
  }
}

}  // namespace

// in8 [n, 8] f32, pe_mat [8, 128] f32, sin_mask [128] f32, w: flat bf16
// weights, b: flat f32 biases, out [n, 128] bf16.  Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int fused_mlp_fwd(const void* in8, const void* pe_mat, const void* sin_mask,
                             const void* w, const void* b, void* out, long long n,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + TILE_M - 1) / TILE_M;
  if (n <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  fused_mlp_fwd_kernel<<<(unsigned)blocks, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(in8), static_cast<const float*>(pe_mat),
      static_cast<const float*>(sin_mask), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(out), n);
  return (int)cudaGetLastError();
}
