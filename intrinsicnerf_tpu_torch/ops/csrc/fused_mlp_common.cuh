// Device code shared by the fused-MLP forward (fused_mlp_fwd.cu) and
// backward (fused_mlp_bwd.cu) kernels and the forward's attribution probe
// (fwd_probe.cu): the packed weight and bias layouts,
// the on-chip positional encoding, and the wmma bf16 product and epilogue
// helpers.  Every product takes bf16 operands with fp32 accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace fmlp {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TILE_M = 64;  // points per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int W = 256;      // trunk width
constexpr int HW = 128;     // head width (W / 2)
constexpr int IN_W = 128;   // packed PE width
constexpr int OUT_W = 128;  // packed output width
constexpr int IN8_W = 8;
constexpr int LDF = IN_W + 8;  // padded shared-memory row strides (elements)
constexpr int LDA = W + 8;
constexpr int LDC = HW + 8;

// Offsets (elements) of each [in, out] row-major block in the flat bf16
// weight buffer, in the wrapper's _W_ORDER.
constexpr long OFF_W0 = 0;
constexpr long OFF_W1 = OFF_W0 + IN_W * W;
constexpr long OFF_W2 = OFF_W1 + W * W;
constexpr long OFF_W3 = OFF_W2 + W * W;
constexpr long OFF_W4 = OFF_W3 + W * W;
constexpr long OFF_W5X = OFF_W4 + W * W;
constexpr long OFF_W5H = OFF_W5X + IN_W * W;
constexpr long OFF_W6 = OFF_W5H + W * W;
constexpr long OFF_W7 = OFF_W6 + W * W;
constexpr long OFF_WSIG = OFF_W7 + W * W;
constexpr long OFF_WA1 = OFF_WSIG + W * OUT_W;
constexpr long OFF_WA2 = OFF_WA1 + W * HW;
constexpr long OFF_WS1 = OFF_WA2 + HW * OUT_W;
constexpr long OFF_WS2 = OFF_WS1 + W * HW;
constexpr long OFF_WF = OFF_WS2 + HW * OUT_W;
constexpr long OFF_WVF = OFF_WF + W * W;
constexpr long OFF_WVD = OFF_WVF + W * HW;
constexpr long OFF_WR = OFF_WVD + IN_W * HW;
constexpr long OFF_WM1 = OFF_WR + HW * OUT_W;
constexpr long OFF_WM2 = OFF_WM1 + W * HW;
constexpr long W_TOTAL = OFF_WM2 + HW * OUT_W;
static_assert(W_TOTAL == 835584, "packed weight layout changed");

// Offsets in the flat fp32 bias buffer (_B_ORDER, then the summed output bias).
constexpr int B_TRUNK = 0;  // b0..b7, W each
constexpr int B_A1 = 8 * W;
constexpr int B_S1 = B_A1 + HW;
constexpr int B_F = B_S1 + HW;
constexpr int B_V = B_F + W;
constexpr int B_M1 = B_V + HW;
constexpr int B_OUT = B_M1 + HW;
constexpr int B_TOTAL = B_OUT + OUT_W;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// RF row fragments of 16 points: 4 for the 64-point tiles of kernels 1
// and 2; the probe (fwd_probe.cu) also takes 2 and 8.
template <int NF, int RF>
__device__ __forceinline__ void zero(FragC (&acc)[RF][NF]) {
#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int c = 0; c < NF; ++c) wmma::fill_fragment(acc[r][c], 0.0f);
}

// acc[16*RF x 16*NF] += A[16*RF x K] (shared, stride lda) @ Wt[K x *]
// (global, stride ldw) restricted to columns [col0, col0 + 16*NF).
template <int NF, int RF>
__device__ __forceinline__ void mma_acc(FragC (&acc)[RF][NF], const bf16* A, int lda,
                                        int K, const bf16* __restrict__ Wt, int ldw,
                                        int col0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    FragA a[RF];
#pragma unroll
    for (int r = 0; r < RF; ++r) wmma::load_matrix_sync(a[r], A + r * 16 * lda + k, lda);
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      FragB b;
      wmma::load_matrix_sync(b, Wt + (long)k * ldw + col0 + c * 16, ldw);
#pragma unroll
      for (int r = 0; r < RF; ++r) wmma::mma_sync(acc[r][c], a[r], b, acc[r][c]);
    }
  }
}

// acc[64 x 16*NF] += A[64 x K] (shared, stride lda) @ Wm^T, where Wm is an
// [in, out] row-major block (global, stride ldw = out) with out = K:
// columns [col0, col0 + 16*NF) of the product index Wm's rows.
template <int NF>
__device__ __forceinline__ void mma_acc_t(FragC (&acc)[4][NF], const bf16* A, int lda,
                                          int K, const bf16* __restrict__ Wm, int ldw,
                                          int col0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    FragA a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wmma::load_matrix_sync(a[r], A + r * 16 * lda + k, lda);
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      FragBt b;
      wmma::load_matrix_sync(b, Wm + (long)(col0 + c * 16) * ldw + k, ldw);
#pragma unroll
      for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[r][c], a[r], b, acc[r][c]);
    }
  }
}

// D[:, col0 : col0 + 16*NF] = bf16(act(acc + bias)), through a per-warp
// 16x16 fp32 staging tile (the accumulator's element layout is opaque).
// D (shared, stride ldd) and G (global, stride ldg) may each be null.
template <int NF>
__device__ __forceinline__ void store_act(FragC (&acc)[4][NF], const float* __restrict__ bias,
                                          bool relu, bf16* D, int ldd, int col0,
                                          float* stage, bf16* G = nullptr, int ldg = 0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      wmma::store_matrix_sync(stage, acc[r][c], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = e >> 4, col = col0 + c * 16 + (e & 15);
        float v = stage[e] + __ldg(bias + col);
        if (relu) v = fmaxf(v, 0.0f);
        const bf16 vb = __float2bfloat16(v);
        if (D) D[(r * 16 + i) * ldd + col] = vb;
        if (G) G[(long)(r * 16 + i) * ldg + col] = vb;
      }
      __syncwarp();
    }
}

// Positional encoding of the block's TILE_M points into feat [64, LDF]:
// z = in8 @ F as separately rounded fp32 products and sums (k = 0..7, as
// the plain version adds them), then feat = m ? sin(z) : z; rows past n
// are zero.
__device__ __forceinline__ void compute_feat(bf16* feat, const float* __restrict__ in8,
                                             const float* __restrict__ pe_mat,
                                             const float* __restrict__ sin_mask,
                                             long long row0, long long n) {
  for (int e = threadIdx.x; e < TILE_M * IN_W; e += NTHREADS) {
    const int i = e / IN_W, c = e % IN_W;
    const long long p = row0 + i;
    float f = 0.0f;
    if (p < n) {
      const float* x = in8 + p * IN8_W;
      float z = __fmul_rn(x[0], pe_mat[c]);
#pragma unroll
      for (int k = 1; k < IN8_W; ++k) z = __fadd_rn(z, __fmul_rn(x[k], pe_mat[k * IN_W + c]));
      f = sin_mask[c] != 0.0f ? sinf(z) : z;
    }
    feat[i * LDF + c] = __float2bfloat16(f);
  }
}

}  // namespace fmlp
