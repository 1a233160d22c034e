// Fused IntrinsicNeRF MLP backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// intrinsicnerf_tpu/ops/fused_mlp.py, launched there by `_fused_bwd`.
// Given the points in8 [P, 8] and the bf16 cotangent g [P, 128] of the
// packed output, it recomputes the forward without the five output
// products, backpropagates g through the heads and the trunk with ReLU
// masks from the recomputed activations, and returns dW = act^T g for all
// 20 packed weight blocks and db = sum(g) for the biases, in fp32.  The
// points get no gradient (exact: NeRF samples are not parameters).
// Rounding follows `_bwd_kernel`: every product takes bf16 operands with
// fp32 accumulation; each gradient is formed in fp32, its bias gradient
// is the fp32 sum of that unrounded value, and it is rounded to bf16 only
// as a product operand.  Saved activations are bf16: every consumer casts
// them to bf16 or tests their sign, so nothing changes.
//
// Bound: operations.  The network needs 2,046,720 multiply-adds per point
// in the backward (C = 27): 691,072 to recompute the forward, 695,680 for
// the weight products and 659,968 for the input products of every layer
// whose input depends on parameters.  Per point it reads 32 B of points
// and 256 B of cotangent.
//
// Design (simple first version, three passes in one call):
//  1. `bwd_act_kernel`: one block of 8 warps per 64-point tile, 1 block per
//     SM.  It recomputes the forward as kernel 1 does (shared helpers in
//     fused_mlp_common.cuh) and writes every activation to a bf16 arena
//     in device memory, then runs the backward chain with the tile's
//     gradients in shared memory (cotangent 64x128, four head gradients
//     64x128, two 64x256 trunk buffers: 121 KB plus 8 KB of staging; the
//     forward phase's 85 KB overlays it), reading the ReLU masks back
//     from the arena.  Each layer's gradient goes to the arena in bf16 and
//     its fp32 column sums to a per-tile bias partial.  The arena holds
//     5,888 bf16 per point (11.8 KB); rows past P are zero-gradient padding
//     up to a multiple of 64.
//  2. `bwd_wgrad_kernel`: dW = A^T G for the 20 blocks as 102 output tiles
//     of 128x64, each split over the point axis into `splits` chunks;
//     8 warps, each 32x32 of the tile with wmma fragments loaded straight
//     from the arena (L2).  Each (tile, chunk) writes its fp32 partial to
//     a workspace [splits, 835,584].
//  3. `reduce_rows_kernel`: the partials (and the per-tile bias partials)
//     summed in a fixed order.
// No atomics anywhere: two launches on the same inputs give bitwise-equal
// gradients.  The TPU kernel accumulates in place across its sequential
// grid instead; a GPU grid runs in parallel, hence the partials.

#include <climits>

#include "fused_mlp_common.cuh"

namespace {

using namespace fmlp;

// Arena layout: each buffer [p_pad, width] bf16 row-major, starting at
// (its offset below) * p_pad elements.
constexpr int AR_FEAT = 0;              // PE features, 128
constexpr int AR_ACT = AR_FEAT + IN_W;  // trunk activations 0..7, W each
constexpr int AR_A1 = AR_ACT + 8 * W;
constexpr int AR_S1 = AR_A1 + HW;
constexpr int AR_M1 = AR_S1 + HW;
constexpr int AR_F = AR_M1 + HW;        // feature (no ReLU), W
constexpr int AR_V = AR_F + W;
constexpr int AR_GO = AR_V + HW;        // the cotangent, zero past P, 128
constexpr int AR_G = AR_GO + OUT_W;     // trunk pre-activation gradients 0..7
constexpr int AR_GA1 = AR_G + 8 * W;
constexpr int AR_GS1 = AR_GA1 + HW;
constexpr int AR_GM1 = AR_GS1 + HW;
constexpr int AR_GV = AR_GM1 + HW;
constexpr int AR_GF = AR_GV + HW;
constexpr int AR_COLS = AR_GF + W;
static_assert(AR_COLS == 5888, "arena layout changed");

constexpr int SMEM_FWD = (TILE_M * LDF + 2 * TILE_M * LDA) * (int)sizeof(bf16);
constexpr int SMEM_BWD = (5 * TILE_M * LDC + TILE_M * LDA) * (int)sizeof(bf16);
constexpr int SMEM_MAIN = SMEM_FWD > SMEM_BWD ? SMEM_FWD : SMEM_BWD;
constexpr int SMEM_BYTES = SMEM_MAIN + NWARPS * 256 * (int)sizeof(float);

// One gradient epilogue: v = acc (masked by act > 0 where `mask` is set,
// zero past n) -> bf16 into D (shared, may be null) and G (global arena),
// and the fp32 column sums of v over the tile's 64 rows (fixed order) into
// bsum[col].
template <int NF>
__device__ __forceinline__ void store_grad(FragC (&acc)[4][NF], const bf16* __restrict__ mask,
                                           int ldm, bf16* D, int ldd, bf16* G, int ldg,
                                           float* bsum, int col0, float* stage,
                                           long long row0, long long n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    float colsum = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      wmma::store_matrix_sync(stage, acc[r][c], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = r * 16 + (e >> 4), col = col0 + c * 16 + (e & 15);
        float v = stage[e];
        if (mask && !(__bfloat162float(mask[(long)row * ldm + col]) > 0.0f)) v = 0.0f;
        if (row0 + row >= n) v = 0.0f;
        stage[e] = v;
        const bf16 vb = __float2bfloat16(v);
        if (D) D[row * ldd + col] = vb;
        G[(long)row * ldg + col] = vb;
      }
      __syncwarp();
      if (lane < 16)
        for (int i = 0; i < 16; ++i) colsum += stage[i * 16 + lane];
      __syncwarp();
    }
    if (lane < 16) bsum[col0 + c * 16 + lane] = colsum;
  }
}

// copy a [64, cols] shared tile (stride lds) to the arena (stride cols)
__device__ __forceinline__ void copy_tile(const bf16* S, int lds, int cols, bf16* G) {
  for (int e = threadIdx.x; e < TILE_M * cols; e += NTHREADS) {
    const int i = e / cols, c = e % cols;
    G[(long)i * cols + c] = S[i * lds + c];
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
bwd_act_kernel(const float* __restrict__ in8, const float* __restrict__ pe_mat,
               const float* __restrict__ sin_mask, const bf16* __restrict__ w,
               const float* __restrict__ b, const bf16* __restrict__ g,
               bf16* __restrict__ arena, float* __restrict__ bpart, long long n,
               long long p_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  float* stage = reinterpret_cast<float*>(smem + SMEM_MAIN) + warp * 256;
  const long long row0 = (long long)blockIdx.x * TILE_M;
  const int c256 = warp * 32;  // this warp's columns of a 256-wide output
  const int c128 = warp * 16;  // ... of a 128-wide output
  auto ar = [&](int off, int width) { return arena + (long)off * p_pad + row0 * width; };
  float* bsum = bpart + (long)blockIdx.x * B_TOTAL;
  FragC acc2[4][2];
  FragC acc1[4][1];

  // ---- forward recompute (kernel 1 without the output products) ----
  {
    bf16* feat = reinterpret_cast<bf16*>(smem);  // [64, LDF]
    bf16* bufA = feat + TILE_M * LDF;            // [64, LDA]
    bf16* bufB = bufA + TILE_M * LDA;            // [64, LDA]
    compute_feat(feat, in8, pe_mat, sin_mask, row0, n);
    __syncthreads();
    copy_tile(feat, LDF, IN_W, ar(AR_FEAT, IN_W));

    const bf16* src = feat;
    int lds = LDF, K = IN_W;
    bf16* dst = bufA;
    for (int l = 0; l < 8; ++l) {
      zero(acc2);
      const long off = l == 0 ? OFF_W0 : l < 5 ? OFF_W1 + (l - 1) * (long)W * W
                     : l == 5 ? OFF_W5H : l == 6 ? OFF_W6 : OFF_W7;
      mma_acc(acc2, src, lds, K, w + off, W, c256);
      if (l == 5) mma_acc(acc2, feat, LDF, IN_W, w + OFF_W5X, W, c256);
      store_act(acc2, b + B_TRUNK + l * W, true, dst, LDA, c256, stage, ar(AR_ACT + l * W, W), W);
      __syncthreads();
      src = dst;
      lds = LDA;
      K = W;
      dst = dst == bufA ? bufB : bufA;
    }
    const bf16* Hs = bufB;

    zero(acc2);  // f = H@w_f + b_f -> bufA
    mma_acc(acc2, Hs, LDA, W, w + OFF_WF, W, c256);
    store_act(acc2, b + B_F, false, bufA, LDA, c256, stage, ar(AR_F, W), W);
    __syncthreads();
    zero(acc1);  // v = relu(f@wv_f + feat@wv_d + b_v)
    mma_acc(acc1, bufA, LDA, W, w + OFF_WVF, HW, c128);
    mma_acc(acc1, feat, LDF, IN_W, w + OFF_WVD, HW, c128);
    store_act(acc1, b + B_V, true, nullptr, 0, c128, stage, ar(AR_V, HW), HW);
    zero(acc1);
    mma_acc(acc1, Hs, LDA, W, w + OFF_WA1, HW, c128);
    store_act(acc1, b + B_A1, true, nullptr, 0, c128, stage, ar(AR_A1, HW), HW);
    zero(acc1);
    mma_acc(acc1, Hs, LDA, W, w + OFF_WS1, HW, c128);
    store_act(acc1, b + B_S1, true, nullptr, 0, c128, stage, ar(AR_S1, HW), HW);
    zero(acc1);
    mma_acc(acc1, Hs, LDA, W, w + OFF_WM1, HW, c128);
    store_act(acc1, b + B_M1, true, nullptr, 0, c128, stage, ar(AR_M1, HW), HW);
    __syncthreads();  // the arena's activations are visible to the whole block
  }

  // ---- backward chain ----
  bf16* sgo = reinterpret_cast<bf16*>(smem);  // [64, LDC] cotangent
  bf16* sh = sgo + TILE_M * LDC;              // 4 x [64, LDC]: ga1, gs1, gm1, gv
  bf16* sgf = sh + 4 * TILE_M * LDC;          // [64, LDA] gf, then trunk gradients
  bf16* sgh = sh;                             // [64, LDA] over sh once dH is formed
  bf16* ga1 = sh;
  bf16* gs1 = sh + TILE_M * LDC;
  bf16* gm1 = sh + 2 * TILE_M * LDC;
  bf16* gv = sh + 3 * TILE_M * LDC;

  {
    bf16* go_ar = ar(AR_GO, OUT_W);
    const bf16 zero_b = __float2bfloat16(0.0f);
    for (int e = threadIdx.x; e < TILE_M * OUT_W; e += NTHREADS) {
      const int i = e / OUT_W, c = e % OUT_W;
      const long long p = row0 + i;
      const bf16 v = p < n ? g[p * OUT_W + c] : zero_b;
      sgo[i * LDC + c] = v;
      go_ar[(long)i * OUT_W + c] = v;
    }
    __syncthreads();
    if (threadIdx.x < OUT_W) {  // the five output biases' gradient: sum(go)
      float s = 0.0f;
      for (int i = 0; i < TILE_M; ++i) s += __bfloat162float(sgo[i * LDC + threadIdx.x]);
      bsum[B_OUT + threadIdx.x] = s;
    }
  }

  // head gradients: g1 = (go @ w2^T) * (act1 > 0)
  zero(acc1);
  mma_acc_t(acc1, sgo, LDC, OUT_W, w + OFF_WA2, OUT_W, c128);
  store_grad(acc1, ar(AR_A1, HW), HW, ga1, LDC, ar(AR_GA1, HW), HW, bsum + B_A1, c128, stage, row0, n);
  zero(acc1);
  mma_acc_t(acc1, sgo, LDC, OUT_W, w + OFF_WS2, OUT_W, c128);
  store_grad(acc1, ar(AR_S1, HW), HW, gs1, LDC, ar(AR_GS1, HW), HW, bsum + B_S1, c128, stage, row0, n);
  zero(acc1);
  mma_acc_t(acc1, sgo, LDC, OUT_W, w + OFF_WM2, OUT_W, c128);
  store_grad(acc1, ar(AR_M1, HW), HW, gm1, LDC, ar(AR_GM1, HW), HW, bsum + B_M1, c128, stage, row0, n);
  zero(acc1);
  mma_acc_t(acc1, sgo, LDC, OUT_W, w + OFF_WR, OUT_W, c128);
  store_grad(acc1, ar(AR_V, HW), HW, gv, LDC, ar(AR_GV, HW), HW, bsum + B_V, c128, stage, row0, n);
  __syncthreads();

  // gf = gv @ wv_f^T (f has no ReLU)
  zero(acc2);
  mma_acc_t(acc2, gv, LDC, HW, w + OFF_WVF, HW, c256);
  store_grad(acc2, nullptr, 0, sgf, LDA, ar(AR_GF, W), W, bsum + B_F, c256, stage, row0, n);
  __syncthreads();

  // dH = go@w_sig^T + ga1@w_a1^T + gs1@w_s1^T + gm1@w_m1^T + gf@w_f^T
  zero(acc2);
  mma_acc_t(acc2, sgo, LDC, OUT_W, w + OFF_WSIG, OUT_W, c256);
  mma_acc_t(acc2, ga1, LDC, HW, w + OFF_WA1, HW, c256);
  mma_acc_t(acc2, gs1, LDC, HW, w + OFF_WS1, HW, c256);
  mma_acc_t(acc2, gm1, LDC, HW, w + OFF_WM1, HW, c256);
  mma_acc_t(acc2, sgf, LDA, W, w + OFF_WF, W, c256);
  __syncthreads();  // sgh overlays the head gradients just read
  store_grad(acc2, ar(AR_ACT + 7 * W, W), W, sgh, LDA, ar(AR_G + 7 * W, W), W,
             bsum + B_TRUNK + 7 * W, c256, stage, row0, n);
  __syncthreads();

  // trunk: gh_{l-1} = (gh_l @ w_l^T) * (act_{l-1} > 0), l = 7..1
  bf16* cur = sgh;
  bf16* other = sgf;
  for (int l = 7; l >= 1; --l) {
    const long off = l == 5 ? OFF_W5H : l == 6 ? OFF_W6 : l == 7 ? OFF_W7
                   : OFF_W1 + (l - 1) * (long)W * W;
    zero(acc2);
    mma_acc_t(acc2, cur, LDA, W, w + off, W, c256);
    store_grad(acc2, ar(AR_ACT + (l - 1) * W, W), W, l > 1 ? other : nullptr, LDA,
               ar(AR_G + (l - 1) * W, W), W, bsum + B_TRUNK + (l - 1) * W, c256, stage,
               row0, n);
    __syncthreads();
    bf16* t = cur;
    cur = other;
    other = t;
  }
}

// One weight gradient dW[K, N] = A[P, K]^T @ G[P, N] (arena buffers).
struct Job {
  int a_off, lda, g_off, ldg, K, N;
  long w_off;
};

constexpr int TK = 128, TN = 64;  // output tile of one block
constexpr int N_JOBS = 20;
constexpr int N_TILES = (int)(W_TOTAL / (TK * TN));
static_assert(N_TILES * TK * TN == W_TOTAL, "every block is a whole number of tiles");

#define JOB(a, la, g, lg, k, n, off) {a, la, g, lg, k, n, off}
__constant__ Job c_jobs[N_JOBS] = {
    JOB(AR_FEAT, IN_W, AR_G + 0 * W, W, IN_W, W, OFF_W0),
    JOB(AR_ACT + 0 * W, W, AR_G + 1 * W, W, W, W, OFF_W1),
    JOB(AR_ACT + 1 * W, W, AR_G + 2 * W, W, W, W, OFF_W2),
    JOB(AR_ACT + 2 * W, W, AR_G + 3 * W, W, W, W, OFF_W3),
    JOB(AR_ACT + 3 * W, W, AR_G + 4 * W, W, W, W, OFF_W4),
    JOB(AR_FEAT, IN_W, AR_G + 5 * W, W, IN_W, W, OFF_W5X),
    JOB(AR_ACT + 4 * W, W, AR_G + 5 * W, W, W, W, OFF_W5H),
    JOB(AR_ACT + 5 * W, W, AR_G + 6 * W, W, W, W, OFF_W6),
    JOB(AR_ACT + 6 * W, W, AR_G + 7 * W, W, W, W, OFF_W7),
    JOB(AR_ACT + 7 * W, W, AR_GO, OUT_W, W, OUT_W, OFF_WSIG),
    JOB(AR_ACT + 7 * W, W, AR_GA1, HW, W, HW, OFF_WA1),
    JOB(AR_A1, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WA2),
    JOB(AR_ACT + 7 * W, W, AR_GS1, HW, W, HW, OFF_WS1),
    JOB(AR_S1, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WS2),
    JOB(AR_ACT + 7 * W, W, AR_GF, W, W, W, OFF_WF),
    JOB(AR_F, W, AR_GV, HW, W, HW, OFF_WVF),
    JOB(AR_FEAT, IN_W, AR_GV, HW, IN_W, HW, OFF_WVD),
    JOB(AR_V, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WR),
    JOB(AR_ACT + 7 * W, W, AR_GM1, HW, W, HW, OFF_WM1),
    JOB(AR_M1, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WM2),
};
#undef JOB

using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

__global__ void __launch_bounds__(NTHREADS)
bwd_wgrad_kernel(const bf16* __restrict__ arena, float* __restrict__ ws, long long p_pad,
                 long long chunk) {
  // the job owning this output tile: jobs own K*N / (TK*TN) tiles each,
  // in weight-buffer order
  int t = blockIdx.x, j = 0;
  for (; j < N_JOBS - 1; ++j) {
    const int tiles = c_jobs[j].K * c_jobs[j].N / (TK * TN);
    if (t < tiles) break;
    t -= tiles;
  }
  const Job job = c_jobs[j];
  const int tiles_n = job.N / TN;
  const int k0 = (t / tiles_n) * TK, n0 = (t % tiles_n) * TN;
  const int warp = threadIdx.x >> 5;
  const int kw = k0 + (warp >> 1) * 32, nw = n0 + (warp & 1) * 32;
  const bf16* A = arena + (long)job.a_off * p_pad;
  const bf16* G = arena + (long)job.g_off * p_pad;
  const long long p_begin = (long long)blockIdx.y * chunk;
  const long long p_end = p_begin + chunk < p_pad ? p_begin + chunk : p_pad;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) wmma::fill_fragment(acc[i][c], 0.0f);
  for (long long p = p_begin; p < p_end; p += 16) {
    FragAt a[2];
    FragB bfr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], A + p * job.lda + kw + i * 16, job.lda);
#pragma unroll
    for (int c = 0; c < 2; ++c) wmma::load_matrix_sync(bfr[c], G + p * job.ldg + nw + c * 16, job.ldg);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) wmma::mma_sync(acc[i][c], a[i], bfr[c], acc[i][c]);
  }
  float* out = ws + (long)blockIdx.y * W_TOTAL + job.w_off;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      wmma::store_matrix_sync(out + (long)(kw + i * 16) * job.N + nw + c * 16, acc[i][c], job.N,
                              wmma::mem_row_major);
}

// out[c] = sum_r in[r * ld + c], r in a fixed order: 8 row groups per
// column, then the groups in order.
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ in, long long rows, long long ld, long long cols,
                   float* __restrict__ out) {
  __shared__ float part[8][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < cols)
    for (long long r = threadIdx.y; r < rows; r += 8) s += in[r * ld + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = part[0][threadIdx.x];
    for (int k = 1; k < 8; ++k) t += part[k][threadIdx.x];
    out[c] = t;
  }
}

}  // namespace

// Scratch sizes for n points and `splits` point chunks of the weight
// products, in elements: arena (bf16) and bias partials, workspace (fp32).
extern "C" void fused_mlp_bwd_scratch(long long n, int splits, long long* arena_elems,
                                      long long* bpart_elems, long long* ws_elems) {
  const long long p_pad = (n + TILE_M - 1) / TILE_M * TILE_M;
  *arena_elems = (long long)AR_COLS * p_pad;
  *bpart_elems = p_pad / TILE_M * B_TOTAL;
  *ws_elems = (long long)splits * W_TOTAL;
}

// in8 [n, 8] f32, pe_mat [8, 128] f32, sin_mask [128] f32, w / b: the
// forward kernel's flat bf16 weights and f32 biases, g [n, 128] bf16;
// scratch from fused_mlp_bwd_scratch; dw [835,584] f32 in the weight
// buffer's layout, db [2,944] f32 in the bias buffer's layout (its last
// 128 entries are the gradient of each of the five output biases).
// Launches on `stream`; returns the first failing launch's cudaError_t.
extern "C" int fused_mlp_bwd(const void* in8, const void* pe_mat, const void* sin_mask,
                             const void* w, const void* b, const void* g, void* arena,
                             void* bpart, void* ws, void* dw, void* db, long long n, int splits,
                             void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const long long p_pad = (n + TILE_M - 1) / TILE_M * TILE_M;
  const long long tiles = p_pad / TILE_M;
  if (tiles > INT_MAX || splits > 65535) return (int)cudaErrorInvalidValue;
  const long long steps = p_pad / 16;
  const long long chunk = (steps + splits - 1) / splits * 16;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  bwd_act_kernel<<<(unsigned)tiles, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const float*>(in8), static_cast<const float*>(pe_mat),
      static_cast<const float*>(sin_mask), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const bf16*>(g), static_cast<bf16*>(arena),
      static_cast<float*>(bpart), n, p_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_wgrad_kernel<<<dim3(N_TILES, splits), NTHREADS, 0, s>>>(
      static_cast<const bf16*>(arena), static_cast<float*>(ws), p_pad, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 rb(32, 8);
  reduce_rows_kernel<<<(unsigned)((W_TOTAL + 31) / 32), rb, 0, s>>>(
      static_cast<const float*>(ws), splits, W_TOTAL, W_TOTAL, static_cast<float*>(dw));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(unsigned)((B_TOTAL + 31) / 32), rb, 0, s>>>(
      static_cast<const float*>(bpart), tiles, B_TOTAL, B_TOTAL, static_cast<float*>(db));
  return (int)cudaGetLastError();
}
