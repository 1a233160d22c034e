// Attribution probe for the fused-MLP forward (kernel 1) on Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU probe kernel `make_kernel` of tools_fwd_probe.py
// (launched there by `run`): stripped-down variants of the forward's own
// structure, timed one by one to say where kernel 1's time goes.  Per
// point it computes
//   z = sum_{d<7} in8[d] * pe[d]           (separately rounded fp32 multiply-adds)
//   feat = full:   sm*sin(z) + (1-sm)*z
//          nosin:  z
//          nope:   in8[0] * 0.01 in every column (no PE at all)
//   h = feat; L times: o = bf16(h) @ bf16(W_i) (fp32 accumulation), then
//          full: h = relu(o + b_i)   nobias: h = relu(o)   norelu: h = o
//   out = h[:, :128] as bf16 or fp32.
// W_0 is [128, 256], W_1.. are [256, 256]; L is 1 to 16.
//
// Bound: operations.  2*N*(128*256 + (L-1)*256^2) FLOP (193.3 GFLOP at
// L = 8 and N = 196,608: 0.195 ms at 989 TFLOP/s) against 32 bytes in and
// 256 bytes out per point (0.017 ms at 3.35 TB/s).
//
// Design: the same structure as kernel 1 (fused_mlp_fwd.cu), through the
// same device helpers (fused_mlp_common.cuh), so that what the probe
// measures speaks for kernel 1.  One block of 8 warps owns a tile of TM
// points and keeps its activations in shared memory as bf16: two
// ping-pong [TM, 256] buffers with padded rows (the PE features live in the
// first 128 columns of one of them).  Every product runs on the tensor
// cores through nvcuda::wmma bf16 16x16x16 fragments with fp32
// accumulators; each warp owns a 32-column stripe of every layer's output,
// and the weight fragments are read straight from global memory, where
// the <= 8 MB of bf16 weights stay in the 50 MB L2.  The bias is added in
// fp32 after the fp32 accumulation, and the ReLU after it; the ragged tail
// is masked.  As in kernel 1, sinf is the accurate libdevice sine (no
// --use_fast_math).
//
// The tile.  On the TPU the probe swept 512 to 16,384 points per grid step,
// all in VMEM.  Here the tile TM is the points per block and the only tile
// knob: 32, 64 (kernel 1's) or 128 points.  Its shared memory is
// 2 * TM * 264 * 2 B of activations plus 8 KB of per-warp staging: 42 KB,
// 74 KB and 140 KB, so 5, 3 and 1 blocks fit on an SM.  The variant and
// the tile are template parameters, the output type too; the layer count
// is a kernel argument.

#include <climits>

#include "fused_mlp_common.cuh"

namespace {

using namespace fmlp;

enum Variant { FULL = 0, NOSIN = 1, NOPE = 2, NORELU = 3, NOBIAS = 4 };

constexpr int PE_ROWS = 7;  // the probe sums in8 columns 0..6

template <int TM>
constexpr int smem_bytes() {
  return 2 * TM * LDA * (int)sizeof(bf16) + NWARPS * 256 * (int)sizeof(float);
}

__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// The variant's epilogue of one fp32 accumulator value: bias (full only)
// added in fp32, then the ReLU (all but norelu).
template <int V>
__device__ __forceinline__ float epilogue(float acc, const float* __restrict__ bias, int col) {
  float v = acc;
  if (V == FULL || V == NOSIN || V == NOPE) v += __ldg(bias + col);
  if (V != NORELU) v = fmaxf(v, 0.0f);
  return v;
}

template <int V, int TM, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
fwd_probe_kernel(const float* __restrict__ in8, const float* __restrict__ pe,
                 const float* __restrict__ sm, const bf16* __restrict__ w,
                 const float* __restrict__ b, OutT* __restrict__ out, long long n,
                 int n_layers) {
  constexpr int RF = TM / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem);  // [TM, LDA]
  bf16* bufB = bufA + TM * LDA;                // [TM, LDA]; PE features first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(bufB + TM * LDA) + warp * 256;
  const long long row0 = (long long)blockIdx.x * TM;

  for (int e = threadIdx.x; e < TM * IN_W; e += NTHREADS) {
    const int i = e / IN_W, c = e % IN_W;
    const long long p = row0 + i;
    float f = 0.0f;
    if (p < n) {
      const float* x = in8 + p * IN8_W;
      if (V == NOPE) {
        f = __fmul_rn(x[0], 0.01f);
      } else {
        float z = __fmul_rn(x[0], pe[c]);
#pragma unroll
        for (int d = 1; d < PE_ROWS; ++d) z = __fadd_rn(z, __fmul_rn(x[d], pe[d * IN_W + c]));
        if (V == NOSIN) {
          f = z;
        } else {
          const float m = sm[c];
          f = __fadd_rn(__fmul_rn(m, sinf(z)), __fmul_rn(1.0f - m, z));
        }
      }
    }
    bufB[i * LDA + c] = __float2bfloat16(f);
  }
  __syncthreads();

  const int c0 = warp * 32;  // this warp's 32 columns of every layer
  FragC acc[RF][2];
  const bf16* src = bufB;
  bf16* dst = bufA;
  int K = IN_W;
  const bf16* wl = w;
  for (int l = 0; l < n_layers; ++l) {
    zero(acc);
    mma_acc(acc, src, LDA, K, wl, W, c0);
    const float* bl = b + l * W;
    const bool last = l == n_layers - 1;
    // the output keeps columns 0..127 only; no barrier follows the last layer
    if (last && c0 >= OUT_W) return;
#pragma unroll
    for (int r = 0; r < RF; ++r)
#pragma unroll
      for (int cf = 0; cf < 2; ++cf) {
        wmma::store_matrix_sync(stage, acc[r][cf], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int i = r * 16 + (e >> 4), col = c0 + cf * 16 + (e & 15);
          const float v = epilogue<V>(stage[e], bl, col);
          if (!last) {
            dst[i * LDA + col] = __float2bfloat16(v);
          } else if (row0 + i < n) {
            put(out + (row0 + i) * OUT_W + col, v);
          }
        }
        __syncwarp();
      }
    if (last) return;
    __syncthreads();
    wl += (long)K * W;
    K = W;
    src = dst;
    dst = dst == bufA ? bufB : bufA;
  }
}

template <int V, int TM, typename OutT>
int launch(const void* in8, const void* pe, const void* sm, const void* w, const void* b,
           void* out, long long n, int n_layers, cudaStream_t stream) {
  auto kern = fwd_probe_kernel<V, TM, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<TM>());
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + TM - 1) / TM;
  if (n <= 0 || blocks > INT_MAX || n_layers < 1 || n_layers > 16)
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NTHREADS, smem_bytes<TM>(), stream>>>(
      static_cast<const float*>(in8), static_cast<const float*>(pe),
      static_cast<const float*>(sm), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<OutT*>(out), n, n_layers);
  return (int)cudaGetLastError();
}

template <int V, typename OutT>
int by_tile(int tile, const void* in8, const void* pe, const void* sm, const void* w,
            const void* b, void* out, long long n, int n_layers, cudaStream_t s) {
  switch (tile) {
    case 32: return launch<V, 32, OutT>(in8, pe, sm, w, b, out, n, n_layers, s);
    case 64: return launch<V, 64, OutT>(in8, pe, sm, w, b, out, n, n_layers, s);
    case 128: return launch<V, 128, OutT>(in8, pe, sm, w, b, out, n, n_layers, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename OutT>
int by_variant(int variant, int tile, const void* in8, const void* pe, const void* sm,
               const void* w, const void* b, void* out, long long n, int n_layers,
               cudaStream_t s) {
  switch (variant) {
    case FULL: return by_tile<FULL, OutT>(tile, in8, pe, sm, w, b, out, n, n_layers, s);
    case NOSIN: return by_tile<NOSIN, OutT>(tile, in8, pe, sm, w, b, out, n, n_layers, s);
    case NOPE: return by_tile<NOPE, OutT>(tile, in8, pe, sm, w, b, out, n, n_layers, s);
    case NORELU: return by_tile<NORELU, OutT>(tile, in8, pe, sm, w, b, out, n, n_layers, s);
    case NOBIAS: return by_tile<NOBIAS, OutT>(tile, in8, pe, sm, w, b, out, n, n_layers, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// in8 [n, 8] f32, pe [8, 128] f32, sm [128] f32, w: flat bf16 weights
// (W_0 [128, 256] then W_1.. [256, 256], each [in, out] row-major), b
// [n_layers, 256] f32, out [n, 128] bf16 (out_f32 = 0) or f32.  variant:
// 0 full, 1 nosin, 2 nope, 3 norelu, 4 nobias; tile: 32, 64 or 128
// points per block.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int fwd_probe(const void* in8, const void* pe, const void* sm, const void* w,
                         const void* b, void* out, long long n, int n_layers, int variant,
                         int tile, int out_f32, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return out_f32 ? by_variant<float>(variant, tile, in8, pe, sm, w, b, out, n, n_layers, s)
                 : by_variant<bf16>(variant, tile, in8, pe, sm, w, b, out, n, n_layers, s);
}
