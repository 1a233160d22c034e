// Attribution probe for the fused-MLP forward (kernel 1) on Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU probe kernel `make_kernel` of tools_fwd_probe.py
// (launched there by `run`, its weights resident in VMEM): stripped-down
// variants of the forward's own structure, timed one by one to say where
// kernel 1's time goes.  Per point it computes
//   z = sum_{d<7} in8[d] * pe[d]           (separately rounded fp32 multiply-adds)
//   feat = full:   sm*sin(z) + (1-sm)*z
//          nosin:  z
//          nope:   in8[0] * 0.01 in every column (no PE at all)
//   h = feat; L times: o = bf16(h) @ bf16(W_i) (fp32 accumulation), then
//          full, nosin, nope: h = relu(o + b_i)   nobias: h = relu(o)   norelu: h = o
//   out = h[:, :128] as bf16 or fp32.
// W_0 is [128, 256], W_1.. are [256, 256]; L is 1 to 16.
//
// Bound: operations.  2*N*(128*256 + (L-1)*256^2) FLOP (193.3 GFLOP at
// L = 8 and N = 196,608: 0.195 ms at 989 TFLOP/s) against 32 bytes in and
// 256 bytes out per point (0.017 ms at 3.35 TB/s).  Every layer's products
// run at full width, the last one's too, as the Pallas probe computes them.
//
// Design: kernel 1's (fused_mlp_fwd.cu), so that what the probe measures
// speaks for kernel 1's tile chain without its heads.
//  0. `probe_wimg_kernel`: the weight image, every 64-row K-slab of the
//     stacked weights (2 of W_0, then 4 of each W_i: 2 + 4(L-1) slabs of
//     32 KB), each laid out byte for byte as it sits in a ring stage: 4
//     atoms of 64 k-rows by 64 columns, 128-byte swizzled (hopper_mma.cuh).
//     Built once per set of probe weights.
//  1. `fwd_probe_kernel`: one block per tile of TM points, one block per
//     SM: two consumer warpgroups and a producer warp.  One thread of the
//     producer moves the image slab by slab into a STAGES-deep ring of
//     32 KB with one bulk copy each (an mbarrier per stage for full and one
//     for empty).  The activations stay in shared memory as K-major bf16
//     operands of 64-column atoms; every product is wgmma with both
//     operands in shared memory, one slab's products left in flight while
//     the next is issued.  Epilogues work on the accumulator registers
//     (the variant's bias, its ReLU, bf16 pairs into the next product's
//     operand).  The last layer's columns 0..127 are staged in a free
//     activation buffer and stored 16 bytes at a time, rows past n masked;
//     the output type is a runtime branch of that store.
//     - TM = 64, kernel 1's tile: the two warpgroups split the 256 output
//       columns (m64n128k16 each) of the same 64 rows; two ping-pong
//       buffers, the PE features in the first two atoms of one; a barrier
//       of both warpgroups before each layer's products.  The bias of the
//       thread's 32 columns is loaded before the product.
//     - TM = 128: each warpgroup owns 64 rows and all 256 columns
//       (m64n256k16, 128 accumulator registers per thread), its
//       activations overwritten in place once its products have drained,
//       and only its own barrier before each layer: the warpgroups are
//       coupled by the ring alone (a stage frees when both are done with
//       it).  Beside 128 accumulators the bias is read from L1 in the
//       epilogue.
//     Shared memory: 64 KB of activations (two 32 KB buffers in either
//     tile) and the ring.
// No atomics: two launches on the same inputs give bitwise-equal outputs.
// A lost mbarrier arrival or byte count traps (hopper_mma.cuh:mbar_wait).
// The PE angles are separately rounded fp32 multiplies and adds, so they
// match the plain PyTorch version; sinf is the accurate libdevice sine
// (build without --use_fast_math).  The variant and the tile are template
// parameters; the layer count and the output type are kernel arguments.

#include <climits>

#include "fused_mlp_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace fmlp;

enum Variant { FULL = 0, NOSIN = 1, NOPE = 2, NORELU = 3, NOBIAS = 4 };

constexpr int PE_ROWS = 7;  // the probe sums in8 columns 0..6
constexpr int MAX_LAYERS = 16;

// Shared memory (byte offsets from a 1 KB boundary): two activation
// buffers of 64 rows x 256 bf16 (4 atoms of 64 rows x 64 columns, 8 KB
// each), the weight ring, its full and empty barriers.
constexpr int ATOM = 64 * 128;
constexpr int BUF = 4 * ATOM;
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 64 * W * 2;  // one K-slab: 64 rows of a [*, 256] weight
constexpr int SM_RING = 2 * BUF;
constexpr int SM_BARS = SM_RING + STAGES * STAGE_BYTES;
constexpr int PROBE_SMEM = SM_BARS + 2 * STAGES * 8 + 1024;  // + slack to align to 1 KB
static_assert(PROBE_SMEM <= 232448, "the probe exceeds a block's shared memory");
static_assert(NTHREADS == 256, "two consumer warpgroups");
constexpr int PROBE_THREADS = NTHREADS + 32;  // + the producer warp

// K-slabs of the image at L layers: 2 of W_0, 4 of each later W_i
__host__ __device__ constexpr int probe_slabs(int n_layers) {
  return IN_W / 64 + (n_layers - 1) * (W / 64);
}

template <int V>
__host__ __device__ constexpr bool has_bias() {
  return V == FULL || V == NOSIN || V == NOPE;
}

// The weight image: slab i holds rows 64i..64i+63 of the stacked weights
// [128 + 256(L-1), 256] (W_0's two slabs, then four of each W_i), laid out
// as it sits in a stage.  One block per slab.
__global__ void __launch_bounds__(NTHREADS)
probe_wimg_kernel(const bf16* __restrict__ w, bf16* __restrict__ img) {
  unsigned char* st = reinterpret_cast<unsigned char*>(img) + (long)blockIdx.x * STAGE_BYTES;
  const bf16* slab = w + (long)blockIdx.x * 64 * W;
  constexpr int cpr = W / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < 64 * cpr; e += NTHREADS) {
    const int row = e / cpr, c = e % cpr;
    *reinterpret_cast<uint4*>(st + (c >> 3) * ATOM + hmma::sw128(row, c & 7)) =
        *reinterpret_cast<const uint4*>(slab + row * W + c * 8);
  }
}

// The producer: one thread of the extra warp moves the image's n_slabs
// slabs into the ring, STAGES ahead of the consumers at most; a stage's
// `full` barrier completes when its bytes have landed, its `empty` barrier
// when the eight consumer warps are done with it.
__device__ __forceinline__ void produce(uint32_t ring, uint32_t full, uint32_t empty,
                                        const bf16* __restrict__ img, int n_slabs) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(img);
  for (int i = 0; i < n_slabs; ++i, src += STAGE_BYTES) {
    const int st = i % STAGES;
    if (i >= STAGES) hmma::mbar_wait(empty + st * 8, ((i / STAGES) - 1) & 1);
    hmma::mbar_expect_tx(full + st * 8, STAGE_BYTES);
    hmma::bulk_load(ring + st * STAGE_BYTES, src, STAGE_BYTES, full + st * 8);
  }
}

// The consumers' side of the ring: the index of the next slab to consume
struct Ring {
  uint32_t base, full, empty;
  int it;
};

// the barrier of the 256 consumer threads (the producer warp stays out)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// the barrier of this thread's warpgroup
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// byte offset of element (row, col) in a K-major buffer of 64-column atoms
__device__ __forceinline__ uint32_t kmaj(int row, int col) {
  return (uint32_t)((col >> 6) * ATOM) + hmma::sw128(row, (col & 63) >> 3) + (col & 7) * 2;
}

// acc[64 x NW] (this warpgroup's rows and columns) += A[64, 64 * kslabs]
// @ the next kslabs slabs of the ring.  NW = 128: the column split, this
// warpgroup's half of each slab, A written by both warpgroups; NW = 256:
// the row split, all of each slab, A this warpgroup's own.
template <int NW>
__device__ __forceinline__ void mma_slabs(float (&acc)[NW / 2], Ring& r, uint32_t a, int kslabs) {
  hmma::fence_proxy_async();  // the epilogues' shared writes, to wgmma's proxy
  if constexpr (NW == W)
    wg_sync();
  else
    consumer_sync();
  const uint32_t half = NW == W ? 0 : (threadIdx.x >> 7) * (NW / 64) * ATOM;
  int prev = -1;  // the stage of the slab whose products may still run
  for (int s = 0; s < kslabs; ++s) {
    const int st = r.it % STAGES;
    hmma::mbar_wait(r.full + st * 8, (r.it / STAGES) & 1);
    const uint32_t slab = r.base + st * STAGE_BYTES + half;
    hmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hmma::desc_sw128(a + s * ATOM + kk * 32, 16, 1024);
      const uint64_t db = hmma::desc_sw128(slab + kk * 2048, ATOM, 1024);
      if constexpr (NW == W)
        hmma::wgmma_m64n256k16<0, 1>(acc, da, db, 1);
      else
        hmma::wgmma_m64n128k16<0, 1>(acc, da, db, 1);
    }
    hmma::wgmma_commit();
    if (prev >= 0) {  // the previous slab's products are done: its stage is free
      hmma::wgmma_wait<1>();
      if ((threadIdx.x & 31) == 0) hmma::mbar_arrive(r.empty + prev * 8);
    }
    prev = st;
    ++r.it;
  }
  hmma::wgmma_wait<0>();
  if ((threadIdx.x & 31) == 0) hmma::mbar_arrive(r.empty + prev * 8);
  hmma::fence_regs(acc);
}

// The bias of this warpgroup's NW columns, pair j of the accumulator's
// column order (columns 8j + 2(t % 4) + 0, 1).  The column split loads its
// 32 values before the product so that their latency hides behind it;
// the row split has no registers to spare beside its 128 accumulators and
// reads each pair from L1 in the epilogue.
template <int NW>
struct Bias;
template <>
struct Bias<W / 2> {
  float v[W / 8];  // 2 for each of the 16 column pairs
  __device__ __forceinline__ void load(const float* __restrict__ b) {
    const float* p = b + (threadIdx.x >> 7) * (W / 2) + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < W / 16; ++j) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p + j * 8));
      v[2 * j] = x.x;
      v[2 * j + 1] = x.y;
    }
  }
  __device__ __forceinline__ float2 at(int j) const { return make_float2(v[2 * j], v[2 * j + 1]); }
};
template <>
struct Bias<W> {
  const float* p;
  __device__ __forceinline__ void load(const float* __restrict__ b) {
    p = b + 2 * (threadIdx.x & 3);
  }
  __device__ __forceinline__ float2 at(int j) const {
    return __ldg(reinterpret_cast<const float2*>(p + j * 8));
  }
};

// The variant's epilogue of accumulator pair (4j + 2h, 4j + 2h + 1): the
// bias added in fp32 (full, nosin, nope), then the ReLU (all but norelu).
template <int V, int NW>
__device__ __forceinline__ float2 act(const float (&acc)[NW / 2], float2 bias, int j, int h) {
  float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
  if constexpr (has_bias<V>()) {
    v0 += bias.x;
    v1 += bias.y;
  }
  if constexpr (V != NORELU) {
    v0 = fmaxf(v0, 0.0f);
    v1 = fmaxf(v1, 0.0f);
  }
  return make_float2(v0, v1);
}

// Epilogue of this warpgroup's rows and NW columns: bf16(act(acc)) into
// the K-major buffer D, the next product's A (accumulator layout:
// hopper_mma.cuh).
template <int V, int NW>
__device__ __forceinline__ void epilogue(const float (&acc)[NW / 2], const Bias<NW>& bias,
                                         unsigned char* D) {
  const int lane = threadIdx.x & 31;
  const int c0 = NW == W ? 0 : (threadIdx.x >> 7) * NW;
  const int r0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    float2 b = make_float2(0.0f, 0.0f);
    if constexpr (has_bias<V>()) b = bias.at(j);
    const int col = c0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = act<V, NW>(acc, b, j, h);
      *reinterpret_cast<__nv_bfloat162*>(D + kmaj(r0 + 8 * h, col)) =
          __floats2bfloat162_rn(v.x, v.y);
    }
  }
}

// byte offset of byte `cb` of row `row` in a buffer of 128-byte atoms
__device__ __forceinline__ uint32_t rowmaj(int row, int cb) {
  return (uint32_t)((cb >> 7) * ATOM) + hmma::sw128(row, (cb & 127) >> 4) + (cb & 15);
}

// The output of this warpgroup's 64 rows: columns 0..127 of the last
// layer's act(acc) (the accumulator's first 64 registers) as bf16 or fp32,
// staged in the free buffer S (64 rows of 256 or 512 bytes, fp32 filling
// its 32 KB) and stored 16 bytes at a time; rows past n are not stored.
template <int V, int NW>
__device__ __forceinline__ void store_out(const float (&acc)[NW / 2], const Bias<NW>& bias,
                                          unsigned char* S, void* __restrict__ out, bool f32,
                                          long long row0, long long n) {
  const int lt = threadIdx.x & 127, lane = lt & 31;
  const int r0 = (lt >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < OUT_W / 8; ++j) {
    float2 b = make_float2(0.0f, 0.0f);
    if constexpr (has_bias<V>()) b = bias.at(j);
    const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = act<V, NW>(acc, b, j, h);
      if (f32)
        *reinterpret_cast<float2*>(S + rowmaj(r0 + 8 * h, col * 4)) = v;
      else
        *reinterpret_cast<__nv_bfloat162*>(S + rowmaj(r0 + 8 * h, col * 2)) =
            __floats2bfloat162_rn(v.x, v.y);
    }
  }
  wg_sync();
  const int esz = f32 ? 4 : 2, cpr = OUT_W * esz / 16;  // 16-byte chunks per output row
  unsigned char* o = static_cast<unsigned char*>(out);
  for (int e = lt; e < 64 * cpr; e += 128) {
    const int row = e / cpr, c = e % cpr;
    if (row0 + row < n)
      *reinterpret_cast<uint4*>(o + (row0 + row) * OUT_W * esz + c * 16) =
          *reinterpret_cast<const uint4*>(S + rowmaj(row, c * 16));
  }
}

// The variant's PE features of 64 rows from row0 into the K-major buffer
// `feat` (two atoms), by threads t, t + nt, ...; rows past n are 0.
template <int V>
__device__ __forceinline__ void compute_feat(unsigned char* feat, const float* __restrict__ in8,
                                             const float* __restrict__ pe,
                                             const float* __restrict__ smask, long long row0,
                                             long long n, int t, int nt) {
  for (int e = t; e < 64 * IN_W; e += nt) {
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
          const float m = smask[c];
          f = __fadd_rn(__fmul_rn(m, sinf(z)), __fmul_rn(1.0f - m, z));
        }
      }
    }
    *reinterpret_cast<bf16*>(feat + kmaj(i, c)) = __float2bfloat16(f);
  }
}

template <int V, int TM>
__global__ void __launch_bounds__(PROBE_THREADS, 1)
fwd_probe_kernel(const float* __restrict__ in8, const float* __restrict__ pe,
                 const float* __restrict__ smask, const bf16* __restrict__ img,
                 const float* __restrict__ b, void* __restrict__ out, long long n, int n_layers,
                 int out_f32) {
  constexpr int NW = TM == 64 ? W / 2 : W;  // accumulator columns per warpgroup
  extern __shared__ __align__(128) unsigned char probe_smem[];
  unsigned char* sm = probe_smem + ((1024u - (hmma::smem_u32(probe_smem) & 1023u)) & 1023u);
  const uint32_t sa = hmma::smem_u32(sm);
  Ring ring{sa + SM_RING, sa + SM_BARS, sa + SM_BARS + STAGES * 8, 0};
  if (threadIdx.x == 0)
    for (int st = 0; st < STAGES; ++st) {
      hmma::mbar_init(ring.full + st * 8, 1);   // the producer's expect_tx
      hmma::mbar_init(ring.empty + st * 8, 8);  // the eight consumer warps
    }
  hmma::fence_mbar_init();
  __syncthreads();
  if (threadIdx.x >= NTHREADS) {  // the producer warp
    if (threadIdx.x == NTHREADS) produce(ring.base, ring.full, ring.empty, img, probe_slabs(n_layers));
    return;
  }
  const int wg = threadIdx.x >> 7;
  long long row0 = (long long)blockIdx.x * TM;
  int src, dst;  // byte offsets of the layer's operand and of its epilogue's buffer
  if constexpr (TM == 64) {  // ping-pong; the features in the second buffer
    src = BUF;
    dst = 0;
    compute_feat<V>(sm + src, in8, pe, smask, row0, n, threadIdx.x, NTHREADS);
  } else {  // each warpgroup's rows in its own buffer, in place
    row0 += wg * 64;
    src = dst = wg * BUF;
    compute_feat<V>(sm + src, in8, pe, smask, row0, n, threadIdx.x & 127, 128);
  }
  float acc[NW / 2];
  Bias<NW> bias;
  int kslabs = IN_W / 64;
  for (int l = 0;; ++l) {
    zero_acc(acc);
    if constexpr (has_bias<V>()) bias.load(b + l * W);
    mma_slabs<NW>(acc, ring, sa + src, kslabs);
    if (l == n_layers - 1) break;
    epilogue<V, NW>(acc, bias, sm + dst);
    kslabs = W / 64;
    if constexpr (TM == 64) {
      const int t = src;
      src = dst;
      dst = t;
    }
  }
  // the last layer: columns 0..127 only, into the buffer it did not read
  // (the column split) or its own once drained (the row split)
  if (TM == 64 && wg == 1) return;
  store_out<V, NW>(acc, bias, sm + dst, out, out_f32 != 0, row0, n);
}

template <int V, int TM>
int launch(const void* in8, const void* pe, const void* smask, const void* img, const void* b,
           void* out, long long n, int n_layers, int out_f32, cudaStream_t stream) {
  auto kern = fwd_probe_kernel<V, TM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, PROBE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + TM - 1) / TM;
  if (n <= 0 || blocks > INT_MAX || n_layers < 1 || n_layers > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, PROBE_THREADS, PROBE_SMEM, stream>>>(
      static_cast<const float*>(in8), static_cast<const float*>(pe),
      static_cast<const float*>(smask), static_cast<const bf16*>(img),
      static_cast<const float*>(b), out, n, n_layers, out_f32);
  return (int)cudaGetLastError();
}

template <int V>
int by_tile(int tile, const void* in8, const void* pe, const void* smask, const void* img,
            const void* b, void* out, long long n, int n_layers, int out_f32, cudaStream_t s) {
  switch (tile) {
    case 64: return launch<V, 64>(in8, pe, smask, img, b, out, n, n_layers, out_f32, s);
    case 128: return launch<V, 128>(in8, pe, smask, img, b, out, n, n_layers, out_f32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// w: the flat bf16 weights (W_0 [128, 256] then W_1.. [256, 256], each
// [in, out] row-major); img: as many bf16, the weight image of fwd_probe.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int fwd_probe_image(const void* w, void* img, int n_layers, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  probe_wimg_kernel<<<probe_slabs(n_layers), NTHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(img));
  return (int)cudaGetLastError();
}

// in8 [n, 8] f32, pe [8, 128] f32, sm [128] f32, img: the weight image of
// n_layers layers from fwd_probe_image, b [n_layers, 256] f32, out [n, 128]
// bf16 (out_f32 = 0) or f32.  variant: 0 full, 1 nosin, 2 nope, 3 norelu,
// 4 nobias; tile: 64 or 128 points per block.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int fwd_probe(const void* in8, const void* pe, const void* sm, const void* img,
                         const void* b, void* out, long long n, int n_layers, int variant,
                         int tile, int out_f32, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FULL: return by_tile<FULL>(tile, in8, pe, sm, img, b, out, n, n_layers, out_f32, s);
    case NOSIN: return by_tile<NOSIN>(tile, in8, pe, sm, img, b, out, n, n_layers, out_f32, s);
    case NOPE: return by_tile<NOPE>(tile, in8, pe, sm, img, b, out, n, n_layers, out_f32, s);
    case NORELU: return by_tile<NORELU>(tile, in8, pe, sm, img, b, out, n, n_layers, out_f32, s);
    case NOBIAS: return by_tile<NOBIAS>(tile, in8, pe, sm, img, b, out, n, n_layers, out_f32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
