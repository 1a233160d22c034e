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
// Bound, on an H100 (989 TFLOP/s bf16, 3.35 TB/s).  Operations: the
// network needs 695,680 multiply-adds per point with 27 semantic classes
// (1.39 MFLOP) against 32 bytes in and 256 bytes out, about 4,800 FLOP per
// byte of device memory, far above the card's ~295 FLOP/B balance point.
// The padded packed layout (PE rows 63 -> 128, head outputs -> 128
// columns) makes the kernel do 835,584 multiply-adds per point, 20% more.
// On chip, three things stand between a tile and that bound: the tile's
// serial chain (each layer's products need the whole previous layer, so
// products, epilogues and barriers alternate), the positional encoding
// (8 dependent fp32 multiply-adds and an accurate sine for each of a
// tile's 8,192 features, no tensor core: a third of the kernel when the
// consumers computed it before their chain, tools/fwd_ablate.py, PERF.md)
// and the weights (all 1.67 MB of bf16 pass from L2 into shared memory
// once per 64-point tile, about 64 FLOP of products per byte).  The
// design takes the encoding and the weight stream off the chain's path,
// so the chain of epilogues and barriers is what holds the kernel above
// its bound, and with the encoding hidden the L2 weight stream is the
// next wall.
//
// Design.
//  0. `fwd_wimg_kernel`: the weight image, every K-slab of the 20 weight
//     blocks (64 rows of W [in, out]) in the order the products consume
//     them, 66 slabs, each laid out byte for byte as it sits in a stage of
//     the ring below: N/64 atoms of 64 k-rows by 64 columns, 128-byte
//     swizzled (hopper_mma.cuh).  Built once per set of weights.
//  1. `fused_mlp_fwd_kernel`: persistent, one block per SM (218 KB of
//     shared memory), min(tiles, SMs) blocks; block b walks the 64-point
//     tiles b, b + grid, b + 2 grid, ... in order.  Three warpgroups:
//     - two consumer warpgroups run each tile's chain.  They keep the
//       tile's activations in shared memory as K-major operands of
//       64-column atoms (the PE features, two trunk buffers, a head
//       buffer); every product is wgmma m64nNk16 with both operands in
//       shared memory, the two warpgroups splitting the output columns
//       (N = 128 each for a 256-wide layer, 64 for a 128-wide one), one
//       slab's products left in flight while the next is issued.
//       Epilogues work on the accumulator registers: the bias (loaded
//       before the product), ReLU, and bf16 pairs straight into the next
//       product's operand.  The packed output is accumulated in registers
//       while the heads are computed (H@w_sig, then f, v and v@w_r, a1 and
//       a1@w_a2, s1 and s1@w_s2, m1 and m1@w_m2), then gets the summed
//       output bias, is rounded to bf16, staged in the tile's feature
//       buffer and stored 16 bytes at a time, rows past P masked;
//     - in the third, one thread of its first warp (the producer) moves
//       the image slab by slab, once per tile, into a 3-stage ring of
//       32 KB with one bulk copy each (the copy engine; an mbarrier per
//       stage for full and one for empty), running ahead of the consumers
//       across layers, epilogues and tiles;
//     - its other three warps (the PE warps) stage F and the sine mask in
//       shared memory once, then for each tile its in8 rows (16-byte
//       loads, into one of two slots) and its features into one of two
//       feature buffers: tile j's buffer j % 2 as soon as the consumers
//       release tile j - 2's, so they encode tile j + 1 while the
//       consumers run tile j.  A buffer has a full mbarrier (each PE
//       thread arrives after a proxy fence: wgmma reads through the async
//       proxy) and an empty one (each consumer warp arrives after the
//       tile's last read of it, the output staging).  A block with one
//       tile pays its encoding up front.
//     setmaxnreg gives the consumers the registers the third warpgroup
//     does not need.
//  2. The training launch (`fused_mlp_fwd_save`, the kernel's SAVE
//     instance) runs the same chain and also writes the saved forward that
//     the backward (fused_mlp_bwd.cu) reads instead of recomputing it
//     (fused_mlp_common.cuh): after each of the 13 epilogues (act0..act7,
//     f, v, a1, s1, m1) the warpgroup's first thread bulk-stores its atoms
//     of the buffer, as they sit in shared memory, and the tile's features
//     once; each ReLU epilogue also sets one bit per accumulator register
//     where the fp32 value is positive and stores the thread's mask words
//     (8 bytes, a warp's 256 in a row).  A product's first thread of each
//     warpgroup waits, before the barrier that opens it, until all but the
//     warpgroup's newest store have read their buffers, since its epilogue
//     may overwrite them.  The stores mark their lines first to go from L2
//     and the weight image's loads theirs last, so that the saved forward
//     does not push the image out.  The packed output is bitwise the
//     serving launch's, and the saved activations and masks are those the
//     backward would recompute.  The serving instance writes none of it and
//     has the shared memory and registers it had without the switch.
//     Bytes: 6,272 per point (2,944 bf16 and 384 B of masks), 1.23 GB for
//     the training step's fine call, 0.37 ms at the memory's rate beside
//     the chain's 0.70.
// No atomics, and each tile's output depends on its own rows alone: two
// launches on the same inputs, or on any 64-aligned slice of them, give
// bitwise-equal rows.  A lost mbarrier arrival or byte count traps
// (hopper_mma.cuh:mbar_wait), so a pipeline fault fails the launch
// instead of hanging the card.
// The PE angles are separately rounded fp32 multiplies and adds in the
// plain version's order (no tensor core), so they match it bit for bit;
// sinf is the accurate libdevice sine (build without --use_fast_math).

#include <climits>

#include "fused_mlp_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace fmlp;

// Shared memory of one block (byte offsets from a 1 KB boundary).
// Every activation buffer is K-major for the next product: 64-column atoms
// of 64 rows (hopper_mma.cuh), 8 KB each.
//  feat: two buffers [0, 32K) of a tile's PE features, 16 KB each
//  bufA [32K, 64K)  bufB [64K, 96K)  head [96K, 112K)
//  weight ring: STAGES x 32 KB, one K-slab of 64 of a weight block each
//  the PE's inputs (fp32): F [8, 128] and the sine mask [128], then two
//    slots of a tile's in8 rows [64, 8]
//  barriers: the ring's full and empty, one each per stage, then the feat
//    buffers' full and empty, one each per buffer
// A tile's output is staged in its own feat buffer once v has read it.
constexpr int ATOM = 64 * 128;  // one 64-row atom
constexpr int FEAT_BYTES = 2 * ATOM;  // a tile's 128 features
constexpr int OV_FEAT = 0, OV_BUFA = 32768, OV_BUFB = 65536, OV_HEAD = 98304;
constexpr int SM_RING = 114688;
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 32768;
constexpr int SM_PE = SM_RING + STAGES * STAGE_BYTES;
constexpr int IN_SLOT = TILE_M * IN8_W * 4;  // a tile's in8 rows
constexpr int SM_IN = SM_PE + (IN8_W + 1) * IN_W * 4;
constexpr int SM_BARS = SM_IN + 2 * IN_SLOT;
constexpr int FWD_SMEM = SM_BARS + (2 * STAGES + 4) * 8 + 1024;  // + slack to align to 1 KB
static_assert(FWD_SMEM <= 232448, "the forward exceeds a block's shared memory");
static_assert(OV_FEAT + 2 * FEAT_BYTES == OV_BUFA && SM_RING % 1024 == 0, "the atoms' layout");
static_assert(NTHREADS == 256, "two consumer warpgroups");
// + the third warpgroup: the producer warp, then the PE warps
constexpr int FWD_THREADS = NTHREADS + 128;
constexpr int PE_THREADS = 96;
// registers a thread after setmaxnreg: 128 x 88 + 256 x 208 = 384 x 168,
// the block's share of the SM's 65,536 at launch
constexpr int PE_REGS = 88, CONSUMER_REGS = 208;

// The products' weight blocks W [in, out] in the order the consumers take
// them, each streamed as in/64 K-slabs of 64 rows (MN-major: out/64 atoms).
struct Seg {
  int w_off, K, N;
};
#define SEG(off, in, out) {(int)(off), in, out}
#define SEG_TABLE                                                                          \
  {SEG(OFF_W0, IN_W, W),   SEG(OFF_W1, W, W),      SEG(OFF_W2, W, W),    SEG(OFF_W3, W, W), \
   SEG(OFF_W4, W, W),      SEG(OFF_W5H, W, W),     SEG(OFF_W5X, IN_W, W), SEG(OFF_W6, W, W), \
   SEG(OFF_W7, W, W),      SEG(OFF_WSIG, W, OUT_W), SEG(OFF_WF, W, W),   SEG(OFF_WVF, W, HW), \
   SEG(OFF_WVD, IN_W, HW), SEG(OFF_WR, HW, OUT_W), SEG(OFF_WA1, W, HW),  SEG(OFF_WA2, HW, OUT_W), \
   SEG(OFF_WS1, W, HW),    SEG(OFF_WS2, HW, OUT_W), SEG(OFF_WM1, W, HW), SEG(OFF_WM2, HW, OUT_W)}
constexpr int N_SEGS = 20;
constexpr Seg kSegs[N_SEGS] = SEG_TABLE;
__constant__ Seg c_segs[N_SEGS] = SEG_TABLE;
#undef SEG_TABLE
#undef SEG

constexpr int count_slabs() {
  int n = 0;
  for (const Seg& s : kSegs) n += s.K / 64;
  return n;
}
constexpr long image_elems() {
  long n = 0;
  for (const Seg& s : kSegs) n += (long)s.K * s.N;
  return n;
}
constexpr int FWD_SLABS = 66;          // K-slabs per tile
constexpr long FWD_IMG_ELEMS = 835584;  // bf16 in the weight image
static_assert(FWD_SLABS == count_slabs(), "slab count changed");
static_assert(FWD_IMG_ELEMS == image_elems() && FWD_IMG_ELEMS == W_TOTAL,
              "the image holds every weight once");

// The weight image: every slab in c_segs order, laid out byte for byte as
// it sits in a stage (64 * N bf16 each), so that the producer moves a slab
// with one bulk copy.  One block per slab.
__global__ void __launch_bounds__(NTHREADS)
fwd_wimg_kernel(const bf16* __restrict__ w, bf16* __restrict__ img) {
  int i = blockIdx.x, seg = 0;
  long off = 0;
  for (; seg < N_SEGS - 1 && i >= c_segs[seg].K / 64; ++seg) {
    i -= c_segs[seg].K / 64;
    off += (long)c_segs[seg].K * c_segs[seg].N;
  }
  const Seg s = c_segs[seg];
  unsigned char* st = reinterpret_cast<unsigned char*>(img + off + (long)i * 64 * s.N);
  const int k0 = i * 64, cpr = s.N >> 3;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < 8 * s.N; e += NTHREADS) {
    const int row = e / cpr, c = e % cpr;  // rows k of the slab: W[k0 + k, :]
    const bf16* src = w + s.w_off + (long)(k0 + row) * s.N + c * 8;
    *reinterpret_cast<uint4*>(st + (c >> 3) * ATOM + hmma::sw128(row, c & 7)) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// The producer: one thread of the third warpgroup moves the weight image
// into the ring, slab by slab, once for each of the block's tiles, STAGES
// ahead of the consumers at most; a stage's `full` barrier completes when
// its bytes have landed, its `empty` barrier when the eight consumer warps
// are done with it.  The ring's count runs on across tiles, so the next
// tile's first slabs land while this tile's output is stored.  A saving
// launch marks the image's lines last to go from L2, so that the saved
// buffer's streams pass around it.
template <bool SAVE>
__device__ __forceinline__ void produce(uint32_t ring, uint32_t full, uint32_t empty,
                                        const bf16* __restrict__ img, int tiles) {
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(img);
    for (int seg = 0; seg < N_SEGS; ++seg) {
      const uint32_t bytes = 128 * c_segs[seg].N;  // 64 x N bf16
      for (int k = 0; k < c_segs[seg].K / 64; ++k, ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) hmma::mbar_wait(empty + st * 8, ((i / STAGES) - 1) & 1);
        hmma::mbar_expect_tx(full + st * 8, bytes);
        if constexpr (SAVE)
          hmma::bulk_load_evict_last(ring + st * STAGE_BYTES, src, bytes, full + st * 8);
        else
          hmma::bulk_load(ring + st * STAGE_BYTES, src, bytes, full + st * 8);
        src += bytes;
      }
    }
  }
}

// The consumers' side of the ring: the index of the next slab to consume
struct Ring {
  uint32_t base, full, empty;
  int it;
};

// the barrier of the 256 consumer threads (the third warpgroup stays out)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// the barrier of this thread's warpgroup
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

// the barrier of the PE warps
__device__ __forceinline__ void pe_sync() {
  asm volatile("bar.sync 4, %0;\n" ::"n"(PE_THREADS) : "memory");
}

// acc[64 x NW] (this warpgroup's columns) += A[64, 64 * kslabs] @ the next
// kslabs slabs of the ring.  A: a K-major activation buffer at shared
// address `a`, written by both warpgroups' epilogues before this call.
// In a saving launch, the saved-buffer store before this warpgroup's
// newest may still read a buffer that this product's epilogue overwrites:
// its first thread waits for it (the buffers alternate, so it is a product
// old) before the barrier, which holds every consumer behind the wait.
template <bool SAVE, int NW>
__device__ __forceinline__ void mma_slabs(float (&acc)[NW / 2], Ring& r, uint32_t a, int kslabs) {
  const int wg = threadIdx.x >> 7;
  if constexpr (SAVE)
    if ((threadIdx.x & 127) == 0) hmma::bulk_wait<1, 1>();
  hmma::fence_proxy_async();  // the epilogues' shared writes, to wgmma's proxy
  consumer_sync();
  int prev = -1;  // the stage of the slab whose products may still run
  for (int s = 0; s < kslabs; ++s) {
    const int st = r.it % STAGES;
    hmma::mbar_wait(r.full + st * 8, (r.it / STAGES) & 1);
    const uint32_t slab = r.base + st * STAGE_BYTES;
    hmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hmma::desc_sw128(a + s * ATOM + kk * 32, 16, 1024);
      const uint64_t db = hmma::desc_sw128(slab + wg * (NW / 64) * ATOM + kk * 2048, ATOM, 1024);
      if constexpr (NW == 128)
        hmma::wgmma_m64n128k16<0, 1>(acc, da, db, 1);
      else
        hmma::wgmma_m64n64k16<0, 1>(acc, da, db, 1);
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

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// byte offset of element (row, col) in a K-major buffer of 64-column atoms
__device__ __forceinline__ uint32_t kmaj(int row, int col) {
  return (uint32_t)((col >> 6) * ATOM) + hmma::sw128(row, (col & 63) >> 3) + (col & 7) * 2;
}

// the bias of this warpgroup's NW columns in the accumulator's column
// order, loaded before the product so that its latency hides behind it
template <int NW>
__device__ __forceinline__ void load_bias(float (&bv)[NW / 4], const float* __restrict__ bias) {
  const int col = (threadIdx.x >> 7) * NW + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    bv[2 * j] = __ldg(bias + col + j * 8);
    bv[2 * j + 1] = __ldg(bias + col + j * 8 + 1);
  }
}

// Where a saving launch writes tile t of the saved forward (the layout of
// fused_mlp_common.cuh).  Its fields are the kernel's parameters and the
// tile's index, so the addresses below are formed where they are used and
// hold no registers across the chain.
struct SavedTile {
  bf16* base;
  long long p_pad;
  int t;
};

// This warpgroup's NW columns of the K-major shared buffer S (its atoms
// from wg * NW / 64) to the same atoms of the tile's saved buffer at
// column offset `col` (a buffer 2 * NW wide): one bulk store by the
// warpgroup's first thread, in a bulk group of its own.
template <int NW>
__device__ __forceinline__ void store_atoms(const unsigned char* S, const SavedTile& sv, int col) {
  const uint32_t off = (threadIdx.x >> 7) * NW * 128;
  if ((threadIdx.x & 127) == 0) {
    unsigned char* G = reinterpret_cast<unsigned char*>(
        sv.base + col * sv.p_pad + (long long)sv.t * TILE_M * (2 * NW));
    hmma::bulk_store(G + off, hmma::smem_u32(S) + off, NW * 128);
    hmma::bulk_commit();
  }
}

// acc = (this warpgroup's columns of) A @ the next kslabs slabs, and the
// bias of a head's product into bv: the serving launch loads the bias
// before the product, so that its latency hides behind it; a saving launch
// after, for beside the packed output's accumulators its registers would
// spill.
template <bool SAVE, int NW>
__device__ __forceinline__ void head_product(float (&acc)[NW / 2], float (&bv)[NW / 4],
                                             const float* __restrict__ bias, Ring& r, uint32_t a,
                                             int kslabs) {
  zero_acc(acc);
  if constexpr (!SAVE) load_bias<NW>(bv, bias);
  mma_slabs<SAVE, NW>(acc, r, a, kslabs);
  if constexpr (SAVE) load_bias<NW>(bv, bias);
}

// Epilogue of this warpgroup's NW columns: bf16(act(acc + bias)) into the
// K-major buffer D, the next product's A (accumulator layout:
// hopper_mma.cuh).  A saving launch also stores the thread's mask words of
// ReLU layer `layer` (a bit per register, set where the fp32 value is
// positive; lines first to go from L2) and the columns to the tile's saved
// forward (buffer column `col`).
template <bool SAVE, int NW>
__device__ __forceinline__ void epilogue(const float (&acc)[NW / 2], const float (&bv)[NW / 4],
                                         bool relu, unsigned char* D, const SavedTile& sv,
                                         int col, int layer = 0) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  uint32_t bits[NW / 64] = {};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = wg * NW + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      float v0 = acc[i] + bv[2 * j], v1 = acc[i + 1] + bv[2 * j + 1];
      if (relu) {
        if constexpr (SAVE) {
          bits[i >> 5] |= (v0 > 0.0f ? 1u : 0u) << (i & 31);
          bits[i >> 5] |= (v1 > 0.0f ? 1u : 0u) << ((i + 1) & 31);
        }
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(D + kmaj(r0 + 8 * h, col)) = __floats2bfloat162_rn(v0, v1);
    }
  }
  if constexpr (SAVE) {
    if (relu) {
      uint32_t* mask = reinterpret_cast<uint32_t*>(sv.base + SV_COLS * sv.p_pad) +
                       (long long)sv.t * MASK_WORDS + layer * (NTHREADS * 2) + threadIdx.x * 2;
      if constexpr (NW == 128)
        __stcs(reinterpret_cast<uint2*>(mask), make_uint2(bits[0], bits[1]));
      else
        __stcs(mask, bits[0]);
    }
    hmma::fence_proxy_async();  // D, to the bulk store's proxy
    wg_sync();
    store_atoms<NW>(D, sv, col);
  }
}

// The packed output of this warpgroup's 64 columns: bf16(acc + the summed
// output bias) staged in one atom of S, then stored 16 bytes at a time,
// eight threads to a row's 128 bytes; rows past n are not stored.
__device__ __forceinline__ void store_out(const float (&acc)[32], const float (&bv)[16],
                                          unsigned char* S, bf16* __restrict__ out,
                                          long long row0, long long n) {
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127, lane = lt & 31;
  const int r0 = (lt >> 5) * 16 + (lane >> 2);
  unsigned char* A = S + wg * ATOM;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(A + kmaj(r0 + 8 * h, j * 8 + 2 * (lane & 3))) =
          __floats2bfloat162_rn(acc[i] + bv[2 * j], acc[i + 1] + bv[2 * j + 1]);
    }
  wg_sync();
#pragma unroll
  for (int e = lt; e < 64 * 8; e += 128) {
    const int row = e >> 3, c = e & 7;
    if (row0 + row < n)
      *reinterpret_cast<uint4*>(out + (row0 + row) * OUT_W + wg * 64 + c * 8) =
          *reinterpret_cast<const uint4*>(A + hmma::sw128(row, c));
  }
}

// PE features of a tile into the K-major buffer `feat` (two atoms), by
// the PE warps from the tile's in8 rows `x` and F and the mask `pe` in
// shared memory: z = in8 @ F as separately rounded fp32 products and sums
// (k = 0..7, as the plain version adds them), then feat = m ? sin(z) : z;
// rows past n are 0.
__device__ __forceinline__ void compute_feat(unsigned char* feat, const float* x_s,
                                             const float* pe, long long row0, long long n) {
  for (int e = threadIdx.x - (NTHREADS + 32); e < TILE_M * IN_W; e += PE_THREADS) {
    const int i = e / IN_W, c = e % IN_W;
    float f = 0.0f;
    if (row0 + i < n) {
      const float* x = x_s + i * IN8_W;
      float z = __fmul_rn(x[0], pe[c]);
#pragma unroll
      for (int k = 1; k < IN8_W; ++k) z = __fadd_rn(z, __fmul_rn(x[k], pe[k * IN_W + c]));
      f = pe[IN8_W * IN_W + c] != 0.0f ? sinf(z) : z;
    }
    *reinterpret_cast<bf16*>(feat + kmaj(i, c)) = __float2bfloat16(f);
  }
}

// The PE warps: F and the sine mask staged once; then for the block's j-th
// tile its in8 rows staged in slot j % 2 (16-byte loads, rows past n
// zero) and its features computed into feat buffer j % 2 once the
// consumers have released that buffer's last tile, j - 2: the encoding of
// tile j runs while the consumers run tile j - 1.
__device__ __forceinline__ void encode(unsigned char* sm, uint32_t feat_full,
                                       uint32_t feat_empty, const float* __restrict__ in8,
                                       const float* __restrict__ pe_mat,
                                       const float* __restrict__ sin_mask, long long n,
                                       int tiles) {
  const int pt = threadIdx.x - (NTHREADS + 32);
  float* pe = reinterpret_cast<float*>(sm + SM_PE);
  for (int e = pt; e < IN8_W * IN_W; e += PE_THREADS) pe[e] = pe_mat[e];
  for (int e = pt; e < IN_W; e += PE_THREADS) pe[IN8_W * IN_W + e] = sin_mask[e];
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const int buf = j & 1;
    const long long row0 = (long long)t * TILE_M;
    float4* x_s = reinterpret_cast<float4*>(sm + SM_IN + buf * IN_SLOT);
    const float4* x_g = reinterpret_cast<const float4*>(in8 + row0 * IN8_W);
    for (int e = pt; e < TILE_M * IN8_W / 4; e += PE_THREADS)  // two 16-byte chunks a row
      x_s[e] = row0 + e / 2 < n ? __ldg(x_g + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // the slot (and F) written; every PE thread is past tile j - 2's reads of it
    pe_sync();
    if (j >= 2) hmma::mbar_wait(feat_empty + buf * 8, ((j >> 1) - 1) & 1);
    compute_feat(sm + OV_FEAT + buf * FEAT_BYTES, reinterpret_cast<const float*>(x_s), pe, row0,
                 n);
    hmma::fence_proxy_async();  // the features, to wgmma's proxy
    hmma::mbar_arrive(feat_full + buf * 8);
  }
}

// The forward of the points in8 [n, 8] into out [n, 128].  SAVE: the
// training launch, which also writes the saved forward (saved[], the
// layout of fused_mlp_common.cuh) for the backward; otherwise `saved` is
// unused and the launch writes `out` alone.
template <bool SAVE>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fused_mlp_fwd_kernel(const float* __restrict__ in8, const float* __restrict__ pe_mat,
                     const float* __restrict__ sin_mask, const bf16* __restrict__ img,
                     const float* __restrict__ b, bf16* __restrict__ out,
                     bf16* __restrict__ saved, long long n) {
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  unsigned char* sm = fwd_smem + ((1024u - (hmma::smem_u32(fwd_smem) & 1023u)) & 1023u);
  const uint32_t sa = hmma::smem_u32(sm);
  Ring ring{sa + SM_RING, sa + SM_BARS, sa + SM_BARS + STAGES * 8, 0};
  const uint32_t feat_full = sa + SM_BARS + 2 * STAGES * 8, feat_empty = feat_full + 16;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      hmma::mbar_init(ring.full + st * 8, 1);   // the producer's expect_tx
      hmma::mbar_init(ring.empty + st * 8, 8);  // the eight consumer warps
    }
    for (int f = 0; f < 2; ++f) {
      hmma::mbar_init(feat_full + f * 8, PE_THREADS);  // every PE thread
      hmma::mbar_init(feat_empty + f * 8, 8);          // the eight consumer warps
    }
  }
  hmma::fence_mbar_init();
  __syncthreads();
  // each role counts the tiles after setmaxnreg, so that no value is held
  // across it (a saving build spilled the count there)
  if (threadIdx.x >= NTHREADS) {  // the third warpgroup: the producer, the PE warps
    hmma::setmaxnreg_dec<PE_REGS>();
    const int tiles = (int)((n + TILE_M - 1) / TILE_M);
    if (threadIdx.x == NTHREADS)
      produce<SAVE>(ring.base, ring.full, ring.empty, img, tiles);
    else if (threadIdx.x >= NTHREADS + 32)
      encode(sm, feat_full, feat_empty, in8, pe_mat, sin_mask, n, tiles);
  } else {  // the consumers
    hmma::setmaxnreg_inc<CONSUMER_REGS>();
    const int tiles = (int)((n + TILE_M - 1) / TILE_M);
    float acc2[64], bv2[32];  // a 256-wide product: 128 columns per warpgroup
    float acc1[32], bv1[16];  // a 128-wide product: 64 columns per warpgroup
    float oacc[32], bvo[16];  // the packed output, 64 columns per warpgroup
    int j = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
      const int buf = j & 1;
      const uint32_t feat = sa + OV_FEAT + buf * FEAT_BYTES;
      const SavedTile sv{saved, (long long)tiles * TILE_M, t};
      hmma::mbar_wait(feat_full + buf * 8, (j >> 1) & 1);  // the tile's features
      if constexpr (SAVE) store_atoms<64>(sm + OV_FEAT + buf * FEAT_BYTES, sv, SV_FEAT);

      // ---- the trunk: 0 feat->A, 1 A->B, 2 B->A, 3 A->B, 4 B->A, 5 (A, feat)->B,
      // 6 B->A, 7 A->B; H ends in bufB ----
      uint32_t src = feat;
      int kslabs = IN_W / 64;
      for (int l = 0; l < 8; ++l) {
        const int dst = l % 2 == 0 ? OV_BUFA : OV_BUFB;
        zero_acc(acc2);
        load_bias<128>(bv2, b + B_TRUNK + l * W);
        mma_slabs<SAVE, 128>(acc2, ring, src, kslabs);
        if (l == 5) mma_slabs<SAVE, 128>(acc2, ring, feat, IN_W / 64);
        epilogue<SAVE, 128>(acc2, bv2, true, sm + dst, sv, SV_ACT + l * W, l);
        src = sa + dst;
        kslabs = W / 64;
      }
      const uint32_t Hs = sa + OV_BUFB;  // act7

      // ---- the heads, the packed output accumulated beside them ----
      zero_acc(oacc);
      mma_slabs<SAVE, 64>(oacc, ring, Hs, 4);  // H@w_sig
      // f = H@w_f + b_f -> bufA (no ReLU)
      head_product<SAVE, 128>(acc2, bv2, b + B_F, ring, Hs, 4);
      epilogue<SAVE, 128>(acc2, bv2, false, sm + OV_BUFA, sv, SV_F);
      zero_acc(acc1);  // v = relu(f@wv_f + feat@wv_d + b_v) -> head
      if constexpr (!SAVE) load_bias<64>(bv1, b + B_V);
      mma_slabs<SAVE, 64>(acc1, ring, sa + OV_BUFA, 4);
      mma_slabs<SAVE, 64>(acc1, ring, feat, 2);
      if constexpr (SAVE) load_bias<64>(bv1, b + B_V);
      epilogue<SAVE, 64>(acc1, bv1, true, sm + OV_HEAD, sv, SV_V, MK_V);
      mma_slabs<SAVE, 64>(oacc, ring, sa + OV_HEAD, 2);  // v@w_r
      // a1 = relu(H@w_a1 + b_a1) -> bufA's first two atoms
      head_product<SAVE, 64>(acc1, bv1, b + B_A1, ring, Hs, 4);
      epilogue<SAVE, 64>(acc1, bv1, true, sm + OV_BUFA, sv, SV_A1, MK_A1);
      mma_slabs<SAVE, 64>(oacc, ring, sa + OV_BUFA, 2);  // a1@w_a2
      // s1 -> bufA's last two atoms
      head_product<SAVE, 64>(acc1, bv1, b + B_S1, ring, Hs, 4);
      epilogue<SAVE, 64>(acc1, bv1, true, sm + OV_BUFA + 2 * ATOM, sv, SV_S1, MK_S1);
      mma_slabs<SAVE, 64>(oacc, ring, sa + OV_BUFA + 2 * ATOM, 2);  // s1@w_s2
      // m1 -> head (v is read)
      head_product<SAVE, 64>(acc1, bv1, b + B_M1, ring, Hs, 4);
      epilogue<SAVE, 64>(acc1, bv1, true, sm + OV_HEAD, sv, SV_M1, MK_M1);
      if constexpr (!SAVE) load_bias<64>(bvo, b + B_OUT);
      mma_slabs<SAVE, 64>(oacc, ring, sa + OV_HEAD, 2);  // m1@w_m2
      if constexpr (SAVE) load_bias<64>(bvo, b + B_OUT);

      // ---- out = bf16(sum of the five products + the summed output bias),
      // staged in the tile's feat buffer, which is then released ----
      store_out(oacc, bvo, sm + OV_FEAT + buf * FEAT_BYTES, out, (long long)t * TILE_M, n);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) hmma::mbar_arrive(feat_empty + buf * 8);
    }
    // every saved-buffer store has read its source and written before the
    // block exits
    if constexpr (SAVE)
      if ((threadIdx.x & 127) == 0) hmma::bulk_wait<0, 0>();
  }
}

template <bool SAVE>
int launch_fwd(const void* in8, const void* pe_mat, const void* sin_mask, const void* img,
               const void* b, void* out, void* saved, long long n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + TILE_M - 1) / TILE_M;
  if (n <= 0 || tiles > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(in8) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (SAVE && reinterpret_cast<uintptr_t>(saved) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  const long long grid = tiles < sms ? tiles : sms;
  fused_mlp_fwd_kernel<SAVE><<<(unsigned)grid, FWD_THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(in8), static_cast<const float*>(pe_mat),
      static_cast<const float*>(sin_mask), static_cast<const bf16*>(img),
      static_cast<const float*>(b), static_cast<bf16*>(out), static_cast<bf16*>(saved), n);
  return (int)cudaGetLastError();
}

}  // namespace

// w: the flat bf16 weights (_W_ORDER, each block [in, out] row-major);
// img: 835,584 bf16, the weight image of fused_mlp_fwd.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int fused_mlp_fwd_image(const void* w, void* img, void* stream) {
  fwd_wimg_kernel<<<FWD_SLABS, NTHREADS, 0, (cudaStream_t)stream>>>(static_cast<const bf16*>(w),
                                                                    static_cast<bf16*>(img));
  return (int)cudaGetLastError();
}

// in8 [n, 8] f32 (16-byte aligned), pe_mat [8, 128] f32, sin_mask [128]
// f32, img: the weight image from fused_mlp_fwd_image, b: flat f32 biases,
// out [n, 128] bf16.  Launches min(tiles, SMs) blocks on `stream` and
// returns the launch's cudaError_t.
extern "C" int fused_mlp_fwd(const void* in8, const void* pe_mat, const void* sin_mask,
                             const void* img, const void* b, void* out, long long n,
                             void* stream) {
  return launch_fwd<false>(in8, pe_mat, sin_mask, img, b, out, nullptr, n, stream);
}

// fused_mlp_fwd, and the saved forward into `saved` (16-byte aligned):
// SV_COLS x p_pad bf16 of activations, then p_pad / 64 x MASK_WORDS 32-bit
// mask words (fused_mlp_common.cuh; ops/fused_mlp.py:backward_scratch gives
// the sizes).
extern "C" int fused_mlp_fwd_save(const void* in8, const void* pe_mat, const void* sin_mask,
                                  const void* img, const void* b, void* out, void* saved,
                                  long long n, void* stream) {
  return launch_fwd<true>(in8, pe_mat, sin_mask, img, b, out, saved, n, stream);
}
