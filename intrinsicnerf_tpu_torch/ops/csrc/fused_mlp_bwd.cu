// Fused IntrinsicNeRF MLP backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// intrinsicnerf_tpu/ops/fused_mlp.py, launched there by `_fused_bwd`.
// Given the bf16 cotangent g [P, 128] of the packed output and the saved
// forward that the forward's training launch wrote (fused_mlp_fwd.cu's
// saving instance: every activation the weight products read, bf16, and
// every ReLU mask, fused_mlp_common.cuh), it backpropagates g through the
// heads and the trunk and returns dW = act^T g for all 20 packed weight
// blocks and db = sum(g) for the biases, in fp32.  The Pallas kernel
// recomputes the forward, for VMEM has no room to keep it; here the
// forward kernel computed the same activations from the same operands
// moments earlier, so nothing is recomputed.  The points get no gradient
// (exact: NeRF samples are not parameters).
// Rounding follows `_bwd_kernel`: every product takes bf16 operands with
// fp32 accumulation; each gradient is formed in fp32, its bias gradient
// is the fp32 sum of that unrounded value, and it is rounded to bf16 only
// as a product operand.  Saved activations are bf16 (the weight products
// cast them so anyway); the ReLU masks test the fp32 value, as the plain
// version does.
//
// Bound, on an H100 (989 TFLOP/s bf16, 3.35 TB/s).  Operations: 1,355,648
// multiply-adds per point (C = 27): 695,680 for the weight products and
// 659,968 for the input products of every layer whose input depends on
// parameters; 0.54 ms for the fine call's 196,608 points.  Bytes: the
// activation pass reads 256 B of cotangent and 384 B of masks and writes
// the gradient arena below, 5,888 B per point (0.38 ms at fine); the
// weight-gradient pass reads the saved activations and the arena, 11,776
// B per point (0.69 ms).  So each pass is bound by its bytes.
//
// Design: four launches in one call.
//  0. `bwd_act_wimg_kernel`: the weight image, every K-slab the activation pass
//     streams (64 columns of W^T for an input product; 50 per tile, 1.5 MB
//     in all), each laid out as it sits in shared memory (128-byte
//     swizzle, hopper_mma.cuh), in the order the products consume them.
//  1. `bwd_act_wgmma_kernel`: persistent, one block per SM (197 KB of
//     shared memory), min(tiles, SMs) blocks; block b walks the 64-point
//     tiles b, b + grid, b + 2 grid, ... in order.  Three warpgroups:
//     - two consumer warpgroups run each tile's backward chain with its
//       gradients in shared memory, each a K-major operand of 64-column
//       atoms; every product is wgmma m64nNk16 from shared memory with the
//       two warpgroups splitting the output columns (N = 128 each for a
//       256-wide layer, 64 for a 128-wide head) and one slab's products
//       left in flight while the next is issued.  Each gradient epilogue
//       takes the thread's mask words of its layer, loaded from the saved
//       forward into registers before the product (as a bias would be),
//       zeroes the masked registers and rows past P, writes bf16 pairs into
//       the next product's operand, then one bulk store of the
//       warpgroup's atoms to the arena by one of its threads, and the bias
//       partials as column sums in a fixed order (lane shuffles, then the
//       four warps);
//     - in the third, one thread of its first warp (the producer) moves
//       the weight image slab by slab, once per tile, into a 3-stage ring
//       of 32 KB with one bulk copy each (the copy engine, an mbarrier per
//       stage for full and one for empty), running ahead of the consumers
//       across layers, epilogues and tiles;
//     - its other three warps (the staging warps) stage the next tile's
//       cotangent (zero past P) while the consumers run this one, 16 bytes
//       at a time straight into the tile's atoms of the arena, and the
//       output bias's gradient, the cotangent's 128 column sums over the
//       tile's rows in order, into its bias partials.  The cotangent comes
//       into the slot [0, 16K) by a bulk copy from the arena (L2) once the
//       consumers have read the previous tile's, at its dH product; the
//       slot has a full mbarrier (the copy's bytes) and an empty one (the
//       eight consumer warps).  A block with one tile pays its staging up
//       front.
//     setmaxnreg gives the consumers the registers the third warpgroup
//     does not need.  The arena holds 2,944 bf16 per point; each buffer
//     keeps a tile's rows in the atoms of its shared buffer, byte for
//     byte, so a warpgroup's columns are one contiguous run in both
//     places.  Rows past P are zero-gradient padding up to a multiple of
//     64.
//  2. `bwd_wgrad_gemm_kernel`: dW = A^T G for the 20 weight blocks as 51
//     output tiles of 128x128, each over one of `splits` point chunks, so
//     that 255 blocks of two warpgroups and a producer warp run as one wave
//     at two per SM.  A is a buffer of the saved forward, G one of the
//     arena.  The producer moves point slabs of A and G (64 x 128 each, two
//     atoms that lie side by side in their buffer) into a 3-stage ring with
//     one bulk copy per operand, as the activation pass moves its weights;
//     both operands are MN-major and wgmma m64n128k16 takes both
//     transposed, one slab's products in flight while the next is issued.
//     Each (tile, chunk) writes its fp32 partial to a workspace [splits,
//     835,584] straight from the registers.
//  3. `reduce_rows_kernel` (twice): the partials and the per-tile bias
//     partials summed in a fixed order.
// No atomics anywhere, and every sum in a fixed order whatever block runs
// a tile: two launches on the same inputs give bitwise-equal gradients.
// A lost mbarrier arrival or byte count traps (hopper_mma.cuh:mbar_wait),
// so a pipeline fault fails the launch instead of hanging the card.  The
// TPU kernel accumulates dW in place across its sequential grid instead; a
// GPU grid runs in parallel and dW (3.3 MB in fp32) does not fit in a
// block, hence the arena and the partials.
//
// Copies: every copy but the staging warps' is a bulk copy (the copy
// engine without a tensor map), since each one moves a contiguous run: a
// weight slab of the image, a warpgroup's atoms of a buffer into the
// arena, a tile's cotangent atoms out of it into the slot, an operand's
// two atoms of a slab into the GEMM's ring.  TMA tensor maps are not
// needed for that, and would be encoded per call by cuTensorMapEncode
// (the arena is a fresh allocation; this plain-C build has no libcuda
// link).  A store is read out of shared memory while the next product
// runs; a product's first thread of each warpgroup waits, before the
// barrier that opens it, until all but the warpgroup's newest store have
// read their buffers, since its epilogue may overwrite them.  The stores
// mark their lines first to go from L2 (hopper_mma.cuh:bulk_store), the
// mask loads theirs likewise (ld.global.cs), and the weight image's loads
// mark theirs last (bulk_load_evict_last), so that the arena streams do
// not push out the image that every tile reads.
// Measured on the card (PERF.md, at the fine shape): the activation pass
// took 5.5 ms with the weights loaded by cp.async from every thread behind
// a block barrier per slab, 3.4 ms with the producer's bulk copies, 2.8 ms
// with one slab's products in flight and the bias loaded ahead and the
// arena written by 16-byte copies from every thread; 3.3 ms with the
// arena's bulk stores and the slab loops as the compiler unrolled them,
// 2.4-2.5 ms with the loops rolled, 2.0 ms with the stores' lines marked
// `evict_first`.  Staged ahead by the third warpgroup of a persistent
// block, the pass took 1.60-1.66 ms with the forward recomputed, and 0.85
// ms with it read from the saved forward instead.  The GEMM took 1.10 ms
// with 16-byte cp.async behind a block barrier per slab, 0.89 ms with the
// bulk-load ring (its byte bound 0.70).

#include <climits>

#include "fused_mlp_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace fmlp;

// The gradient arena: the gradients the activation pass writes and the
// weight-gradient pass reads, in the saved forward's layout
// (fused_mlp_common.cuh): each buffer of `width` columns starts at (its
// offset below) * p_pad elements and holds the points' 64-row tiles in
// order, each as width / 64 atoms of 64 rows x 64 columns (8 KB), byte for
// byte as the activation pass's shared buffers and the weight-gradient
// pass's stages hold them.
constexpr int GR_GO = 0;              // the cotangent, zero past P, 128
constexpr int GR_G = GR_GO + OUT_W;   // trunk pre-activation gradients 0..7
constexpr int GR_GA1 = GR_G + 8 * W;
constexpr int GR_GS1 = GR_GA1 + HW;
constexpr int GR_GM1 = GR_GS1 + HW;
constexpr int GR_GV = GR_GM1 + HW;
constexpr int GR_GF = GR_GV + HW;
constexpr int GR_COLS = GR_GF + W;
static_assert(GR_COLS == 2944, "arena layout changed");

// ---- the activation pass ----
//
// Shared memory of one block (byte offsets from a 1 KB boundary).  Every
// gradient buffer is K-major for the next product: 64-column atoms of 64
// rows (hopper_mma.cuh), 8 KB each.
//  go [0, 16K): the inputs' slot, into which the bulk copies bring each
//    tile's cotangent
//  gv / ga1 / gs1 / gm1 [16K, 64K), the trunk gradients ping [16K, 48K)
//    and pong [64K, 96K), gf [64K, 96K)
//  weight ring: ACT_STAGES x 32 KB, one K-slab of 64 of a weight block each
//  column-sum scratch: [2 warpgroups][4 warps][128] fp32
//  barriers: the ring's full and empty, one each per stage, then the
//    slot's full and empty
constexpr int ATOM = 64 * 128;  // one 64-row atom
constexpr int OV_GO = 0, OV_R1 = 16384, OV_R2 = 65536;
constexpr int IN_BYTES = 2 * ATOM;  // a tile's 128 cotangent columns
constexpr int SM_RING = 98304;
constexpr int ACT_STAGES = 3;
constexpr int ACT_STAGE_BYTES = 32768;
constexpr int SM_COLSUM = SM_RING + ACT_STAGES * ACT_STAGE_BYTES;
constexpr int SM_BARS = SM_COLSUM + 2 * 4 * 128 * 4;
constexpr int ACT_SMEM = SM_BARS + (2 * ACT_STAGES + 2) * 8 + 1024;  // + slack to align to 1 KB
static_assert(ACT_SMEM <= 232448, "the activation pass exceeds a block's shared memory");
static_assert(OV_GO == 0 && OV_R1 == IN_BYTES, "the inputs' slot");
static_assert(NTHREADS == 256, "two consumer warpgroups");
// + the third warpgroup: the producer warp, then the staging warps
constexpr int ACT_THREADS = NTHREADS + 128;
constexpr int STAGE_THREADS = 96;
// registers a thread after setmaxnreg: 128 x 88 + 256 x 208 = 384 x 168,
// the block's share of the SM's 65,536 at launch
constexpr int STAGE_REGS = 88, CONSUMER_REGS = 208;

// One weight block as the input products of the backward stream it,
// K-slab by K-slab: they read W^T (K = out, N = in; K-major: each slab is N
// rows of 64 k).  `ldw` = out.
struct Seg {
  int w_off, ldw, K, N;
};
#define BWD(off, in, out) {(int)(off), out, out, in}
#define SEG_TABLE                                                                             \
  {BWD(OFF_WR, HW, OUT_W), BWD(OFF_WVF, W, HW), BWD(OFF_WA2, HW, OUT_W),                      \
   BWD(OFF_WS2, HW, OUT_W), BWD(OFF_WM2, HW, OUT_W),                                          \
   BWD(OFF_WSIG, W, OUT_W), BWD(OFF_WA1, W, HW), BWD(OFF_WS1, W, HW), BWD(OFF_WM1, W, HW),    \
   BWD(OFF_WF, W, W),                                                                         \
   BWD(OFF_W7, W, W), BWD(OFF_W6, W, W), BWD(OFF_W5H, W, W), BWD(OFF_W4, W, W),               \
   BWD(OFF_W3, W, W), BWD(OFF_W2, W, W), BWD(OFF_W1, W, W)}
constexpr int N_SEGS = 17;
constexpr Seg kSegs[N_SEGS] = SEG_TABLE;
__constant__ Seg c_segs[N_SEGS] = SEG_TABLE;
#undef SEG_TABLE
#undef BWD

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
constexpr int N_SLABS = count_slabs();       // 50 per tile
constexpr long IMG_ELEMS = image_elems();    // 753,664 bf16
static_assert(N_SLABS == 50 && IMG_ELEMS == 753664, "the backward's weight image changed");

// The weight image: every slab of every tile's sequence, in c_segs order,
// laid out byte for byte as it sits in a stage (64 * N bf16 each), so that
// the producer moves a slab with one bulk copy: rows n of W^T's slab,
// W[n, k0 : k0 + 64].  One block per slab.
__global__ void __launch_bounds__(NTHREADS)
bwd_act_wimg_kernel(const bf16* __restrict__ w, bf16* __restrict__ img) {
  int i = blockIdx.x, seg = 0;
  long off = 0;
  for (; seg < N_SEGS - 1 && i >= c_segs[seg].K / 64; ++seg) {
    i -= c_segs[seg].K / 64;
    off += (long)c_segs[seg].K * c_segs[seg].N;
  }
  const Seg s = c_segs[seg];
  unsigned char* st = reinterpret_cast<unsigned char*>(img + off + (long)i * 64 * s.N);
  const int k0 = i * 64;
  for (int e = threadIdx.x; e < 8 * s.N; e += NTHREADS) {
    const int row = e >> 3, c = e & 7;
    *reinterpret_cast<uint4*>(st + hmma::sw128(row, c)) =
        *reinterpret_cast<const uint4*>(w + s.w_off + (long)row * s.ldw + k0 + c * 8);
  }
}

// The producer: one thread of the third warpgroup moves the weight image
// into the ring, slab by slab, once for each of the block's tiles,
// ACT_STAGES ahead of the consumers at most; a stage's `full` barrier
// completes when its bytes have landed, its `empty` barrier when the
// eight consumer warps are done with it.  The ring's count runs on across
// tiles, so the next tile's first slabs land while this tile's last
// gradients are stored.  The image's lines are the last L2 evicts: the
// arena's streams pass through L2 around it.
__device__ __forceinline__ void produce(uint32_t ring, uint32_t full, uint32_t empty,
                                        const bf16* __restrict__ img, int tiles) {
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    long off = 0;
    for (int seg = 0; seg < N_SEGS; ++seg) {
      const uint32_t bytes = 128 * c_segs[seg].N;  // 64 x N bf16
      for (int k = 0; k < c_segs[seg].K / 64; ++k, ++i) {
        const int st = i % ACT_STAGES;
        if (i >= ACT_STAGES) hmma::mbar_wait(empty + st * 8, ((i / ACT_STAGES) - 1) & 1);
        hmma::mbar_expect_tx(full + st * 8, bytes);
        hmma::bulk_load_evict_last(ring + st * ACT_STAGE_BYTES, img + off, bytes, full + st * 8);
        off += bytes / 2;
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

// acc[64 x NW] (this warpgroup's columns) += A[64, 64 * kslabs] @ the next
// kslabs slabs of the ring (W^T, K-major).  A: a K-major gradient buffer
// at shared address `a`, written by both warpgroups' epilogues before this
// call.
template <int NW>
__device__ __forceinline__ void mma_slabs(float (&acc)[NW / 2], Ring& r, uint32_t a, int kslabs) {
  const int wg = threadIdx.x >> 7;
  // The arena store before this warpgroup's newest may still read a buffer
  // that this product's epilogue overwrites: wait for it (the buffers
  // alternate, so it is a product old); the barrier holds every consumer
  // behind the wait.
  if ((threadIdx.x & 127) == 0) hmma::bulk_wait<1, 1>();
  consumer_sync();  // A's writers fenced their writes to the async proxy before it
  int prev = -1;    // the stage of the slab whose products may still run
#pragma unroll 1  // unrolled at its call sites, the pass ran 25% slower on the card
  for (int s = 0; s < kslabs; ++s) {
    const int st = r.it % ACT_STAGES;
    hmma::mbar_wait(r.full + st * 8, (r.it / ACT_STAGES) & 1);
    const uint32_t slab = r.base + st * ACT_STAGE_BYTES;
    hmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hmma::desc_sw128(a + s * ATOM + kk * 32, 16, 1024);
      const uint64_t db = hmma::desc_sw128(slab + wg * NW * 128 + kk * 32, 16, 1024);
      if constexpr (NW == 128)
        hmma::wgmma_m64n128k16<0, 0>(acc, da, db, 1);
      else
        hmma::wgmma_m64n64k16<0, 0>(acc, da, db, 1);
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

__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

// This warpgroup's NW columns of the K-major shared buffer S (its atoms
// from wg * NW / 64) to the same atoms of the arena tile at G: one bulk
// store by the warpgroup's first thread, in a bulk group of its own.
// Called after a barrier that follows every writer's fence_proxy_async.
template <int NW>
__device__ __forceinline__ void store_atoms(const unsigned char* S, bf16* G) {
  const uint32_t off = (threadIdx.x >> 7) * NW * 128;
  if ((threadIdx.x & 127) == 0) {
    hmma::bulk_store(reinterpret_cast<unsigned char*>(G) + off, hmma::smem_u32(S) + off, NW * 128);
    hmma::bulk_commit();
  }
}

// This thread's mask words of a ReLU layer (`mask`: the saved forward's),
// loaded before the product so that their latency hides behind it; the
// lines are read once
template <int NW>
__device__ __forceinline__ void load_mask(uint32_t (&bits)[NW / 64], const uint32_t* mask) {
  if constexpr (NW == 128) {
    const uint2 m = __ldcs(reinterpret_cast<const uint2*>(mask));
    bits[0] = m.x;
    bits[1] = m.y;
  } else {
    bits[0] = __ldcs(mask);
  }
}

// Gradient epilogue of this warpgroup's NW columns: v = acc, zero where
// the mask bit is clear and past n; bf16(v) into D and the arena tile G,
// and the fp32 column sums of v over the tile's 64 rows (lanes, then the
// four warps in order) into bsum.
template <int NW>
__device__ __forceinline__ void grad_epilogue(const float (&acc)[NW / 2],
                                              const uint32_t (&bits)[NW / 64], unsigned char* D,
                                              bf16* G, float* bsum, float* colsum, long long row0,
                                              long long n) {
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const bool live0 = row0 + r0 < n, live1 = row0 + r0 + 8 < n;
  float* cs = colsum + (wg * 4 + warp) * 128;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = wg * NW + j * 8 + 2 * (lane & 3);
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      const bool live = h ? live1 : live0;
      const float v0 = live && ((bits[i >> 5] >> (i & 31)) & 1u) ? acc[i] : 0.0f;
      const float v1 = live && ((bits[i >> 5] >> ((i + 1) & 31)) & 1u) ? acc[i + 1] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(D + kmaj(r0 + 8 * h, col)) = __floats2bfloat162_rn(v0, v1);
      s0 += v0;
      s1 += v1;
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, o);
      s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, o);
    }
    if (lane < 4) {
      cs[j * 8 + 2 * lane] = s0;
      cs[j * 8 + 2 * lane + 1] = s1;
    }
  }
  hmma::fence_proxy_async();
  wg_sync();
  store_atoms<NW>(D, G);
  if (lt < NW) {
    const float* c0 = colsum + wg * 4 * 128 + lt;
    bsum[wg * NW + lt] = ((c0[0] + c0[128]) + c0[256]) + c0[384];
  }
}

// the barrier of the staging warps
__device__ __forceinline__ void stage_sync() {
  asm volatile("bar.sync 4, %0;\n" ::"n"(STAGE_THREADS) : "memory");
}

// A staging warp's 16-byte store of one chunk of a tile's cotangent atoms
// into the arena, the arena's one writer besides the consumers' bulk stores
__device__ __forceinline__ void stage_put(unsigned char* dst, uint4 v) {
  *reinterpret_cast<uint4*>(dst) = v;
}

// Tile t's inputs, by the staging warps, into its atoms of the arena (rows
// past n zero) and its row of the bias partials:
//  - the cotangent's rows, 16 bytes at a time;
//  - the five output biases' gradient: the cotangent's 128 column sums
//    over the tile's 64 rows in order.
// Each thread then fences its arena stores to the async proxy, through
// which the slot's bulk copy reads them.
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ g, bf16* __restrict__ arena,
                                           float* __restrict__ bpart, int t, long long n,
                                           long long p_pad) {
  const int pt = threadIdx.x - (NTHREADS + 32);
  const long long row0 = (long long)t * TILE_M;
  unsigned char* go = reinterpret_cast<unsigned char*>(arena + GR_GO * p_pad + row0 * OUT_W);
  // chunk e: row e / 16, columns 8 (e % 16) .. + 8
  for (int e = pt; e < TILE_M * 16; e += STAGE_THREADS) {
    const int i = e >> 4, q = e & 15;
    const long long p = row0 + i;
    stage_put(go + (q >> 3) * ATOM + hmma::sw128(i, q & 7),
              p < n ? __ldg(reinterpret_cast<const uint4*>(g + p * OUT_W) + q)
                    : make_uint4(0u, 0u, 0u, 0u));
  }
  for (int c = pt; c < OUT_W; c += STAGE_THREADS) {
    float s = 0.0f;
#pragma unroll 8
    for (int i = 0; i < TILE_M; ++i)
      s += row0 + i < n ? __bfloat162float(g[(row0 + i) * OUT_W + c]) : 0.0f;
    bpart[(long long)t * B_TOTAL + B_OUT + c] = s;
  }
  hmma::fence_proxy_async_global();
}

// tile t's cotangent atoms of the arena into the inputs' slot, by one bulk
// copy completing on `full`
__device__ __forceinline__ void load_input(uint32_t slot, uint32_t full, const bf16* arena, int t,
                                           long long p_pad) {
  hmma::mbar_expect_tx(full, IN_BYTES);
  hmma::bulk_load(slot, arena + GR_GO * p_pad + (long long)t * TILE_M * OUT_W, IN_BYTES, full);
}

// The staging warps: the block's first tile staged and its cotangent
// loaded; then, while the consumers run the block's j-th tile, the next
// tile staged and, by the first staging thread, its cotangent copied into
// the slot once the consumers have read this tile's (go_empty).
__device__ __forceinline__ void stage_inputs(unsigned char* sm, uint32_t go_full,
                                             uint32_t go_empty, const bf16* __restrict__ g,
                                             bf16* __restrict__ arena, float* __restrict__ bpart,
                                             long long n, long long p_pad, int tiles) {
  const int pt = threadIdx.x - (NTHREADS + 32);
  const uint32_t slot = hmma::smem_u32(sm + OV_GO);
  stage_tile(g, arena, bpart, blockIdx.x, n, p_pad);
  stage_sync();
  if (pt == 0) load_input(slot, go_full, arena, blockIdx.x, p_pad);
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const int next = t + gridDim.x;
    if (next < tiles) stage_tile(g, arena, bpart, next, n, p_pad);
    stage_sync();  // the next tile staged by every staging thread
    hmma::mbar_wait(go_empty, j & 1);
    if (pt == 0 && next < tiles)
      load_input(slot, go_full, arena, next, p_pad);
  }
}

// a consumer warp is done reading the slot's input: one arrival per warp
__device__ __forceinline__ void release(uint32_t empty) {
  if ((threadIdx.x & 31) == 0) hmma::mbar_arrive(empty);
}

__global__ void __launch_bounds__(ACT_THREADS, 1)
bwd_act_wgmma_kernel(const bf16* __restrict__ img, const uint32_t* __restrict__ masks,
                     const bf16* __restrict__ g, bf16* __restrict__ arena,
                     float* __restrict__ bpart, long long n, long long p_pad) {
  extern __shared__ __align__(128) unsigned char act_smem[];
  unsigned char* sm = act_smem + ((1024u - (hmma::smem_u32(act_smem) & 1023u)) & 1023u);
  const uint32_t sa = hmma::smem_u32(sm);
  const int tiles = (int)(p_pad / TILE_M);
  Ring ring{sa + SM_RING, sa + SM_BARS, sa + SM_BARS + ACT_STAGES * 8, 0};
  const uint32_t go_full = sa + SM_BARS + 2 * ACT_STAGES * 8, go_empty = go_full + 8;
  if (threadIdx.x == 0) {
    for (int st = 0; st < ACT_STAGES; ++st) {
      hmma::mbar_init(ring.full + st * 8, 1);    // the producer's expect_tx
      hmma::mbar_init(ring.empty + st * 8, 8);   // the eight consumer warps
    }
    hmma::mbar_init(go_full, 1);   // the staging thread's expect_tx
    hmma::mbar_init(go_empty, 8);  // the eight consumer warps
  }
  hmma::fence_mbar_init();
  __syncthreads();
  if (threadIdx.x >= NTHREADS) {  // the third warpgroup: the producer, the staging warps
    hmma::setmaxnreg_dec<STAGE_REGS>();
    if (threadIdx.x == NTHREADS)
      produce(ring.base, ring.full, ring.empty, img, tiles);
    else if (threadIdx.x >= NTHREADS + 32)
      stage_inputs(sm, go_full, go_empty, g, arena, bpart, n, p_pad, tiles);
    return;
  }
  // the consumers
  hmma::setmaxnreg_inc<CONSUMER_REGS>();
  float* colsum = reinterpret_cast<float*>(sm + SM_COLSUM);
  float acc2[64];  // a 256-wide product: 128 columns per warpgroup
  float acc1[32];  // a 128-wide product: 64 columns per warpgroup
  uint32_t mk2[2], mk1[1];  // the product's mask words
  const uint32_t all2[2] = {0xFFFFFFFFu, 0xFFFFFFFFu};  // f has no ReLU
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const long long row0 = (long long)t * TILE_M;
    auto ar = [&](int off, int width) { return arena + (long)off * p_pad + row0 * width; };
    const uint32_t* mt = masks + (long long)t * MASK_WORDS + threadIdx.x * 2;
    auto mask = [&](int layer) { return mt + layer * NTHREADS * 2; };
    float* bsum = bpart + (long)t * B_TOTAL;

    hmma::mbar_wait(go_full, j & 1);  // the tile's cotangent
    const uint32_t go = sa + OV_GO;
    // gv = (go @ w_r^T) * (v > 0); gf = gv @ wv_f^T (f has no ReLU)
    load_mask<64>(mk1, mask(MK_V));
    zero_acc(acc1);
    mma_slabs<64>(acc1, ring, go, 2);
    grad_epilogue<64>(acc1, mk1, sm + OV_R1, ar(GR_GV, HW), bsum + B_V, colsum, row0, n);
    zero_acc(acc2);
    mma_slabs<128>(acc2, ring, sa + OV_R1, 2);
    grad_epilogue<128>(acc2, all2, sm + OV_R2, ar(GR_GF, W), bsum + B_F, colsum, row0, n);
    // head gradients: g1 = (go @ w2^T) * (act1 > 0) -> ga1, gs1, gm1
    load_mask<64>(mk1, mask(MK_A1));
    zero_acc(acc1);
    mma_slabs<64>(acc1, ring, go, 2);
    grad_epilogue<64>(acc1, mk1, sm + OV_R1, ar(GR_GA1, HW), bsum + B_A1, colsum, row0, n);
    load_mask<64>(mk1, mask(MK_S1));
    zero_acc(acc1);
    mma_slabs<64>(acc1, ring, go, 2);
    grad_epilogue<64>(acc1, mk1, sm + OV_R1 + 2 * ATOM, ar(GR_GS1, HW), bsum + B_S1, colsum, row0,
                      n);
    load_mask<64>(mk1, mask(MK_M1));
    zero_acc(acc1);
    mma_slabs<64>(acc1, ring, go, 2);
    grad_epilogue<64>(acc1, mk1, sm + OV_R1 + 4 * ATOM, ar(GR_GM1, HW), bsum + B_M1, colsum, row0,
                      n);
    // dH = go@w_sig^T + ga1@w_a1^T + gs1@w_s1^T + gm1@w_m1^T + gf@w_f^T
    load_mask<128>(mk2, mask(7));
    zero_acc(acc2);
    mma_slabs<128>(acc2, ring, go, 2);
    release(go_empty);  // the cotangent read: the next tile's may land
    mma_slabs<128>(acc2, ring, sa + OV_R1, 2);
    mma_slabs<128>(acc2, ring, sa + OV_R1 + 2 * ATOM, 2);
    mma_slabs<128>(acc2, ring, sa + OV_R1 + 4 * ATOM, 2);
    mma_slabs<128>(acc2, ring, sa + OV_R2, 4);
    consumer_sync();  // gh7 overlays the head gradients just read
    grad_epilogue<128>(acc2, mk2, sm + OV_R1, ar(GR_G + 7 * W, W), bsum + B_TRUNK + 7 * W, colsum,
                       row0, n);
    // trunk: gh_{l-1} = (gh_l @ w_l^T) * (act_{l-1} > 0), l = 7..1
    int cur = OV_R1, other = OV_R2;
    for (int l = 7; l >= 1; --l) {
      load_mask<128>(mk2, mask(l - 1));
      zero_acc(acc2);
      mma_slabs<128>(acc2, ring, sa + cur, 4);
      grad_epilogue<128>(acc2, mk2, sm + other, ar(GR_G + (l - 1) * W, W),
                         bsum + B_TRUNK + (l - 1) * W, colsum, row0, n);
      const int read = cur;
      cur = other;
      other = read;
    }
  }
  // every store has read its source and written the arena before the
  // block exits
  if ((threadIdx.x & 127) == 0) hmma::bulk_wait<0, 0>();
}

// One weight gradient dW[K, N] = A[P, K]^T @ G[P, N]: A a buffer of the
// saved forward, G one of the gradient arena.
struct Job {
  int a_off, lda, g_off, ldg, K, N;
  long w_off;
};

constexpr int N_JOBS = 20;

// The weight-gradient GEMM.  Output tiles of TK x TN = 128 x 128 cover
// every block exactly (K and N are each 128 or 256): 51 tiles.  A block
// is two consumer warpgroups, one per 64-row half of the tile, and a
// producer warp, over one point chunk.  The producer moves point slabs of
// A [SLAB, 128] and G [SLAB, 128] into a ring of STAGES stages, each
// operand's two 64-column atoms with one bulk copy (they lie side by side
// in their buffer's tile); a stage's `full` barrier completes when its
// bytes have landed, its `empty` barrier when the eight consumer warps are
// done with it.  Both buffers are point-major, so both operands are MN-major (the
// contraction runs down the slab's rows) and the wgmma takes both
// transposed; one slab's products stay in flight while the next is issued.
constexpr int TK = 128, TN = 128;
constexpr int N_TILES = (int)(W_TOTAL / (TK * TN));
static_assert(N_TILES * TK * TN == W_TOTAL, "every block is a whole number of tiles");
constexpr int SLAB = 64;                     // points per stage: one arena tile
constexpr int STAGES = 3;
constexpr int ATOM_BYTES = SLAB * 128;       // 64 columns x SLAB rows
constexpr int STAGE_BYTES = 4 * ATOM_BYTES;  // A: 2 atoms, G: 2 atoms (32 KB)
constexpr int WG_THREADS = 256 + 32;         // + the producer warp
constexpr int WG_SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, 1 KB slack
static_assert(TILE_M == SLAB, "a slab is one arena tile");

#define JOB(a, la, g, lg, k, n, off) {a, la, g, lg, k, n, off}
__constant__ Job c_jobs[N_JOBS] = {
    JOB(SV_FEAT, IN_W, GR_G + 0 * W, W, IN_W, W, OFF_W0),
    JOB(SV_ACT + 0 * W, W, GR_G + 1 * W, W, W, W, OFF_W1),
    JOB(SV_ACT + 1 * W, W, GR_G + 2 * W, W, W, W, OFF_W2),
    JOB(SV_ACT + 2 * W, W, GR_G + 3 * W, W, W, W, OFF_W3),
    JOB(SV_ACT + 3 * W, W, GR_G + 4 * W, W, W, W, OFF_W4),
    JOB(SV_FEAT, IN_W, GR_G + 5 * W, W, IN_W, W, OFF_W5X),
    JOB(SV_ACT + 4 * W, W, GR_G + 5 * W, W, W, W, OFF_W5H),
    JOB(SV_ACT + 5 * W, W, GR_G + 6 * W, W, W, W, OFF_W6),
    JOB(SV_ACT + 6 * W, W, GR_G + 7 * W, W, W, W, OFF_W7),
    JOB(SV_ACT + 7 * W, W, GR_GO, OUT_W, W, OUT_W, OFF_WSIG),
    JOB(SV_ACT + 7 * W, W, GR_GA1, HW, W, HW, OFF_WA1),
    JOB(SV_A1, HW, GR_GO, OUT_W, HW, OUT_W, OFF_WA2),
    JOB(SV_ACT + 7 * W, W, GR_GS1, HW, W, HW, OFF_WS1),
    JOB(SV_S1, HW, GR_GO, OUT_W, HW, OUT_W, OFF_WS2),
    JOB(SV_ACT + 7 * W, W, GR_GF, W, W, W, OFF_WF),
    JOB(SV_F, W, GR_GV, HW, W, HW, OFF_WVF),
    JOB(SV_FEAT, IN_W, GR_GV, HW, IN_W, HW, OFF_WVD),
    JOB(SV_V, HW, GR_GO, OUT_W, HW, OUT_W, OFF_WR),
    JOB(SV_ACT + 7 * W, W, GR_GM1, HW, W, HW, OFF_WM1),
    JOB(SV_M1, HW, GR_GO, OUT_W, HW, OUT_W, OFF_WM2),
};
#undef JOB

__global__ void __launch_bounds__(WG_THREADS, 2)
bwd_wgrad_gemm_kernel(const bf16* __restrict__ saved, const bf16* __restrict__ arena,
                      float* __restrict__ ws, long long p_pad, long long chunk) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t ring = (hmma::smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES, empty = full + STAGES * 8;
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
  // a slab's columns [k0, k0 + 128) of A: atoms k0 / 64 and k0 / 64 + 1 of
  // its tile, 16 KB in a row (and G's likewise)
  const bf16* A = saved + (long)job.a_off * p_pad + k0 * SLAB;
  const bf16* G = arena + (long)job.g_off * p_pad + n0 * SLAB;
  const long long p_begin = (long long)blockIdx.y * chunk;
  const long long p_end = p_begin + chunk < p_pad ? p_begin + chunk : p_pad;
  const int n_slabs = p_end > p_begin ? (int)((p_end - p_begin) / SLAB) : 0;
  if (threadIdx.x == 0)
    for (int st = 0; st < STAGES; ++st) {
      hmma::mbar_init(full + st * 8, 1);   // the producer's expect_tx
      hmma::mbar_init(empty + st * 8, 8);  // the eight consumer warps
    }
  hmma::fence_mbar_init();
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256)
      for (int i = 0; i < n_slabs; ++i) {
        const int st = i % STAGES;
        const long long p = p_begin + (long long)i * SLAB;
        if (i >= STAGES) hmma::mbar_wait(empty + st * 8, ((i / STAGES) - 1) & 1);
        hmma::mbar_expect_tx(full + st * 8, STAGE_BYTES);
        hmma::bulk_load(ring + st * STAGE_BYTES, A + p * job.lda, 2 * ATOM_BYTES, full + st * 8);
        hmma::bulk_load(ring + st * STAGE_BYTES + 2 * ATOM_BYTES, G + p * job.ldg, 2 * ATOM_BYTES,
                        full + st * 8);
      }
    return;
  }
  const int wg = threadIdx.x / 128;  // this warpgroup's 64 rows of the tile

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int it = 0; it < n_slabs; ++it) {
    const int sti = it % STAGES;
    hmma::mbar_wait(full + sti * 8, (it / STAGES) & 1);
    const uint32_t st = ring + sti * STAGE_BYTES;
    hmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB / 16; ++kk) {
      // 16 points: A^T rows = this half's 64 columns of A, B = G's 128
      const uint64_t da = hmma::desc_sw128(st + wg * ATOM_BYTES + kk * 2048, ATOM_BYTES, 1024);
      const uint64_t db = hmma::desc_sw128(st + 2 * ATOM_BYTES + kk * 2048, ATOM_BYTES, 1024);
      hmma::wgmma_m64n128k16<1, 1>(acc, da, db, 1);
    }
    hmma::wgmma_commit();
    if (it > 0) {  // the previous slab's products are done: its stage is free
      hmma::wgmma_wait<1>();
      if ((threadIdx.x & 31) == 0) hmma::mbar_arrive(empty + ((it - 1) % STAGES) * 8);
    }
  }
  hmma::wgmma_wait<0>();
  hmma::fence_regs(acc);

  // the fp32 partial of this (tile, chunk), straight from the registers
  float* out = ws + (long)blockIdx.y * W_TOTAL + job.w_off;
  const int lt = threadIdx.x % 128;
  const int r0 = k0 + wg * 64 + (lt / 32) * 16 + (lt % 32) / 4;
#pragma unroll
  for (int jn = 0; jn < TN / 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + jn * 8 + 2 * (lt % 4);
      *reinterpret_cast<float2*>(out + (long)(r0 + 8 * h) * job.N + col) =
          make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
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

// w: the forward kernel's flat bf16 weights, saved: the saved forward of
// the n points (fused_mlp_fwd_save, 16-byte aligned), g [n, 128] bf16
// (16-byte aligned); arena (bf16: GR_COLS x p_pad, then the weight image's
// IMG_ELEMS), bpart (fp32, B_TOTAL a tile) and ws (fp32, W_TOTAL a split),
// as ops/fused_mlp.py:backward_scratch sizes them; dw [835,584] f32 in the
// weight buffer's layout, db [2,944] f32 in the bias buffer's layout (its
// last 128 entries are the gradient of each of the five output biases).
// Launches on `stream` (the activation pass as min(tiles, SMs) blocks);
// returns the first failing launch's cudaError_t.
extern "C" int fused_mlp_bwd(const void* w, const void* saved, const void* g, void* arena,
                             void* bpart, void* ws, void* dw, void* db, long long n, int splits,
                             void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const long long p_pad = (n + TILE_M - 1) / TILE_M * TILE_M;
  const long long tiles = p_pad / TILE_M;
  if (tiles > INT_MAX / 2 || splits > 65535) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(saved) % 16 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long slabs = p_pad / SLAB;
  const long long chunk = (slabs + splits - 1) / splits * SLAB;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_act_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ACT_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_wgrad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const bf16* sv = static_cast<const bf16*>(saved);
  bf16* img = static_cast<bf16*>(arena) + (long long)GR_COLS * p_pad;
  bwd_act_wimg_kernel<<<N_SLABS, NTHREADS, 0, s>>>(static_cast<const bf16*>(w), img);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  bwd_act_wgmma_kernel<<<(unsigned)(tiles < sms ? tiles : sms), ACT_THREADS, ACT_SMEM, s>>>(
      img, reinterpret_cast<const uint32_t*>(sv + (long long)SV_COLS * p_pad),
      static_cast<const bf16*>(g), static_cast<bf16*>(arena), static_cast<float*>(bpart), n,
      p_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_wgrad_gemm_kernel<<<dim3(N_TILES, splits), WG_THREADS, WG_SMEM, s>>>(
      sv, static_cast<const bf16*>(arena), static_cast<float*>(ws), p_pad, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 rb(32, 8);
  reduce_rows_kernel<<<(unsigned)((W_TOTAL + 31) / 32), rb, 0, s>>>(
      static_cast<const float*>(ws), splits, W_TOTAL, W_TOTAL, static_cast<float*>(dw));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(unsigned)((B_TOTAL + 31) / 32), rb, 0, s>>>(
      static_cast<const float*>(bpart), tiles, B_TOTAL, B_TOTAL, static_cast<float*>(db));
  return (int)cudaGetLastError();
}
