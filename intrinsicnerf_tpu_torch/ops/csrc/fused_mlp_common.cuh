// Constants shared by the fused-MLP forward (fused_mlp_fwd.cu) and
// backward (fused_mlp_bwd.cu) kernels and the forward's attribution probe
// (fwd_probe.cu): the tile and block sizes, the widths, and the packed
// weight and bias layouts of kernels 1 and 2.  The device helpers live
// beside them in hopper_mma.cuh; every product takes bf16 operands with
// fp32 accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fmlp {

using bf16 = __nv_bfloat16;

constexpr int TILE_M = 64;  // points per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int W = 256;      // trunk width
constexpr int HW = 128;     // head width (W / 2)
constexpr int IN_W = 128;   // packed PE width
constexpr int OUT_W = 128;  // packed output width
constexpr int IN8_W = 8;

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

}  // namespace fmlp
