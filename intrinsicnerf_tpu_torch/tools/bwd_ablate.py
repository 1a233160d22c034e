"""Where kernel 2's activation pass spends its time, by ablation, on the card.

Builds variants of ``ops/csrc/fused_mlp_bwd.cu``, each with one part of
the activation pass (``bwd_act_wgmma_kernel``) cut out by a text patch of
a copy of the source, and times that pass in each at the training step's
fine shape (196,608 points; ``tools/bwd_passes.py``'s inputs, their saved
forward from kernel 1's saving instance):

- ``base``: the kernel as it is;
- ``no_arena_stores``: every store into the arena: the consumers' bulk
  stores of each buffer's atoms and the staging warps' 16-byte stores of
  the next tile's cotangent;
- ``no_epilogues``: every gradient epilogue (masks, bf16 stores, column
  sums, arena stores);
- ``no_mma``: the wgmma products (the ring still streams every slab);
- ``no_weight_loads``: the producer's bulk copies into the ring (the
  products read whatever the stages hold);
- ``loads_only``: no products and no epilogues, only the weight stream;
- ``stages2``: a ring of two stages instead of three;
- ``no_mask_loads``: the loads of the saved ReLU mask words (every mask
  bit reads set);
- ``staging_serial``: the staging warps stage a tile only once the
  consumers have finished the tile before it (their release of its
  cotangent moved to the tile's end), so the staging no longer overlaps
  the chain: the staged feed alone, the overlap's worth measured apart.

A cut computes garbage; only its time means anything.  The patched
sources and libraries go to ``_build/ablate/``.  One JSON line per
variant and source with the pass's device ms and the card's name and
power limit:

    python -m intrinsicnerf_tpu_torch.tools.bwd_ablate [--iters 10]

``--sources a.cu,b.cu`` builds each listed copy of ``fused_mlp_bwd.cu``
(an experiment beside the committed kernel, or a parent's of the same C
interface with ``--variants base``) in every variant, in turns; each later source's
``base`` row also says whether its gradients ``dw`` and ``db`` equal the
first source's, bitwise, at the fine step and at each count of
``SAME_AS_FIRST_N`` (``same_as_first``).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from intrinsicnerf_tpu_torch.ops import build
from intrinsicnerf_tpu_torch.tools import bwd_passes

_MMA = """      if constexpr (NW == 128)
        hmma::wgmma_m64n128k16<0, 0>(acc, da, db, 1);
      else
        hmma::wgmma_m64n64k16<0, 0>(acc, da, db, 1);"""
_LOADS = """        hmma::mbar_expect_tx(full + st * 8, bytes);
        hmma::bulk_load_evict_last(ring + st * ACT_STAGE_BYTES, img + off, bytes, full + st * 8);"""
_GRAD_EPI = ("  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127, warp = lt >> 5, "
             "lane = lt & 31;\n")
_STORE = "  const uint32_t off = (threadIdx.x >> 7) * NW * 128;\n"
_STAGE_PUT = "  *reinterpret_cast<uint4*>(dst) = v;\n"
_MASK_LOAD = ("__device__ __forceinline__ void load_mask(uint32_t (&bits)[NW / 64], "
              "const uint32_t* mask) {\n")
_GO_RELEASE = "    release(go_empty);  // the cotangent read: the next tile's may land\n"
_TILE_END = "      other = read;\n    }\n"
_STAGE_NEXT = ("    if (next < tiles) stage_tile(g, arena, bpart, next, n, p_pad);\n"
               "    stage_sync();  // the next tile staged by every staging thread\n")
_LOAD_NEXT = "    if (pt == 0 && next < tiles)\n"

PATCHES = {
    "base": [],
    "no_arena_stores": [(_STORE, "  return;\n" + _STORE),
                        (_STAGE_PUT, "  return;\n" + _STAGE_PUT)],
    "no_epilogues": [(_GRAD_EPI, "  return;\n" + _GRAD_EPI)],
    "no_mma": [(_MMA, "      (void)da;\n      (void)db;")],
    "no_weight_loads": [(_LOADS, "      hmma::mbar_arrive(full + st * 8);")],
    "stages2": [("constexpr int ACT_STAGES = 3;", "constexpr int ACT_STAGES = 2;")],
    "no_mask_loads": [(_MASK_LOAD, _MASK_LOAD + "#pragma unroll\n"
                                   "  for (int q = 0; q < NW / 64; ++q) bits[q] = 0xFFFFFFFFu;\n"
                                   "  return;\n")],
    # the consumers release the cotangent at the tile's end, and the staging
    # warps stage the next tile only after that release
    "staging_serial": [(_GO_RELEASE, ""),
                       (_TILE_END, _TILE_END + "    release(go_empty);\n"),
                       (_STAGE_NEXT, ""), (_LOAD_NEXT, _STAGE_NEXT + _LOAD_NEXT)],
}
PATCHES["loads_only"] = PATCHES["no_mma"] + PATCHES["no_epilogues"]
SOURCE = os.path.join(build.CSRC, "fused_mlp_bwd.cu")
# the point counts besides the fine step at which a later source's base
# build is held bitwise against the first's: one point, a ragged count,
# one tile a block and a block's second tile on 132 SMs, fern's fine call
SAME_AS_FIRST_N = (1, 4_097, 8_448, 8_512, 262_144)


def patched_source(variant: str, source: str = SOURCE, patches=None) -> str:
    with open(source) as f:
        src = f.read()
    for old, new in (PATCHES if patches is None else patches)[variant]:
        if src.count(old) != 1:
            raise RuntimeError(f"{variant}: the patch anchor {old[:40]!r} is not in the "
                               "source once")
        src = src.replace(old, new)
    return src


def build_variant(variant: str, source: str = SOURCE, tag: str = "", patches=None,
                  stem: str = "fused_mlp_bwd") -> str:
    """Compile the variant of ``source`` (``patches`` by default this
    tool's) into ``_build/ablate/``; returns its library path."""
    out = os.path.join(build.BUILD_DIR, "ablate")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, f"{stem}_{tag}{variant}.cu")
    with open(src, "w") as f:
        f.write(patched_source(variant, source, patches))
    for h in os.listdir(build.CSRC):
        if h.endswith(".cuh"):
            shutil.copy(os.path.join(build.CSRC, h), out)
    lib = os.path.join(out, f"lib{stem}_{tag}{variant}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stderr}{proc.stdout}")
    return lib


def load_variant(path: str, name: str = "fused_mlp_bwd") -> ctypes.CDLL:
    """The library at ``path`` with the signatures of ``name``'s entries
    that it has (a parent's build may lack a newer entry)."""
    lib = ctypes.CDLL(path)
    for entry, argtypes, restype in build.SIGNATURES[name]:
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def backward_call(lib, ops, saved, g, splits: int):
    """A closure that runs one kernel-2 call of ``lib`` on the saved
    forward ``saved`` (``fused_mlp_forward_saving``) as the wrapper does."""
    n, dev = saved.in8.shape[0], saved.in8.device
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    _, _, arena_n, bpart_n, ws_n = fm.backward_scratch(n, splits)
    arena = torch.empty(arena_n, dtype=torch.bfloat16, device=dev)
    bpart = torch.empty(bpart_n, dtype=torch.float32, device=dev)
    ws = torch.empty(ws_n, dtype=torch.float32, device=dev)
    dw = torch.empty(ops.wbuf.numel(), dtype=torch.float32, device=dev)
    db = torch.empty(ops.bbuf.numel(), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = lib.fused_mlp_bwd(ops.wbuf.data_ptr(), saved.buf.data_ptr(), g.data_ptr(),
                                arena.data_ptr(), bpart.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                                db.data_ptr(), n, splits, stream)
        if err != 0:
            raise RuntimeError(f"fused_mlp_bwd launch failed: cudaError {err}")
    call.grads = (dw, db)
    return call


def grad_inputs(ops, fine) -> dict:
    """{label: (saved, g)}: the saved forward (kernel 1's saving instance)
    of the fine step's points ``fine`` and, for each count of
    ``SAME_AS_FIRST_N``, of those points repeated to it; g is the cotangent
    (out - 0.5) / n of kernel 1's output at them."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    cases = {"fine_step": fine}
    for n in SAME_AS_FIRST_N:
        cases[str(n)] = fine.repeat(-(-n // fine.shape[0]), 1)[:n].contiguous()
    inputs = {}
    for label, in8 in cases.items():
        out, saved = fm.fused_mlp_forward_saving(ops, in8)
        inputs[label] = (saved, ((out.float() - 0.5) / out.shape[0]).to(torch.bfloat16))
    return inputs


def base_grads(lib, ops, inputs) -> dict:
    """{label: ``lib``'s dw and db at that label's inputs, as one int32
    buffer}: its gradients' bits, to compare bitwise."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    grads = {}
    for label, (saved, g) in inputs.items():
        call = backward_call(lib, ops, saved, g, fm.backward_splits(saved.in8.shape[0]))
        call()
        grads[label] = torch.cat(call.grads).view(torch.int32)
    torch.cuda.synchronize()
    return grads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--sources", default=SOURCE,
                    help="comma-separated copies of fused_mlp_bwd.cu, each built in every variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablate: needs a CUDA device")
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.models.mlp import PackedMLP
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    sources = args.sources.split(",")
    jobs = [(v, src, f"s{i}_") for i, src in enumerate(sources) for v in args.variants.split(",")]
    with ThreadPoolExecutor(min(len(jobs), 8)) as pool:
        libs = list(pool.map(lambda j: build_variant(*j), jobs))
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    fc = from_yaml(bwd_passes.CONFIG)
    mcfg = dataclasses.replace(fc.mlp, num_semantic_classes=bwd_passes.N_CLASSES)
    model = PackedMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(5))
    ops = model.fused_operands(mcfg)
    inputs = grad_inputs(ops, bwd_passes.step_inputs(
        model, fc.render, 2 * fc.train.n_rays, fc.render.n_coarse + fc.render.n_importance, dev))
    saved, g = inputs["fine_step"]
    n = saved.in8.shape[0]
    first = None
    for (v, src, _), path in zip(jobs, libs):
        lib = load_variant(path)
        t = bwd_passes.pass_times(backward_call(lib, ops, saved, g, fm.backward_splits(n)),
                                  args.iters)
        row = {"variant": v, "source": os.path.relpath(src), "points": n,
               "pass_ms": {p: t[p] for p in bwd_passes.PASSES}, "card": card}
        if v == "base":
            grads = base_grads(lib, ops, inputs)
            if first is None:
                first = grads
            else:
                row["same_as_first"] = {k: torch.equal(x, first[k]) for k, x in grads.items()}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
