"""Where kernel 2's activation pass spends its time, by ablation, on the card.

Builds variants of ``ops/csrc/fused_mlp_bwd.cu``, each with one part of
the activation pass (``bwd_act_wgmma_kernel``) cut out by a text patch of
a copy of the source, and times that pass in each at the training step's
fine shape (196,608 points; ``tools/bwd_passes.py``'s inputs):

- ``base``: the kernel as it is;
- ``no_arena_stores``: the 16-byte copies of each buffer to the arena;
- ``no_epilogues``: every epilogue (bias, ReLU, masks, bf16 stores,
  column sums, arena copies);
- ``no_mma``: the wgmma products (the ring still streams every slab);
- ``no_weight_loads``: the producer's bulk copies into the ring (the
  products read whatever the stages hold);
- ``loads_only``: no products and no epilogues, only the weight stream;
- ``stages2``: a ring of two stages instead of three.

A variant computes garbage; only its time means anything.  The patched
sources and libraries go to ``_build/ablate/``.  One JSON line per
variant with the pass's device ms and the card's name and power limit:

    python -m intrinsicnerf_tpu_torch.tools.bwd_ablate [--iters 10]
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
        hmma::wgmma_m64n128k16<0, WT ? 0 : 1>(acc, da, db, 1);
      else
        hmma::wgmma_m64n64k16<0, WT ? 0 : 1>(acc, da, db, 1);"""
_LOADS = """      hmma::mbar_expect_tx(full + st * 8, bytes);
      hmma::bulk_load(ring + st * ACT_STAGE_BYTES, img + off, bytes, full + st * 8);"""
_FWD_EPI = "  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127, lane = lt & 31;\n"
_GRAD_EPI = ("  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127, warp = lt >> 5, "
             "lane = lt & 31;\n")
_COPY = "  const int cpr = ncols >> 3;\n"

PATCHES = {
    "base": [],
    "no_arena_stores": [(_COPY, "  return;\n" + _COPY)],
    "no_epilogues": [(_FWD_EPI, "  return;\n" + _FWD_EPI), (_GRAD_EPI, "  return;\n" + _GRAD_EPI)],
    "no_mma": [(_MMA, "      (void)da;\n      (void)db;")],
    "no_weight_loads": [(_LOADS, "      hmma::mbar_arrive(full + st * 8);")],
    "stages2": [("constexpr int ACT_STAGES = 3;", "constexpr int ACT_STAGES = 2;")],
}
PATCHES["loads_only"] = PATCHES["no_mma"] + PATCHES["no_epilogues"]
SOURCE = os.path.join(build.CSRC, "fused_mlp_bwd.cu")


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
    lib = ctypes.CDLL(path)
    for entry, argtypes, restype in build.SIGNATURES[name]:
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def backward_call(lib, ops, in8, g, splits: int):
    """A closure that runs one kernel-2 call of ``lib`` as the wrapper does."""
    n, dev = in8.shape[0], in8.device
    sizes = [ctypes.c_longlong() for _ in range(3)]
    lib.fused_mlp_bwd_scratch(n, splits, *(ctypes.byref(x) for x in sizes))
    arena = torch.empty(sizes[0].value, dtype=torch.bfloat16, device=dev)
    bpart = torch.empty(sizes[1].value, dtype=torch.float32, device=dev)
    ws = torch.empty(sizes[2].value, dtype=torch.float32, device=dev)
    dw = torch.empty(ops.wbuf.numel(), dtype=torch.float32, device=dev)
    db = torch.empty(ops.bbuf.numel(), dtype=torch.float32, device=dev)
    pe_mat, sin_mask = (t.float().contiguous() for t in ops.pe)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = lib.fused_mlp_bwd(in8.data_ptr(), pe_mat.data_ptr(), sin_mask.data_ptr(),
                                ops.wbuf.data_ptr(), ops.bbuf.data_ptr(), g.data_ptr(),
                                arena.data_ptr(), bpart.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                                db.data_ptr(), n, splits, stream)
        if err != 0:
            raise RuntimeError(f"fused_mlp_bwd launch failed: cudaError {err}")
    return call


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
    from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP
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
    model = IntrinsicMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(5))
    ops = model.fused_operands(mcfg)
    in8 = bwd_passes.step_inputs(model, fc.render, 2 * fc.train.n_rays,
                                 fc.render.n_coarse + fc.render.n_importance, dev)
    out = fm.fused_mlp_forward(ops, in8)
    g = ((out.float() - 0.5) / out.shape[0]).to(torch.bfloat16)
    splits = fm.backward_splits(in8.shape[0])
    for (v, src, _), lib in zip(jobs, libs):
        t = bwd_passes.pass_times(backward_call(load_variant(lib), ops, in8, g, splits),
                                  args.iters)
        print(json.dumps({"variant": v, "source": os.path.relpath(src), "points": in8.shape[0],
                          "pass_ms": {p: t[p] for p in bwd_passes.PASSES}, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
