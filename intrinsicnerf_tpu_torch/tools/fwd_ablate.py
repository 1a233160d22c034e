"""Where kernel 1 spends its time, by ablation, on the card.

Builds variants of ``ops/csrc/fused_mlp_fwd.cu``, each with one part of
the forward cut out by a text patch of a copy of the source, and times
the kernel in each with CUDA events at the training step's fine shape
(196,608 points) and at the serving view's fine chunk (6,291,456 points):

- ``base``: the kernel as it is;
- ``no_mma``: the wgmma products (the ring still streams every slab);
- ``no_weight_loads``: the producer's bulk copies into the ring (it
  arrives on each stage's full barrier with no bytes to wait for, and the
  products read whatever the stages hold);
- ``no_epilogues``: the bias, ReLU and bf16 stores of every hidden layer
  (the output tile's are kept);
- ``no_output_stores``: the output tile's staging and its stores;
- ``no_consumer_sync``: the barrier of the two consumer warpgroups before
  each product (it orders every epilogue before the next product's reads);
- ``no_pe``: the PE warps' arithmetic (they still stage each tile's in8
  rows and arrive on its feature buffer's full barrier, so the consumers
  run on whatever the buffer holds and nothing waits forever);
- ``pe_serial``: the PE warps encode a tile only once the consumers have
  released the tile before it, so the encoding no longer overlaps the
  chain: the staged feed alone, the overlap's worth measured apart.

Each variant's training (saving) instance is timed beside it at the fine
step (``save_ms``), where a build has one.  A cut computes garbage; only
its time means anything.  The ``base`` build of each source is also held
against the plain version at the fine step (max |d| / max(|plain|, 1)
over the output, and a bitwise repeat), and its saving instance's output
against its serving one's, bitwise (``save_same_out``).
The patched sources and libraries go to ``_build/ablate/``
(``tools/bwd_ablate.py`` builds them).  One JSON line per variant and
source with the kernel's ms at each shape and the card's name and power
limit:

    python -m intrinsicnerf_tpu_torch.tools.fwd_ablate [--iters 5]

``--sources a.cu,b.cu`` builds each listed copy of ``fused_mlp_fwd.cu``
(an experiment beside the committed kernel, or the parent's with
``--variants base``) in every variant, in turns; each later source's
``base`` row also says whether its output equals the first source's,
bitwise, at each shape (``same_as_first``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from intrinsicnerf_tpu_torch.ops import build
from intrinsicnerf_tpu_torch.tools import bwd_ablate, bwd_passes

_MMA = """      if constexpr (NW == 128)
        hmma::wgmma_m64n128k16<0, 1>(acc, da, db, 1);
      else
        hmma::wgmma_m64n64k16<0, 1>(acc, da, db, 1);"""
_LOADS = """        hmma::mbar_expect_tx(full + st * 8, bytes);
        if constexpr (SAVE)
          hmma::bulk_load_evict_last(ring + st * STAGE_BYTES, src, bytes, full + st * 8);
        else
          hmma::bulk_load(ring + st * STAGE_BYTES, src, bytes, full + st * 8);"""
_EPI = "  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;\n"
_STORE = "  unsigned char* A = S + wg * ATOM;\n"
_SYNC = ("  hmma::fence_proxy_async();  // the epilogues' shared writes, to wgmma's proxy\n"
         "  consumer_sync();\n")
_FEAT = "  for (int e = threadIdx.x - (NTHREADS + 32); e < TILE_M * IN_W; e += PE_THREADS) {\n"
_PE_WAIT = "    if (j >= 2) hmma::mbar_wait(feat_empty + buf * 8, ((j >> 1) - 1) & 1);\n"

PATCHES = {
    "base": [],
    "no_mma": [(_MMA, "      (void)da;\n      (void)db;")],
    "no_weight_loads": [(_LOADS, "        hmma::mbar_arrive(full + st * 8);")],
    "no_epilogues": [(_EPI, "  return;\n" + _EPI)],
    "no_output_stores": [(_STORE, "  return;\n" + _STORE)],
    "no_consumer_sync": [(_SYNC, "")],
    "no_pe": [(_FEAT, "  return;\n" + _FEAT)],
    # wait for the release of tile j - 1 (buffer j - 1 & 1) instead of j - 2
    "pe_serial": [(_PE_WAIT, "    if (j >= 1) hmma::mbar_wait(feat_empty + (buf ^ 1) * 8, "
                             "((j - 1) >> 1) & 1);\n")],
}
SOURCE = os.path.join(build.CSRC, "fused_mlp_fwd.cu")
# the shapes timed: the step's fine call and the view's fine chunk
SHAPES = {"fine_step": 196_608, "fine_chunk": 6_291_456}


def build_variants(variants, sources) -> list:
    """[((variant, source), library path)] for every pair, built at once."""
    jobs = [(v, src, f"s{i}_") for i, src in enumerate(sources) for v in variants]
    with ThreadPoolExecutor(min(len(jobs), 8)) as pool:
        libs = list(pool.map(
            lambda j: bwd_ablate.build_variant(*j, patches=PATCHES, stem="fused_mlp_fwd"), jobs))
    return [((v, src), lib) for (v, src, _), lib in zip(jobs, libs)]


def shape_inputs(model, fc, device) -> dict:
    """{shape: in8} of ``SHAPES``: the step's 1,024 rays at 192 samples,
    and a view's first 32,768-ray chunk at 64 samples, repeated to the
    fine chunk's point count."""
    fine = bwd_passes.step_inputs(model, fc.render, 2 * fc.train.n_rays,
                                  fc.render.n_coarse + fc.render.n_importance, device)
    chunk = bwd_passes.step_inputs(model, fc.render, fc.chunk, fc.render.n_coarse, device)
    n = SHAPES["fine_chunk"]
    return {"fine_step": fine, "fine_chunk": chunk.repeat(-(-n // chunk.shape[0]), 1)[:n]}


def forward_call(lib, ops, in8, save: bool = False):
    """A closure that runs one kernel-1 launch of ``lib`` as the wrapper
    does, on the weight image built by the same library: the serving
    instance, or with ``save`` the saving one into a saved buffer of its
    own."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    dev = in8.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    img = torch.empty_like(ops.wbuf)
    if lib.fused_mlp_fwd_image(ops.wbuf.data_ptr(), img.data_ptr(), stream) != 0:
        raise RuntimeError("fused_mlp_fwd_image launch failed")
    pe_mat, sin_mask = (t.float().contiguous() for t in ops.pe)
    n = in8.shape[0]
    out = torch.empty((n, fm.OUT_W), dtype=torch.bfloat16, device=dev)
    acts, masks, *_ = fm.backward_scratch(n, 1)
    saved = torch.empty(acts + 2 * masks if save else 0, dtype=torch.bfloat16, device=dev)
    args = (in8.data_ptr(), pe_mat.data_ptr(), sin_mask.data_ptr(), img.data_ptr(),
            ops.bbuf.data_ptr(), out.data_ptr())

    def call():
        if save:
            err = lib.fused_mlp_fwd_save(*args, saved.data_ptr(), n, stream)
        else:
            err = lib.fused_mlp_fwd(*args, n, stream)
        if err != 0:
            raise RuntimeError(f"fused_mlp_fwd launch failed: cudaError {err}")
    call.out = out
    return call


def event_ms(fn, iters: int) -> float:
    """Mean device ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_base(lib, ops, in8) -> dict:
    """The base build against the plain version: max |d| / max(|plain|, 1)
    over the output, and whether two launches agree bitwise."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    outs = []
    for _ in range(2):
        call = forward_call(lib, ops, in8)
        call()
        outs.append(call.out.clone())
    torch.cuda.synchronize()
    ref = fm.fused_mlp_forward_plain(ops.packed, ops.pe, in8).float()
    err = (outs[0].float() - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
    return {"rel_err": err, "bitwise_repeat": torch.equal(outs[0].view(torch.int16),
                                                          outs[1].view(torch.int16))}


def time_variants(built, ops, inputs, iters: int) -> list:
    """[{variant, source, ms: {shape: ms}}] for each built library; the
    base builds also carry ``check_base`` at the fine step, and those of
    every source after the first ``same_as_first``: {shape: whether its
    output equals the first source's base output bitwise}."""
    rows, first = [], None
    for (v, src), path in built:
        lib = bwd_ablate.load_variant(path, "fused_mlp_fwd")
        calls = {label: forward_call(lib, ops, in8) for label, in8 in inputs.items()}
        ms = {label: event_ms(call, iters) for label, call in calls.items()}
        row = {"variant": v, "source": os.path.relpath(src), "ms": ms}
        saving = None
        if hasattr(lib, "fused_mlp_fwd_save"):
            saving = forward_call(lib, ops, inputs["fine_step"], save=True)
            row["save_ms"] = {"fine_step": event_ms(saving, iters)}
        if v == "base":
            row.update(check_base(lib, ops, inputs["fine_step"]))
            if saving is not None:
                row["save_same_out"] = torch.equal(saving.out.view(torch.int16),
                                                   calls["fine_step"].out.view(torch.int16))
            outs = {label: call.out.view(torch.int16) for label, call in calls.items()}
            if first is None:
                first = outs
            else:
                row["same_as_first"] = {label: torch.equal(out, first[label])
                                        for label, out in outs.items()}
        rows.append(row)
        del calls, saving  # its outputs, before the next variant allocates its own
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--sources", default=SOURCE,
                    help="comma-separated copies of fused_mlp_fwd.cu, each built in every variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fwd_ablate: needs a CUDA device")
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.models.mlp import PackedMLP

    built = build_variants(args.variants.split(","), args.sources.split(","))
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    fc = from_yaml(bwd_passes.CONFIG)
    mcfg = dataclasses.replace(fc.mlp, num_semantic_classes=bwd_passes.N_CLASSES)
    model = PackedMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(5))
    ops = model.fused_operands(mcfg)
    for row in time_variants(built, ops, shape_inputs(model, fc, dev), args.iters):
        print(json.dumps({**row, "points": SHAPES, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
