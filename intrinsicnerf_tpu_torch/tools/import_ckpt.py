"""Reference checkpoints and the JAX weight tree, carried into the port.

The port's ``IntrinsicMLP`` names its parameters with the reference
state_dict keys, so a scene checkpoint (``Semantic_NeRF``) loads with
``load_state_dict`` as it is.  The object-level ``NeRF`` names its
shading head ``test_linear1/2`` and its residual head ``shading_linear``
(identical math); :func:`to_port_state_dict` renames those.

The JAX package keeps ``{"trunk": [{"kernel", "bias"}, ...], "sigma":
..., ...}`` with ``[in, out]`` kernels; :func:`params_from_jax` and
:func:`params_to_jax` convert between that tree (as numpy) and a
state_dict.  Its packed state (the kernels' 38 padded blocks, kept where
the JAX ``packs_state`` holds) maps straight onto the port's packed
training state (``models/mlp.py:PackedMLP``, the kernels' flat buffers)
with :func:`packed_from_jax` and back with :func:`packed_to_jax`; no
unpacking in between.  A reference checkpoint read by
:func:`load_reference_checkpoint` loads into either layout with
``load_state_dict`` (a ``PackedMLP`` packs it, as the JAX
``import_reference_checkpoint`` does).  This module keeps
its own copy of the name maps: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

# JAX pytree head name -> reference / port module name
HEADS = {
    "sigma": "alpha_linear",
    "albedo1": "albedo_linear1",
    "albedo2": "albedo_linear2",
    "shading1": "shading_linear1",
    "shading2": "shading_linear2",
    "feature": "feature_linear",
    "views": "views_linears.0",
    "residual": "residual_linear",
    "sem1": "semantic_linear.0.0",
    "sem2": "semantic_linear.1",
}
# object-level NeRF module name -> port module name
OBJECT_TO_PORT = {
    "test_linear1": "shading_linear1",
    "test_linear2": "shading_linear2",
    "shading_linear": "residual_linear",
}


def _np(t) -> np.ndarray:
    """torch tensor (any device/dtype) -> fp32 numpy."""
    return np.asarray(t.detach().float().cpu().numpy(), np.float32)


def detect_flavor(sd: Dict[str, Any]) -> str:
    """'scene' (Semantic_NeRF) or 'object' (object-level NeRF)."""
    if "residual_linear.weight" in sd or "semantic_linear.1.weight" in sd:
        return "scene"
    if "test_linear1.weight" in sd:
        return "object"
    raise ValueError(
        "unrecognized reference state_dict: expected Semantic_NeRF "
        "(residual_linear/semantic_linear) or object-level NeRF "
        f"(test_linear*) keys; got {sorted(sd)[:8]}..."
    )


def infer_arch(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Architecture facts encoded in the state_dict shapes."""
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("pts_linears."))
    width, input_ch = sd["pts_linears.0.weight"].shape  # [W, input_ch]
    # skip layers consume [input_pts, h]: fan_in = W + input_ch
    skips = tuple(
        i - 1
        for i in range(1, depth)
        if sd[f"pts_linears.{i}.weight"].shape[1] == width + input_ch
    )
    n_freqs_pos = (input_ch // 3 - 1) // 2  # input_ch = 3 * (1 + 2*n_freqs)
    in_ch_views = sd["views_linears.0.weight"].shape[1] - width
    n_freqs_dir = (in_ch_views // 3 - 1) // 2
    enable_semantic = "semantic_linear.1.weight" in sd
    num_classes = sd["semantic_linear.1.weight"].shape[0] if enable_semantic else 0
    return {
        "depth": int(depth),
        "width": int(width),
        "skips": skips,
        "n_freqs_pos": int(n_freqs_pos),
        "n_freqs_dir": int(n_freqs_dir),
        "enable_semantic": enable_semantic,
        "num_semantic_classes": int(num_classes),
    }


def to_port_state_dict(sd: Dict[str, Any], flavor: str | None = None) -> Dict[str, Any]:
    """A reference state_dict of either flavor, keyed for ``IntrinsicMLP``."""
    if (flavor or detect_flavor(sd)) == "scene":
        return dict(sd)
    out = {}
    for k, v in sd.items():
        mod, _, leaf = k.rpartition(".")
        out[f"{OBJECT_TO_PORT.get(mod, mod)}.{leaf}"] = v
    return out


def load_reference_checkpoint(path: str):
    """Read a reference ``.ckpt``/``.tar`` -> (step, sd_coarse, sd_fine),
    with ``sd_fine`` None for coarse-only object checkpoints."""
    ckpt = torch.load(path, map_location="cpu")
    step = int(ckpt.get("global_step", 0))
    if "network_coarse_state_dict" in ckpt:  # scene .ckpt
        return step, ckpt["network_coarse_state_dict"], ckpt["network_fine_state_dict"]
    if "network_fn_state_dict" in ckpt:  # object .tar
        return step, ckpt["network_fn_state_dict"], ckpt.get("network_fine_state_dict")
    raise ValueError(
        f"{path}: no network_coarse_state_dict/network_fn_state_dict key — "
        "not a reference IntrinsicNeRF checkpoint"
    )


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves, ``[in, out]`` kernels) -> a
    state_dict with ``[out, in]`` weights on ``device``, for
    ``load_state_dict``."""
    dev = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {}

    def put(name, layer):
        w = np.array(layer["kernel"], np.float32).T.copy()
        sd[f"{name}.weight"] = torch.from_numpy(w).to(dev)
        sd[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32)).to(dev)

    for i, layer in enumerate(tree["trunk"]):
        put(f"pts_linears.{i}", layer)
    for head, name in HEADS.items():
        if head in tree:
            put(name, tree[head])
    return sd


def params_to_jax(module: torch.nn.Module) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: a model -> JAX tree of numpy."""
    sd = module.state_dict()

    def get(name):
        return {"kernel": _np(sd[f"{name}.weight"]).T.copy(), "bias": _np(sd[f"{name}.bias"])}

    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("pts_linears."))
    tree: Dict[str, Any] = {"trunk": [get(f"pts_linears.{i}") for i in range(depth)]}
    for head, name in HEADS.items():
        if f"{name}.weight" in sd:
            tree[head] = get(name)
    return tree


def packed_from_jax(tree: Dict[str, Any], device="cuda") -> fm.FlatBlocks:
    """A JAX packed-state tree (the 38 blocks of its ``pack_weights``, as
    numpy) -> the port's packed buffers on ``device``, for
    ``PackedMLP.weight`` / ``.bias``."""
    dev = resolve_device(device)
    flat = fm.flatten_blocks({k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()})
    return fm.FlatBlocks(flat.weight.to(dev), flat.bias.to(dev))


def packed_to_jax(model) -> Dict[str, np.ndarray]:
    """Inverse of :func:`packed_from_jax`: a ``PackedMLP`` -> the JAX
    packed tree of numpy blocks."""
    blocks = fm.flat_blocks(fm.FlatBlocks(model.weight.detach(), model.bias.detach()), model.cfg)
    return {k: _np(v) for k, v in blocks.items()}



def mlp_config_from_arch(arch: Dict[str, Any], pos_scalar_factor: float, compute_dtype=None,
                         use_fused_kernel=None):
    """The ``MLPConfig`` of imported weights: the architecture from the
    checkpoint (``infer_arch``), the scene scale and the compute path from
    the caller's config (twin of the JAX ``mlp_config_from_arch``)."""
    from intrinsicnerf_tpu_torch.config import _fused_kernel_default
    from intrinsicnerf_tpu_torch.models.mlp import MLPConfig

    if use_fused_kernel is None:
        use_fused_kernel = _fused_kernel_default(arch["depth"], arch["width"], True)
    return MLPConfig(
        depth=arch["depth"], width=arch["width"], skips=arch["skips"],
        n_freqs_pos=arch["n_freqs_pos"], n_freqs_dir=arch["n_freqs_dir"],
        pos_scalar_factor=pos_scalar_factor, use_viewdirs=True,
        enable_semantic=arch["enable_semantic"],
        num_semantic_classes=arch["num_semantic_classes"],
        compute_dtype=compute_dtype if compute_dtype is not None else torch.bfloat16,
        use_fused_kernel=use_fused_kernel)


def import_reference_checkpoint(path: str, pos_scalar_factor: float = 10.0, tcfg=None,
                                compute_dtype=None, use_fused_kernel=None, device="cuda"):
    """A reference ``.ckpt``/``.tar`` -> (``TrainState`` on ``device``,
    ``MLPConfig``): the packed training state where ``packs_state`` holds
    for the config, else the unpacked one, at the file's ``global_step``
    with a fresh Adam state.  As the JAX ``import_reference_checkpoint``
    does, Adam's moments start at zero and its step counts at the imported
    step (the reference's moments are keyed by registration order and are
    not carried over); the LR follows the step."""
    from intrinsicnerf_tpu_torch.train.step import TrainConfig, create_train_state

    step, sd_c, sd_f = load_reference_checkpoint(path)
    flavor = detect_flavor(sd_c)
    sd_c = to_port_state_dict(sd_c, flavor)
    mcfg = mlp_config_from_arch(infer_arch(sd_c), pos_scalar_factor, compute_dtype,
                                use_fused_kernel)
    state = create_train_state(mcfg, tcfg or TrainConfig(), device=device,
                               with_fine=sd_f is not None)
    state.model_coarse.load_state_dict(sd_c)
    if sd_f is not None:
        state.model_fine.load_state_dict(to_port_state_dict(sd_f, flavor))
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            state.optimizer.state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32,
                                     device=p.device if group["capturable"] else "cpu"),
                "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
    state.step = step
    state.step_t.fill_(step)
    return state, mcfg


def import_to_checkpoint(path: str, save_dir: str, pos_scalar_factor: float = 10.0,
                         compute_dtype=None, use_fused_kernel=None, device="cuda"):
    """Write :func:`import_reference_checkpoint`'s state as
    ``<save_dir>/checkpoints/{step:06d}.ckpt``, the port's checkpoint, so
    the trainers' resume, ``--render_only`` and ``extract_mesh`` find it.
    Returns (step, ``MLPConfig``, the file written)."""
    import os

    from intrinsicnerf_tpu_torch.train.checkpoint import _write, checkpoint_path, snapshot

    state, mcfg = import_reference_checkpoint(path, pos_scalar_factor, None, compute_dtype,
                                              use_fused_kernel, device)
    ckpt_dir = os.path.join(save_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    out = checkpoint_path(ckpt_dir, state.step)
    _write(snapshot(state), out)
    return state.step, mcfg, out
