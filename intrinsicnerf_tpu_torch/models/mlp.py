"""The intrinsic NeRF MLP: trunk + five heads, as an ``nn.Module``.

Port of ``intrinsicnerf_tpu/models/mlp.py`` (reference ``Semantic_NeRF``):

- trunk: D=8 layers of width W=256, ReLU, skip-concat ``[input_pts, h]``
  after layer index 4;
- heads off the trunk feature: sigma (linear), semantic (W->W/2->C),
  albedo (W->W/2->3, sigmoid), shading (W->W/2->1, sigmoid);
- view branch: ``feature_linear(h)`` concat dir-PE -> W/2, ReLU ->
  residual (3, sigmoid);
- ``rgb = albedo * shading + residual``.

Parameter names are the reference state_dict keys (``pts_linears.{i}``,
``alpha_linear``, ``semantic_linear.0.0`` ...), so a reference checkpoint
loads with ``load_state_dict``.  ``nn.Linear`` stores ``[out, in]``; the
JAX pytree stores ``[in, out]`` (``tools/import_ckpt.py`` converts).

:class:`PackedMLP` holds the same weights in the fused kernels' layout
(``ops/fused_mlp.py:FlatBlocks``), the packed training state that
``train/step.py:packs_state`` selects; its ``state_dict`` and
``load_state_dict`` speak the reference layout all the same.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.core.compositing import RawOutputs
from intrinsicnerf_tpu_torch.core.pe import pe_output_dim, positional_encoding
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    depth: int = 8
    width: int = 256
    skips: Tuple[int, ...] = (4,)
    n_freqs_pos: int = 10
    n_freqs_dir: int = 4
    pos_scalar_factor: float = 1.0  # 10.0 for Replica scenes, 1.0 for objects
    use_viewdirs: bool = True
    enable_semantic: bool = False
    num_semantic_classes: int = 0
    compute_dtype: Any = torch.float32  # trunk matmul dtype (bf16 for speed)
    use_fused_kernel: bool = False  # fused trunk+heads kernel (D=8/skip 4)

    @property
    def input_ch(self) -> int:
        return pe_output_dim(self.n_freqs_pos)

    @property
    def input_ch_views(self) -> int:
        return pe_output_dim(self.n_freqs_dir)


def fuses(cfg: MLPConfig) -> bool:
    """Whether ``cfg`` evaluates through the fused kernels: the reference
    architecture (D=8, skip 4, viewdirs on) with the PE widths and the
    classes fitting the packed layout, and ``use_fused_kernel`` set."""
    return (
        cfg.use_fused_kernel
        and cfg.depth == 8
        and tuple(cfg.skips) == (4,)
        and cfg.use_viewdirs
        and cfg.input_ch <= fm.DIR_OFF
        and cfg.input_ch_views <= fm.IN_W - fm.DIR_OFF
        and 8 + max(cfg.num_semantic_classes, 1) <= fm.OUT_W
    )


class _FusedCache:
    """The fused kernel's operands and PE constants, kept per model."""

    def _init_cache(self):
        self._fused: Optional[fm.FusedOperands] = None
        self._fused_key: Optional[tuple] = None
        self._pe: dict = {}

    def fused_operands(self, cfg: MLPConfig) -> fm.FusedOperands:
        """The fused kernel's operands for the current weights under
        ``cfg`` (on the card with kernel 1's weight image), packed on the
        first call and kept until ``cfg`` changes
        or a parameter is changed in place (an optimizer step,
        ``load_state_dict``), replaced or moved.  A write through
        ``.data`` bypasses the version counter and is not seen."""
        key = (cfg, *((p.data_ptr(), p._version) for p in self.parameters()))
        if key != self._fused_key:
            dev = next(self.parameters()).device
            self._fused = fm.fused_operands(self._fused_params(), cfg, dev)
            self._fused_key = key
        return self._fused

    def pe_constants(self, cfg: MLPConfig):
        """The fused kernel's PE constants for ``cfg`` on the parameters'
        device, made once (a host-to-device copy per step would stall)."""
        dev = next(self.parameters()).device
        key = (cfg.n_freqs_pos, cfg.n_freqs_dir, cfg.pos_scalar_factor, dev)
        if key not in self._pe:
            self._pe[key] = fm.pe_constants(cfg, dev)
        return self._pe[key]


class IntrinsicMLP(_FusedCache, nn.Module):
    """Weights of one level (coarse or fine).  Built on ``device``
    (default ``"cuda"``, which raises without a GPU) and initialised
    from ``generator`` with torch's ``U(+-1/sqrt(fan_in))`` Linear init."""

    def __init__(
        self,
        cfg: MLPConfig,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if any(s >= cfg.depth - 1 for s in cfg.skips):
            raise ValueError(
                f"skip indices {cfg.skips} must be < depth-1 ({cfg.depth - 1}): "
                "the skip concat widens the trunk and must be consumed by a "
                "later layer"
            )
        dev = resolve_device(device)
        self.cfg = cfg
        W, D = cfg.width, cfg.depth
        in_ch, in_ch_views = cfg.input_ch, cfg.input_ch_views

        def lin(fan_in_, fan_out_):  # filled from ``generator`` below
            return nn.utils.skip_init(nn.Linear, fan_in_, fan_out_)

        fan_in = [in_ch] + [W + in_ch if i in cfg.skips else W for i in range(D - 1)]
        self.pts_linears = nn.ModuleList([lin(f, W) for f in fan_in])
        self.alpha_linear = lin(W, 1)
        self.albedo_linear1 = lin(W, W // 2)
        self.albedo_linear2 = lin(W // 2, 3)
        self.shading_linear1 = lin(W, W // 2)
        self.shading_linear2 = lin(W // 2, 1)
        self.feature_linear = lin(W, W)
        self.views_linears = nn.ModuleList([lin(W + in_ch_views, W // 2)])
        self.residual_linear = lin(W // 2, 3)
        if cfg.enable_semantic:
            if cfg.num_semantic_classes <= 0:
                raise ValueError("enable_semantic needs num_semantic_classes > 0")
            self.semantic_linear = nn.Sequential(
                nn.Sequential(lin(W, W // 2), nn.ReLU()),
                lin(W // 2, cfg.num_semantic_classes),
            )

        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = 1.0 / m.in_features ** 0.5
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)
        self.to(dev)
        self._init_cache()

    def _fused_params(self):
        return self.state_dict()

    def forward(self, pts_embedded, dirs_embedded, want_endpoint_feat=False):
        return apply_mlp(self, self.cfg, pts_embedded, dirs_embedded, want_endpoint_feat)


class PackedMLP(_FusedCache, nn.Module):
    """Weights of one level as the packed training state: ``weight`` and
    ``bias`` are the fused kernels' flat fp32 buffers
    (``fm.FlatBlocks``: every packed block ``[in, out]`` in the kernels'
    order, the padded slots zero), so a step neither packs nor unpacks,
    and one optimizer updates two tensors per level.  The initial weights
    are the pack of an :class:`IntrinsicMLP` made from the same
    ``generator``, so both layouts start from the same network.

    ``weight_mask`` / ``bias_mask`` mark the real parameter slots
    (``fm.packed_grad_masks``): the padded slots get gradients from the
    shared output product, and :meth:`mask_grads` drops them before the
    update.  ``state_dict`` and ``load_state_dict`` speak the reference
    layout (``[out, in]`` weights under the reference keys), unpacking and
    packing, so checkpoints and the weight bridge treat both classes
    alike, also as a submodule."""

    def __init__(self, cfg: MLPConfig, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if not fuses(cfg):
            raise ValueError("packed state needs a configuration the fused kernels take "
                             "(models/mlp.py:fuses)")
        dev = resolve_device(device)
        self.cfg = cfg
        ref = IntrinsicMLP(cfg, device="cpu", generator=generator).state_dict()
        flat = fm.flatten_blocks(fm.pack_weights(ref, cfg))
        mask = fm.flatten_blocks(fm.packed_grad_masks(ref, cfg))
        self.weight = nn.Parameter(flat.weight.to(dev))
        self.bias = nn.Parameter(flat.bias.to(dev))
        self.register_buffer("weight_mask", mask.weight.to(dev), persistent=False)
        self.register_buffer("bias_mask", mask.bias.to(dev), persistent=False)
        self.reference_keys = tuple(ref)  # in IntrinsicMLP's parameter order
        self._init_cache()

    def flat(self) -> fm.FlatBlocks:
        return fm.FlatBlocks(self.weight, self.bias)

    def unpack(self, flat: fm.FlatBlocks) -> dict:
        """Buffers in this layout (the weights, or Adam's moments of them)
        -> the reference layout."""
        return fm.unpack_weights(fm.flat_blocks(flat, self.cfg), self.cfg)

    def pack(self, sd) -> fm.FlatBlocks:
        """Inverse of :meth:`unpack`."""
        return fm.flatten_blocks(fm.pack_weights(sd, self.cfg))

    def _fused_params(self):
        return self.flat()

    @torch.no_grad()
    def mask_grads(self) -> None:
        """Project the gradients onto the real parameter slots."""
        self.weight.grad.mul_(self.weight_mask)
        self.bias.grad.mul_(self.bias_mask)

    def unpacked(self) -> dict:
        """The weights in the reference layout, differentiable through
        the buffers."""
        return self.unpack(self.flat())

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        """The reference entries under ``prefix``: ``[out, in]`` weights
        copied out of the buffers (differentiable through them with
        ``keep_vars``)."""
        with torch.set_grad_enabled(keep_vars and torch.is_grad_enabled()):
            sd = self.unpacked()
        for k, v in sd.items():
            destination[prefix + k] = v if keep_vars else v.detach().clone()

    @torch.no_grad()
    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        """Pack the reference entries under ``prefix`` into the buffers in
        place; an entry left out (``strict=False``) keeps its value."""
        sd = self.unpacked()
        for k in self.reference_keys:
            if prefix + k in state_dict:
                sd[k] = state_dict[prefix + k]
            else:
                missing_keys.append(prefix + k)
        if strict:
            unexpected_keys.extend(k for k in state_dict if k.startswith(prefix)
                                   and k[len(prefix):] not in self.reference_keys)
        dev = self.weight.device
        flat = self.pack({k: v.to(dev, torch.float32) for k, v in sd.items()})
        self.weight.copy_(flat.weight)
        self.bias.copy_(flat.bias)


MLP = Union[IntrinsicMLP, PackedMLP]  # one level's weights, in either layout


def _layers(sd: dict, cfg: MLPConfig) -> SimpleNamespace:
    """A reference state_dict as the layer attributes :func:`apply_mlp`
    reads."""
    def lin(name):
        return SimpleNamespace(weight=sd[f"{name}.weight"], bias=sd[f"{name}.bias"])

    m = SimpleNamespace(
        pts_linears=[lin(f"pts_linears.{i}") for i in range(cfg.depth)],
        alpha_linear=lin("alpha_linear"), albedo_linear1=lin("albedo_linear1"),
        albedo_linear2=lin("albedo_linear2"), shading_linear1=lin("shading_linear1"),
        shading_linear2=lin("shading_linear2"), feature_linear=lin("feature_linear"),
        views_linears=[lin("views_linears.0")], residual_linear=lin("residual_linear"))
    if cfg.enable_semantic:
        m.semantic_linear = [[lin("semantic_linear.0.0")], lin("semantic_linear.1")]
    return m


def _dense(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    w, b = layer.weight, layer.bias
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return torch.nn.functional.linear(x, w, b.to(x.dtype))


def apply_mlp(
    model: IntrinsicMLP,
    cfg: MLPConfig,
    pts_embedded: torch.Tensor,  # [..., input_ch]
    dirs_embedded: Optional[torch.Tensor],  # [..., input_ch_views]
    want_endpoint_feat: bool = False,
) -> RawOutputs:
    """Evaluate the network on embedded points/dirs; any leading batch dims."""
    cd = cfg.compute_dtype
    h = pts_embedded.to(cd)
    inp = h
    for i, layer in enumerate(model.pts_linears):
        h = torch.relu(_dense(layer, h, cd))
        if i in cfg.skips:
            h = torch.cat([inp, h], dim=-1)

    h32 = h.float()
    sigma = _dense(model.alpha_linear, h32)[..., 0]
    albedo = torch.sigmoid(
        _dense(model.albedo_linear2, torch.relu(_dense(model.albedo_linear1, h32)))
    )
    shading = torch.sigmoid(
        _dense(model.shading_linear2, torch.relu(_dense(model.shading_linear1, h32)))
    )[..., 0]

    sem_logits = None
    if cfg.enable_semantic:
        sem_logits = _dense(
            model.semantic_linear[1],
            torch.relu(_dense(model.semantic_linear[0][0], h32)),
        )

    if cfg.use_viewdirs and dirs_embedded is not None:
        feature = _dense(model.feature_linear, h, cd)
        hv = torch.cat([feature, dirs_embedded.to(cd)], dim=-1)
        hv32 = torch.relu(_dense(model.views_linears[0], hv, cd)).float()
        residual = torch.sigmoid(_dense(model.residual_linear, hv32))
    else:
        # plain-NeRF mode: no view-dependent residual
        residual = torch.zeros_like(albedo)
        hv32 = h32

    rgb = albedo * shading[..., None] + residual
    return RawOutputs(
        rgb=rgb,
        sigma=sigma,
        albedo=albedo,
        shading=shading,
        residual=residual,
        sem_logits=sem_logits,
        endpoint_feat=hv32 if want_endpoint_feat else None,
    )


def eval_points(
    model: MLP,
    cfg: MLPConfig,
    pts: torch.Tensor,  # [N, S, 3] world-space sample positions
    viewdirs: Optional[torch.Tensor],  # [N, 3] unit view directions
    want_endpoint_feat: bool = False,
) -> RawOutputs:
    """PE + MLP over a ray batch.  The reference architecture (D=8, skip
    4, viewdirs on, PE and classes fitting the packed layout) goes
    through the fused kernels when ``cfg.use_fused_kernel`` is set
    (:func:`fuses`): with grad enabled, through the model's packed
    buffers (a :class:`PackedMLP`) or a pack of its live parameters (an
    :class:`IntrinsicMLP`), which autograd differentiates (kernel 1
    forward, kernel 2 backward); without, through the operands the model
    keeps (kernel 1 only).  Elsewhere a :class:`PackedMLP` is unpacked
    first, as the JAX ``eval_points`` unpacks packed state."""
    if fuses(cfg) and not want_endpoint_feat and viewdirs is not None:
        if not torch.is_grad_enabled():
            return fm.fused_eval_points(model.fused_operands(cfg), cfg, pts, viewdirs)
        params = (model.flat() if isinstance(model, PackedMLP)
                  else dict(model.named_parameters()))
        return fm.fused_eval_points(params, cfg, pts, viewdirs, pe=model.pe_constants(cfg))
    if isinstance(model, PackedMLP):
        model = _layers(model.unpacked(), model.cfg)
    pe_pts = positional_encoding(pts, cfg.n_freqs_pos, scalar_factor=cfg.pos_scalar_factor)
    pe_dirs = None
    if cfg.use_viewdirs and viewdirs is not None:
        pe_dirs = positional_encoding(viewdirs, cfg.n_freqs_dir)
        pe_dirs = pe_dirs[..., None, :].expand(*pts.shape[:-1], pe_dirs.shape[-1])
    return apply_mlp(model, cfg, pe_pts, pe_dirs, want_endpoint_feat)
