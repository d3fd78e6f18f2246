"""Building blocks of the (D)U-Net, NCHW inside.

Module and attribute names follow the reference's ``src/utils/unets.py``
(``ConvBlock.conv`` = Sequential[conv, act, norm, conv, act, norm],
``ConvPool.conv_pool``, ``TranspConvBlock.up`` / ``.norm``), so a
``state_dict`` of these modules has the reference's keys.

``QuantConv`` is the int8 3x3 convolution of ``InferConfig.quantize``: the
same ``weight`` and ``bias`` as the ``nn.Conv2d`` it extends, and an int8
path whose product runs through kernel K5 (``ops/kernels/matmul.py``,
``conv3x3_int8``).
``ConvBlock(remat_policy=)`` recomputes the block's activations in the
backward pass instead of keeping them (the JAX package's ``nn.remat`` of
``ConvBlock``), with the same numbers and the same ``state_dict``.

In eval mode with grad off on the card, each chain [conv -> act ->
BatchNorm] of ``ConvBlock``, ``ConvPool`` and ``TranspConvBlock`` (no act)
runs as the convolution without its bias and one ``conv_epilogue`` launch
(``ops/kernels/epilogue.py``) in place of the bias add, the activation and
the BatchNorm; ``epilogue_route`` decides from what the modules, the grad
mode and the input show.  Every other case runs the modules.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from microbeseg_torch.kernels import _build
from microbeseg_torch.ops.kernels.epilogue import (conv_epilogue_unchecked,
                                                   mish, refusal)
from microbeseg_torch.ops.kernels.matmul import (conv3x3_int8, dequantize,
                                                 matmul_int8, tap_operand)
from microbeseg_torch.parallel.mesh import all_reduce, is_distributed


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def make_act(name: str) -> nn.Module:
    if name == "relu":
        return nn.ReLU()
    if name == "leakyrelu":
        return nn.LeakyReLU(0.01)
    if name == "elu":
        return nn.ELU()
    if name == "mish":
        return Mish()
    raise ValueError(f"Unsupported activation function: {name}")


class CrossReplicaBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over the global batch of a process group, the counterpart
    of the JAX package's BatchNorm on a batch sharded over the mesh (XLA
    reduces its statistics across the replicas).  In training, each rank
    sums its per-channel sum, sum of squares and count, one all-reduce
    (``parallel.mesh.all_reduce``, which autograd sees) gives the global
    ones, and mean and variance follow as flax takes them (``E[x^2] -
    E[x]^2``).  The running statistics are updated as ``nn.BatchNorm2d``
    updates them (momentum, the unbiased variance of the global batch).
    The same code runs on CUDA and CPU tensors (``nn.SyncBatchNorm`` takes
    only CUDA tensors).  In eval mode, and outside a process group, it is
    ``nn.BatchNorm2d``; the parameters and buffers keep their names."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or not is_distributed():
            return super().forward(x)
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype,
                           device=x.device)
        sums = all_reduce(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                     count]))
        n = sums[-1]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(
                m * var.detach() * n.detach() / torch.clamp(n.detach() - 1,
                                                            min=1))
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * scale
        y = xf * scale.view(1, c, 1, 1) + shift.view(1, c, 1, 1)
        return y.to(x.dtype)


def _fused_act(act: Optional[nn.Module]) -> Optional[str]:
    """The ``conv_epilogue`` activation that computes ``act`` (None:
    'identity'), or None for one it does not have."""
    if act is None:
        return "identity"
    kind = type(act)
    if kind is nn.ReLU:
        return "relu"
    if kind is nn.LeakyReLU and act.negative_slope == 0.01:
        return "leakyrelu"
    if kind is nn.ELU and act.alpha == 1.0:
        return "elu"
    if kind is Mish:
        return "mish"
    return None


def epilogue_route(training: bool, grad_enabled: bool, device_type: str,
                   norm: nn.Module, act: Optional[nn.Module], channels: int,
                   quantize: bool = False) -> Optional[str]:
    """How a chain [conv -> act -> norm] with ``channels`` outputs runs:
    'fused' (the convolution without its bias, then ``conv_epilogue``) in
    eval mode with grad off on the card, where the norm is a BatchNorm with
    running statistics and affine parameters, the activation one that
    ``conv_epilogue`` has, the channels a multiple of 8 and the int8 path
    off; 'fallback' where only these last conditions fail (the modules run,
    counted as ``conv_epilogue_fallback``); None where the route does not
    apply (training, grad on, the CPU, GroupNorm or instance norm)."""
    if (training or grad_enabled or device_type != "cuda"
            or not isinstance(norm, nn.BatchNorm2d)):
        return None
    if (quantize or channels % 8 or _fused_act(act) is None
            or norm.weight is None or norm.running_mean is None):
        return "fallback"
    return "fused"


def _route(module: nn.Module, x: torch.Tensor, norm: nn.Module,
           act: Optional[nn.Module], channels: int, chains: int,
           quantize: bool = False) -> Optional[str]:
    """``epilogue_route`` for ``module``'s ``chains`` chains on ``x``; a
    fallback is counted once a chain."""
    route = epilogue_route(module.training or norm.training,
                           torch.is_grad_enabled(), x.device.type, norm, act,
                           channels, quantize)
    if route == "fallback":
        for _ in range(chains):
            _build.count_launch("conv_epilogue_fallback")
    return route


def _epilogue(z: torch.Tensor, bias: Optional[torch.Tensor],
              act: Optional[nn.Module], norm: nn.Module) -> torch.Tensor:
    """``norm(act(z + bias))`` for ``z``, a convolution's output without its
    bias: one ``conv_epilogue`` launch, or the modules (a fallback) where
    ``z`` or the parameters are not what the kernel takes."""
    name = _fused_act(act)
    if refusal(z, bias, norm, name) is None:
        return conv_epilogue_unchecked(z, bias, norm, name)
    _build.count_launch("conv_epilogue_fallback")
    if bias is not None:
        z = z + bias.to(z.dtype).view(1, -1, 1, 1)
    return norm(z if act is None else act(z))


def make_norm(kind: str, ch: int) -> nn.Module:
    """'bn' (eps 1e-5, momentum 0.1 = flax's 0.9) | 'gn' (8 groups, eps
    1e-5) | 'in' (instance statistics, no affine parameters).  'bn' built
    inside a process group reduces its statistics over the group
    (``CrossReplicaBatchNorm2d``); outside one it is ``nn.BatchNorm2d``."""
    if kind == "bn":
        cls = CrossReplicaBatchNorm2d if is_distributed() else nn.BatchNorm2d
        return cls(ch, eps=1e-5, momentum=0.1)
    if kind == "gn":
        return nn.GroupNorm(8, ch, eps=1e-5)
    if kind == "in":
        return nn.InstanceNorm2d(ch, eps=1e-5, affine=False)
    raise ValueError(f"Unsupported normalization: {kind}")


def _quantize_this(h: int, w: int, c_in: int, c_out: int) -> bool:
    """Layer predicate of int8 inference, the JAX package's: only the 3x3
    convolutions on at least 256^2 pixels with 8 to 256 input and at most
    256 output channels take the int8 path.  The 1-channel input
    convolution, the levels below 256^2 and the deep, wide levels stay in
    the working float type, as do all 1x1, strided and transposed
    convolutions."""
    return h * w >= 256 * 256 and 8 <= c_in <= 256 and c_out <= 256


def _compute_dtype(device_type: str) -> torch.dtype:
    """The dtype a layer hands on: autocast's when it is on, else float32."""
    if torch.is_autocast_enabled(device_type):
        return torch.get_autocast_dtype(device_type)
    return torch.float32


def _in_format_of(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """NCHW ``y`` in the memory format of ``x`` (channels-last or not)."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y.contiguous()


class QuantConv(nn.Conv2d):
    """3x3 convolution, padding 1, with an int8 path for inference.

    The parameters are ``nn.Conv2d``'s ``weight`` (O, I, 3, 3) and ``bias``,
    so checkpoints are the same with and without int8; ``forward`` is
    ``nn.Conv2d``'s.  ``forward_int8`` is the JAX package's ``QuantConv``:

    - weights quantise per output channel, ``w_scale = max(|w|, 1e-12) /
      127``, ``w_q = clip(round(w / w_scale), -127, 127)``;
    - activations quantise with one scale per layer when the layer is
      calibrated (``x_scale = max(act_amax, 1e-12) / 127``; values beyond
      ``act_amax`` saturate), else with one per sample from that sample's
      own ``|x|`` maximum;
    - the convolution is the sum over the 9 taps of int8 products in int32:
      the (B * H * W, 9 * C_in) operand of ``tap_operand`` times ``w_q`` as
      (9 * C_in, C_out);
    - the result is ``y * (x_scale * w_scale) + bias`` in float32, cast to
      the working dtype (autocast's, else float32).

    ``forward_int8`` hands the last two steps to ``conv3x3_int8`` (kernel
    K5's convolution entry); ``tap_operand``, ``int32_conv`` and
    ``dequantize`` are the same steps one by one, the plain version's parts.

    Calibration: while ``calibrating`` is set, ``forward_int8`` runs on the
    per-sample scales and keeps the batch's ``|x|`` maximum aside;
    ``commit_calibration`` merges it into ``act_amax`` (a maximum, so it
    only grows) and marks the layer calibrated.  ``act_amax`` is not part of
    the ``state_dict``."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__(ch_in, ch_out, 3, padding=1)
        self.register_buffer("act_amax", torch.zeros(()), persistent=False)
        self.calibrated = False
        self.calibrating = False
        self._seen_amax = None

    def quantized_weight(self):
        """(w_q (9 * C_in, C_out) int8 in tap order (dy, dx, c), w_scale
        (C_out,) float32)."""
        w = self.weight.detach().float().permute(2, 3, 1, 0)  # (3, 3, I, O)
        w_scale = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
        w_q = torch.clamp(torch.round(w / w_scale), -127, 127).to(torch.int8)
        return w_q.reshape(-1, w_q.shape[-1]), w_scale

    def quantized_input(self, x: torch.Tensor):
        """NCHW ``x`` -> (x_q (B, H, W, C) int8, x_scale: a scalar when
        calibrated, else (B, 1, 1, 1)), both float32 arithmetic."""
        xf = x.permute(0, 2, 3, 1).float()
        if self.calibrating:
            self._seen_amax = xf.abs().max()
        if self.calibrated and not self.calibrating:
            x_scale = torch.clamp(self.act_amax, min=1e-12) / 127.0
        else:
            x_amax = xf.abs().amax(dim=(1, 2, 3), keepdim=True)
            x_scale = torch.clamp(x_amax, min=1e-12) / 127.0
        x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
        return x_q, x_scale

    tap_operand = staticmethod(tap_operand)

    def int32_conv(self, x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
        """x_q (B, H, W, C) int8, w_q (9 * C, O) int8 -> (B, H, W, O) int32."""
        y = matmul_int8(self.tap_operand(x_q), w_q)
        return y.view(*x_q.shape[:3], -1)

    def dequantize(self, y: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """int32 sums (B, H, W, O) -> NCHW output in the working dtype and
        in the memory format of ``like``."""
        out = dequantize(y, x_scale * w_scale, self.bias.detach().float(),
                         _compute_dtype(like.device.type))
        return _in_format_of(out.permute(0, 3, 1, 2), like)

    def forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        """``dequantize(int32_conv(...))`` as one call of ``conv3x3_int8``,
        whose kernel writes neither the 9-tap operand nor the int32 sums."""
        w_q, w_scale = self.quantized_weight()
        x_q, x_scale = self.quantized_input(x)
        out = conv3x3_int8(x_q, w_q, x_scale * w_scale,
                           self.bias.detach().float(),
                           _compute_dtype(x.device.type))
        return _in_format_of(out.permute(0, 3, 1, 2), x)

    def commit_calibration(self) -> None:
        """Merge the maximum the last calibrating pass saw, if it reached
        this layer, into ``act_amax``."""
        if self._seen_amax is not None:
            self.act_amax = torch.maximum(self.act_amax,
                                          self._seen_amax.to(self.act_amax))
            self.calibrated = True
            self._seen_amax = None


# ConvBlock's rematerialisation policies: None keeps every activation;
# 'dots' keeps what the convolutions return and recomputes the activations
# and norms (jax.checkpoint_policies.dots_saveable, which keeps
# conv_general_dilated and dot_general); 'nothing' keeps only the block's
# input (nothing_saveable)
REMAT_POLICIES = (None, "dots", "nothing")


def _save_convolutions(ctx, op, *args, **kwargs):
    # aten.convolution is the operator a convolution reaches below
    # autograd, on the CPU and under CUDA autocast alike (nn.Conv2d ->
    # aten.conv2d -> aten.convolution)
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.convolution.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _running_stats_kept(buffers, inner):
    """Around a block's recomputation: its BatchNorm layers' running
    statistics as they were before it, put back after it (also when the
    recomputation stops early), so that a step updates them once, as flax's
    ``nn.remat`` does.  The recomputation itself normalises with the batch
    statistics, which are those of the first forward."""
    with torch.no_grad():
        kept = [b.clone() for b in buffers]
    try:
        with inner:
            yield
    finally:
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                b.copy_(k)


class ConvBlock(nn.Module):
    """[conv3x3 -> act -> norm] x 2.  With ``quantize``, in eval mode, each
    convolution that ``_quantize_this`` picks for the tensor it is given
    takes its int8 path; every other case is the plain ``nn.Conv2d``.

    ``remat_policy`` ('dots' | 'nothing', see ``REMAT_POLICIES``): in
    training mode with grad enabled, the block runs under
    ``torch.utils.checkpoint`` (non-reentrant, so autocast's state reaches
    the recomputation) and its activations are recomputed in the backward
    pass; the checkpointing lives in ``forward``, so the parameters keep
    their names."""

    def __init__(self, ch_in: int, ch_out: int, act_fun: str = "relu",
                 normalization: str = "bn", quantize: bool = False,
                 remat_policy=None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"Unsupported remat_policy: {remat_policy!r} "
                             f"(None, 'dots' or 'nothing')")
        self.quantize = quantize
        self.remat_policy = remat_policy
        self.conv = nn.Sequential(
            QuantConv(ch_in, ch_out),
            make_act(act_fun), make_norm(normalization, ch_out),
            QuantConv(ch_out, ch_out),
            make_act(act_fun), make_norm(normalization, ch_out))

    def _remat(self, x):
        stats = [b for m in self.conv
                 if isinstance(m, nn.BatchNorm2d) and m.track_running_stats
                 for b in (m.running_mean, m.running_var,
                           m.num_batches_tracked)]

        def contexts():
            if self.remat_policy == "dots":
                first, again = create_selective_checkpoint_contexts(
                    _save_convolutions)
            else:
                first = again = contextlib.nullcontext()
            return first, (_running_stats_kept(stats, again) if stats
                           else again)

        # the block draws no random numbers: no RNG state to keep
        return checkpoint(self.conv, x, use_reentrant=False,
                          context_fn=contexts, preserve_rng_state=False)

    def forward(self, x):
        if (self.remat_policy is not None and self.training
                and torch.is_grad_enabled()):
            return self._remat(x)
        conv0, act0, norm0, conv1, act1, norm1 = self.conv
        if _route(self, x, norm0, act0, conv0.out_channels, 2,
                  self.quantize) == "fused":
            x = _epilogue(conv0._conv_forward(x, conv0.weight, None),
                          conv0.bias, act0, norm0)
            return _epilogue(conv1._conv_forward(x, conv1.weight, None),
                             conv1.bias, act1, norm1)
        if not self.quantize or self.training:
            return self.conv(x)
        for layer in self.conv:
            if isinstance(layer, QuantConv) and _quantize_this(
                    x.shape[2], x.shape[3], layer.in_channels,
                    layer.out_channels):
                x = layer.forward_int8(x)
            else:
                x = layer(x)
        return x


class ConvPool(nn.Module):
    """Strided-conv downsample: conv3x3 stride 2 -> act -> norm."""

    def __init__(self, ch: int, act_fun: str = "relu",
                 normalization: str = "bn"):
        super().__init__()
        self.conv_pool = nn.Sequential(
            nn.Conv2d(ch, ch, 3, stride=2, padding=1),
            make_act(act_fun), make_norm(normalization, ch))

    def forward(self, x):
        conv, act, norm = self.conv_pool
        if _route(self, x, norm, act, conv.out_channels, 1) == "fused":
            return _epilogue(conv._conv_forward(x, conv.weight, None),
                             conv.bias, act, norm)
        return self.conv_pool(x)


class TranspConvBlock(nn.Module):
    """Upsample: transposed conv 2x2 stride 2 -> norm; on the fused eval
    route the transposed convolution runs without its bias."""

    def __init__(self, ch_in: int, ch_out: int, normalization: str = "bn"):
        super().__init__()
        self.up = nn.Sequential(nn.ConvTranspose2d(ch_in, ch_out, 2, stride=2))
        self.norm = make_norm(normalization, ch_out)

    def forward(self, x):
        up = self.up[0]
        if _route(self, x, self.norm, None, up.out_channels, 1) == "fused":
            z = F.conv_transpose2d(x, up.weight, None, up.stride, up.padding,
                                   up.output_padding, up.groups, up.dilation)
            return _epilogue(z, up.bias, None, self.norm)
        return self.norm(self.up(x))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)
