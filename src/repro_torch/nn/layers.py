"""Basic layers: RMS normalisation (the LM paths), LayerNorm and Embedding
(public layers that no model of either package uses), and the CNN zoo's
Dense, Conv2d (NCHW, weights OIHW, as in the JAX package), BatchNorm2d,
the pools, SqueezeExcite and the activations.

The CNN layers create their parameters on the ``meta`` device: a model of
any size is built without memory, and ``reset_parameters(generator)`` fills
them, after ``nn.Module.to_empty`` has given them storage, with the JAX
package's initialisation (He-normal weights, zero biases, BatchNorm scale
1, bias 0, running mean 0, running variance 1).  Parameter names follow the
reference's pytree keys (``w``, ``b``, ``scale``, ``bias``; running
statistics ``mean`` and ``var`` are buffers; LayerNorm's ``scale`` and
``bias``, Embedding's ``table``), so ``models.convert.load_reference_cnn``
carries the reference's parameters into any module built of these layers.
RMSNorm, LayerNorm and Embedding are built on the device given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.module import constant, frozen, kaiming, normal_init


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * scale, the variance taken in float32."""
    var = x.float().pow(2).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.d, self.eps = d, eps
        self.scale = constant((d,), 1.0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale (+ bias)`` over the last
    axis, with the biased variance, as the reference's; ``scale`` starts
    at 1, ``bias`` at 0."""

    def __init__(self, d: int, eps: float = 1e-5, bias: bool = True,
                 device=None):
        super().__init__()
        self.d, self.eps = d, eps
        self.scale = constant((d,), 1.0, device=device)
        self.bias = constant((d,), 0.0, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).pow(2).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps) * self.scale
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """A (vocab, d) ``table`` drawn N(0, std^2) from ``generator``; rows
    looked up by id."""

    def __init__(self, vocab: int, d: int, std: float = 0.02, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.vocab, self.d, self.std = vocab, d, std
        self.table = normal_init((vocab, d), std, generator=generator,
                                 device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.table)


def _meta(*shape: int) -> nn.Parameter:
    return frozen(torch.empty(shape, device="meta"))


class Dense(nn.Module):
    """``x @ w + b``, the weight kept as ``nn.Linear`` keeps it, (d_out,
    d_in) (the reference's is (d_in, d_out))."""

    # the reference quantizes per channel along its weight's last axis,
    # d_out: axis 0 here (core.quant.reference_channel_axis)
    REFERENCE_LAST_AXIS = 0

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.w = _meta(d_out, d_in)
        self.b = _meta(d_out) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.w.copy_(kaiming(self.w.shape, fan_in=self.d_in,
                             generator=generator, device=self.w.device))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w, self.b)


class Conv2d(nn.Module):
    """NCHW convolution; weight (cout, cin / groups, kh, kw)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.cin, self.cout, self.k = cin, cout, kernel
        self.stride, self.groups = stride, groups
        self.padding = kernel // 2 if padding is None else padding
        self.w = _meta(cout, cin // groups, kernel, kernel)
        self.b = _meta(cout) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        fan_in = (self.cin // self.groups) * self.k * self.k
        self.w.copy_(kaiming(self.w.shape, fan_in=fan_in,
                             generator=generator, device=self.w.device))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w, self.b, self.stride, self.padding, 1,
                        self.groups)


class BatchNorm2d(nn.Module):
    """NCHW batch norm: ``(x - mean) / sqrt(var + eps) * scale + bias``,
    with the running statistics in eval mode and with the batch's in
    training mode, where the running statistics move to ``MOMENTUM * old
    + (1 - MOMENTUM) * batch`` (biased variance; ``F.batch_norm`` folds
    the unbiased one in and weighs the new value by its ``momentum``)."""

    MOMENTUM = 0.9      # the reference's default, the only value it uses

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.c, self.eps = c, eps
        self.scale = _meta(c)
        self.bias = _meta(c)
        self.register_buffer("mean", torch.empty(c, device="meta"))
        self.register_buffer("var", torch.empty(c, device="meta"))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def inference(self) -> tuple:
        """(running mean, running variance, scale, bias, eps): what the
        eval-mode forward normalises with."""
        return self.mean, self.var, self.scale, self.bias, self.eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps)
        m = self.MOMENTUM
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        # without running statistics, F.batch_norm normalises with the
        # batch's biased variance, forward and backward in one kernel each
        return F.batch_norm(x, None, None, self.scale, self.bias, True, 0.0,
                            self.eps)


def max_pool(x: torch.Tensor, kernel: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """Max over k x k windows, padded with -inf, output size floored."""
    return F.max_pool2d(x, kernel, stride or kernel, padding)


def avg_pool(x: torch.Tensor, kernel: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """Window sum over k x k divided by k*k, zero padding included."""
    return F.avg_pool2d(x, kernel, stride or kernel, padding,
                        count_include_pad=True)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.c, self.reduced = c, reduced
        self.fc1 = Dense(c, reduced)
        self.fc2 = Dense(reduced, c)

    def excite(self, x: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        """``x`` scaled by its channels' gates, from ``pooled``, x's mean
        over each plane (N, C)."""
        s = torch.sigmoid(self.fc2(F.silu(self.fc1(pooled))))
        return x * s[:, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.excite(x, global_avg_pool(x))


# activation modules ---------------------------------------------------------

_ACTS = {"relu": F.relu, "silu": F.silu,
         # jax.nn.gelu's default is the tanh approximation
         "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "sigmoid": torch.sigmoid, "swish": F.silu,
         "identity": lambda x: x}


class Act(nn.Module):
    """A parameterless activation, by name."""

    def __init__(self, name: str):
        super().__init__()
        self.name, self.fn = name, _ACTS[name]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def act_module(name: str) -> Act:
    return Act(name)
