"""The DDPM UNet: the unconditional model and the classifier-free-guidance
conditional one (label embedding, table time embedding, attention in every
down block, dual-conv downsampling, transpose-conv upsampling).

Counterpart of ``itsd_tpu/models/unet.py:40-333``. The public layout is
NHWC, as in JAX; inside, activations are NCHW, so that a GroupNorm group is
one contiguous span for the kernel. Module names follow the Flax parameter
names (``head``, ``down_{i}_{j}``, ``down_{i}_ds``, ``mid_{0,1}``,
``up_{i}_{j}``, ``up_{i}_us``, ``tail_norm``, ``tail_conv``), so that weights
convert by a change of layout alone (``models/convert.py``).

Dtype handling follows JAX: parameters are float32, compute runs in
``cfg.dtype`` (bfloat16 on the card), GroupNorm statistics are float32 and
the output is cast to float32. Dropout (after norm2 of every ResBlock, as
in JAX) is off by default, as Flax's ``deterministic=True``: it runs when
the forward is called with ``deterministic=False`` on a module in training
mode (``model.train()``), never under ``model.eval()``. Its masks come from
the ``generator`` passed to the forward, as the Flax module takes its
dropout key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import spatial_attention
from ..kernels.groupnorm import groupnorm_swish
from ..parallel import draw
from .embeddings import (TINY_GAIN, ConditionalEmbedding, Dense,
                         FunctionalTimeEmbedding, TableTimeEmbedding)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    attn: Tuple[int, ...] = (1,)          # stage indices with attention
    num_res_blocks: int = 2
    dropout: float = 0.1
    in_ch: int = 3
    num_labels: Optional[int] = None      # None => unconditional
    time_embed: str = "functional"        # "functional" | "table"
    T: int = 1000                          # rows of the table embedding
    down_attn_all: bool = False           # attention in every down block
    up_attn: bool = True
    down_type: str = "conv"               # "conv" | "dual_conv"
    up_type: str = "nearest_conv"         # "nearest_conv" | "transpose_conv"
    attention_impl: str = "auto"          # "auto" | "flash" | "xla"
    dtype: str = "float32"                # compute dtype
    remat: bool = False                   # recompute each ResBlock

    @property
    def tdim(self) -> int:
        return self.ch * 4

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def conditional(self) -> bool:
        return self.num_labels is not None


def uncond_unet_config(**kw) -> UNetConfig:
    return UNetConfig(**kw)


def cond_unet_config(num_labels: int = 10, **kw) -> UNetConfig:
    """The conditional UNet's defaults: table time embedding, attention in
    every down block and the middle, none on the way up, dual-conv
    downsampling and transpose-conv upsampling."""
    kw.setdefault("time_embed", "table")
    kw.setdefault("down_attn_all", True)
    kw.setdefault("up_attn", False)
    kw.setdefault("down_type", "dual_conv")
    kw.setdefault("up_type", "transpose_conv")
    kw.setdefault("attn", ())
    return UNetConfig(num_labels=num_labels, **kw)


def _groups(ch: int) -> int:
    """GroupNorm(32) where 32 divides C, else the largest divisor <= 32."""
    g = min(32, ch)
    while ch % g:
        g -= 1
    return g


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class ConvT(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
            self.padding, self.output_padding)


class Dense1x1(Dense):
    """A Dense layer over the channels of NCHW activations (a 1x1 conv with
    a Linear-shaped ``[out, in]`` weight)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)[:, :, None, None]
        return F.conv2d(x, w, self.bias.to(x.dtype))


class GNAct(nn.Module):
    """GroupNorm with optional fused swish, through
    ``kernels.groupnorm.groupnorm_swish``."""

    def __init__(self, ch: int, act: bool):
        super().__init__()
        self.act = act
        self.groups = _groups(ch)
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return groupnorm_swish(x.contiguous(), self.weight, self.bias,
                               self.groups, eps=1e-5, act=self.act)


class AttnBlock(nn.Module):
    """Single-head spatial self-attention with residual, scale C**-0.5,
    on the path ``impl`` names (``kernels.attention.resolve_impl``)."""

    def __init__(self, ch: int, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        self.norm = GNAct(ch, act=False)
        self.q = Dense(ch, ch)
        self.k = Dense(ch, ch)
        self.v = Dense(ch, ch)
        self.proj = Dense(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)       # [B, N, C] view
        o = spatial_attention(self.q(h).contiguous(), self.k(h).contiguous(),
                              self.v(h).contiguous(), impl=self.impl)
        o = self.proj(o)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as Flax's ``nn.Dropout``: keep each element with
    probability 1 - rate and divide the kept ones by it. A ``RowDraws``
    generator draws the mask for the global batch and keeps this rank's
    rows (``parallel.draw``)."""
    if rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = draw(torch.rand, h.shape, generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


def rematerialized(fn, generator: Optional[torch.Generator], *args):
    """``fn(*args, generator)`` under ``torch.utils.checkpoint``: its
    activations are not kept but recomputed in the backward, as Flax's
    ``nn.remat``. The recompute draws the same dropout masks: it sets
    ``generator`` back to its state at this call for the recompute, and
    then forward again to where the backward found it."""
    if generator is None:
        return checkpoint(fn, *args, None, use_reentrant=False)
    start = generator.get_state()
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class ResBlock(nn.Module):
    """GN -> swish -> conv3 -> +temb (+cemb) -> GN -> swish -> dropout ->
    conv3 -> +shortcut -> [attn]."""

    def __init__(self, in_ch: int, out_ch: int, tdim: int, attn: bool,
                 dropout: float = 0.0, conditional: bool = False,
                 attention_impl: str = "auto"):
        super().__init__()
        self.dropout_rate = dropout
        self.norm1 = GNAct(in_ch, act=True)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.temb_proj = Dense(tdim, out_ch)
        self.cond_proj = Dense(tdim, out_ch) if conditional else None
        self.norm2 = GNAct(out_ch, act=True)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        self.shortcut = Dense1x1(in_ch, out_ch) if in_ch != out_ch else None
        self.attn = AttnBlock(out_ch, attention_impl) if attn else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                cemb: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        if self.cond_proj is not None:
            h = h + self.cond_proj(F.silu(cemb))[:, :, None, None]
        h = self.norm2(h)
        if not deterministic:
            h = dropout(h, self.dropout_rate, generator)
        h = self.conv2(h)
        if self.shortcut is not None:
            x = self.shortcut(x)
        h = h + x
        if self.attn is not None:
            h = self.attn(h)
        return h


class DownSample(nn.Module):
    """Stride-2 downsampling with symmetric padding. "conv": conv3x3;
    "dual_conv": conv3x3 plus conv5x5, summed."""

    def __init__(self, ch: int, kind: str):
        super().__init__()
        if kind not in ("conv", "dual_conv"):
            raise ValueError(f"unknown DownSample kind {kind!r}")
        self.c1 = Conv(ch, ch, 3, stride=2, padding=1)
        self.c2 = (Conv(ch, ch, 5, stride=2, padding=2)
                   if kind == "dual_conv" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c1(x)
        return y if self.c2 is None else y + self.c2(x)


class UpSample(nn.Module):
    """2x upsampling then conv3x3. "nearest_conv": nearest neighbour;
    "transpose_conv": ``ConvTranspose2d(C, C, 5, 2, 2, output_padding=1)``
    (the Flax module ``t`` flips its kernel to compute the same)."""

    def __init__(self, ch: int, kind: str):
        super().__init__()
        if kind not in ("nearest_conv", "transpose_conv"):
            raise ValueError(f"unknown UpSample kind {kind!r}")
        self.t = (ConvT(ch, ch, 5, stride=2, padding=2, output_padding=1)
                  if kind == "transpose_conv" else None)
        self.c = Conv(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.t is None:
            return self.c(F.interpolate(x, scale_factor=2, mode="nearest"))
        return self.c(self.t(x))


# Layers whose init is Xavier with gain TINY_GAIN (the net starts near the
# identity): named by their last component.
_TINY_INIT = ("conv2", "proj", "tail_conv")


class UNet(nn.Module):
    """The denoiser: ``forward(x [B,H,W,C] f32, t [B], labels [B])`` ->
    eps, float32 NHWC; ``labels`` only for the conditional model (0 is the
    null class)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if cfg.time_embed not in ("functional", "table"):
            raise ValueError(f"unknown time_embed {cfg.time_embed!r}")
        if cfg.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' (sequence-sharded attention) is not "
                "yet ported")
        if cfg.attention_impl not in ("auto", "flash", "xla"):
            raise ValueError(
                f"unknown attention_impl {cfg.attention_impl!r}")
        self.cfg = cfg
        ch = cfg.ch
        self.time_embedding = (
            FunctionalTimeEmbedding(ch, cfg.tdim)
            if cfg.time_embed == "functional"
            else TableTimeEmbedding(cfg.T, ch, cfg.tdim))
        self.cond_embedding = (
            ConditionalEmbedding(cfg.num_labels, ch, cfg.tdim)
            if cfg.conditional else None)
        self.head = Conv(cfg.in_ch, ch, 3, padding=1)
        res = lambda cin, cout, attn: ResBlock(  # noqa: E731
            cin, cout, cfg.tdim, attn, cfg.dropout, cfg.conditional,
            cfg.attention_impl)

        # The same walk as the JAX UNet: ``plan`` lists the forward's steps.
        self.plan = []
        skips, now = [ch], ch
        for i, mult in enumerate(cfg.ch_mult):
            out = ch * mult
            for j in range(cfg.num_res_blocks):
                attn = cfg.down_attn_all or i in cfg.attn
                self._add(f"down_{i}_{j}", res(now, out, attn), "down")
                now = out
                skips.append(now)
            if i != len(cfg.ch_mult) - 1:
                self._add(f"down_{i}_ds", DownSample(now, cfg.down_type),
                          "ds")
                skips.append(now)
        self._add("mid_0", res(now, now, True), "mid")
        self._add("mid_1", res(now, now, False), "mid")
        for i, mult in reversed(list(enumerate(cfg.ch_mult))):
            out = ch * mult
            for j in range(cfg.num_res_blocks + 1):
                attn = cfg.up_attn and i in cfg.attn
                self._add(f"up_{i}_{j}", res(now + skips.pop(), out, attn),
                          "up")
                now = out
            if i != 0:
                self._add(f"up_{i}_us", UpSample(now, cfg.up_type), "us")
        assert not skips
        self.tail_norm = GNAct(now, act=True)
        self.tail_conv = Conv(now, cfg.in_ch, 3, padding=1)

    def _add(self, name: str, module: nn.Module, kind: str) -> None:
        self.add_module(name, module)
        self.plan.append((name, kind))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights (gain TINY_GAIN on the output layers of
        the residual, attention and tail branches), zero biases, unit
        GroupNorm scales, the time table's sinusoid features and a
        normal(0, 1) label table, drawn from ``generator`` in module
        order."""
        for name, mod in self.named_modules():
            if isinstance(mod, TableTimeEmbedding):
                mod.reset_table()
            elif isinstance(mod, ConditionalEmbedding):
                nn.init.normal_(mod.table, generator=generator)
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                tiny = name.rsplit(".", 1)[-1] in _TINY_INIT
                nn.init.xavier_uniform_(mod.weight,
                                        gain=TINY_GAIN if tiny else 1.0,
                                        generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, GNAct):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                labels: Optional[torch.Tensor] = None, *,
                return_representation: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """eps for ``x`` at ``t`` (and ``labels``, for the conditional
        model). Dropout runs only with ``deterministic=False`` in training
        mode; ``generator`` draws its masks. With ``cfg.remat`` and a
        gradient wanted, each ResBlock is recomputed in the backward
        (``rematerialized``). ``return_representation`` also returns the
        activation before ``tail_norm`` ([B, H, W, C], compute dtype), the
        hook of representation analysis."""
        deterministic = deterministic or not self.training
        dtype = self.cfg.torch_dtype
        h = x.to(dtype).permute(0, 3, 1, 2).contiguous()
        temb = self.time_embedding(t, dtype)
        cemb = None
        if self.cond_embedding is not None:
            if labels is None:
                raise ValueError("the conditional UNet needs labels")
            cemb = self.cond_embedding(labels, dtype)
        h = self.head(h)
        hs = [h]
        remat = self.cfg.remat and torch.is_grad_enabled()
        for name, kind in self.plan:
            block = getattr(self, name)
            if kind in ("down", "mid", "up"):
                if kind == "up":
                    h = torch.cat([h, hs.pop()], dim=1)
                if remat:
                    h = rematerialized(block, generator, h, temb, cemb,
                                       deterministic)
                else:
                    h = block(h, temb, cemb, deterministic, generator)
            else:
                h = block(h)
            if kind in ("down", "ds"):
                hs.append(h)
        assert not hs
        representation = h
        h = self.tail_conv(self.tail_norm(h))
        h = h.float().permute(0, 2, 3, 1).contiguous()
        if return_representation:
            return h, representation.permute(0, 2, 3, 1)
        return h
