"""The DDPM UNet, unconditional path.

Counterpart of ``itsd_tpu/models/unet.py:40-333``. The public layout is
NHWC, as in JAX; inside, activations are NCHW, so that a GroupNorm group is
one contiguous span for the kernel. Module names follow the Flax parameter
names (``head``, ``down_{i}_{j}``, ``down_{i}_ds``, ``mid_{0,1}``,
``up_{i}_{j}``, ``up_{i}_us``, ``tail_norm``, ``tail_conv``), so that weights
convert by a change of layout alone (``models/convert.py``).

Dtype handling follows JAX: parameters are float32, compute runs in
``cfg.dtype`` (bfloat16 on the card), GroupNorm statistics are float32 and
the output is cast to float32. Dropout is not applied: the port runs
inference only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import spatial_attention
from ..kernels.groupnorm import groupnorm_swish
from .embeddings import TINY_GAIN, Dense, FunctionalTimeEmbedding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    attn: Tuple[int, ...] = (1,)          # stage indices with attention
    num_res_blocks: int = 2
    in_ch: int = 3
    num_labels: Optional[int] = None      # None => unconditional
    time_embed: str = "functional"
    down_attn_all: bool = False
    up_attn: bool = True
    down_type: str = "conv"
    up_type: str = "nearest_conv"
    attention_impl: str = "auto"
    dtype: str = "float32"                # compute dtype

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
    raise NotImplementedError("cond_unet_config: the conditional UNet is not "
                              "yet ported")


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
    """Single-head spatial self-attention with residual, scale C**-0.5."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GNAct(ch, act=False)
        self.q = Dense(ch, ch)
        self.k = Dense(ch, ch)
        self.v = Dense(ch, ch)
        self.proj = Dense(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)       # [B, N, C] view
        o = spatial_attention(self.q(h).contiguous(), self.k(h).contiguous(),
                              self.v(h).contiguous())
        o = self.proj(o)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


class ResBlock(nn.Module):
    """GN -> swish -> conv3 -> +temb -> GN -> swish -> conv3 -> +shortcut
    -> [attn]."""

    def __init__(self, in_ch: int, out_ch: int, tdim: int, attn: bool):
        super().__init__()
        self.norm1 = GNAct(in_ch, act=True)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.temb_proj = Dense(tdim, out_ch)
        self.norm2 = GNAct(out_ch, act=True)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        self.shortcut = Dense1x1(in_ch, out_ch) if in_ch != out_ch else None
        self.attn = AttnBlock(out_ch) if attn else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.shortcut is not None:
            x = self.shortcut(x)
        h = h + x
        if self.attn is not None:
            h = self.attn(h)
        return h


class DownSample(nn.Module):
    """conv3x3 stride 2 with symmetric (1, 1) padding."""

    def __init__(self, ch: int, kind: str):
        super().__init__()
        if kind != "conv":
            raise NotImplementedError(f"DownSample kind {kind!r} is not yet "
                                      "ported")
        self.c1 = Conv(ch, ch, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c1(x)


class UpSample(nn.Module):
    """Nearest-neighbour 2x then conv3x3."""

    def __init__(self, ch: int, kind: str):
        super().__init__()
        if kind != "nearest_conv":
            raise NotImplementedError(f"UpSample kind {kind!r} is not yet "
                                      "ported")
        self.c = Conv(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c(F.interpolate(x, scale_factor=2, mode="nearest"))


# Layers whose init is Xavier with gain TINY_GAIN (the net starts near the
# identity): named by their last component.
_TINY_INIT = ("conv2", "proj", "tail_conv")


class UNet(nn.Module):
    """The denoiser: ``forward(x [B,H,W,C] f32, t [B])`` -> eps, float32
    NHWC."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if cfg.conditional or cfg.time_embed != "functional":
            raise NotImplementedError("the conditional UNet and the table "
                                      "time embedding are not yet ported")
        if cfg.attention_impl != "auto":
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r} is not yet ported "
                "(the port picks the kernel from the tensors' device)")
        self.cfg = cfg
        ch = cfg.ch
        self.time_embedding = FunctionalTimeEmbedding(ch, cfg.tdim)
        self.head = Conv(cfg.in_ch, ch, 3, padding=1)

        # The same walk as the JAX UNet: ``plan`` lists the forward's steps.
        self.plan = []
        skips, now = [ch], ch
        for i, mult in enumerate(cfg.ch_mult):
            out = ch * mult
            for j in range(cfg.num_res_blocks):
                attn = cfg.down_attn_all or i in cfg.attn
                self._add(f"down_{i}_{j}", ResBlock(now, out, cfg.tdim, attn),
                          "down")
                now = out
                skips.append(now)
            if i != len(cfg.ch_mult) - 1:
                self._add(f"down_{i}_ds", DownSample(now, cfg.down_type),
                          "ds")
                skips.append(now)
        self._add("mid_0", ResBlock(now, now, cfg.tdim, True), "mid")
        self._add("mid_1", ResBlock(now, now, cfg.tdim, False), "mid")
        for i, mult in reversed(list(enumerate(cfg.ch_mult))):
            out = ch * mult
            for j in range(cfg.num_res_blocks + 1):
                attn = cfg.up_attn and i in cfg.attn
                self._add(f"up_{i}_{j}",
                          ResBlock(now + skips.pop(), out, cfg.tdim, attn),
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
        GroupNorm scales, drawn from ``generator`` in module order."""
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                tiny = name.rsplit(".", 1)[-1] in _TINY_INIT
                nn.init.xavier_uniform_(mod.weight,
                                        gain=TINY_GAIN if tiny else 1.0,
                                        generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, GNAct):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                return_representation: bool = False):
        dtype = self.cfg.torch_dtype
        h = x.to(dtype).permute(0, 3, 1, 2).contiguous()
        temb = self.time_embedding(t, dtype)
        h = self.head(h)
        hs = [h]
        for name, kind in self.plan:
            block = getattr(self, name)
            if kind == "up":
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
            elif kind in ("down", "mid"):
                h = block(h, temb)
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
