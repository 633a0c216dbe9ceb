"""The ViT denoiser, the alternate model family (``model.backbone=vit``).

Counterpart of ``itsd_tpu/models/vit.py``: patch embedding (a stride-p
conv) -> learnable position embedding -> ``depth`` pre-LN transformer
blocks (multi-head attention, then the time embedding added to every
token, then a swish MLP) -> final LayerNorm -> linear head -> un-patchify.
Module names follow the Flax parameter names (``patch_embed``,
``pos_embed``, ``time_embedding``, ``temb_proj``, ``block_{i}`` with
``norm1``, ``q``, ``k``, ``v``, ``out``, ``norm2``, ``mlp1``, ``mlp2``,
then ``norm`` and ``head``), so that weights convert by a change of layout
(``models/convert.py:vit_params_from_jax``).

Multi-head attention folds the heads into the batch
(``kernels.attention.mha_attention``): on the card the 12 heads of width 64
of ViT-B run the tensor-core attention kernels at ``[B*12, N, 64]``. The
LayerNorms (float32, epsilon 1e-6 as Flax's) and the Dense layers are plain
PyTorch, as XLA left them in JAX. Dtypes and dropout follow the UNet
(``models/unet.py``): float32 parameters, compute in ``cfg.dtype``,
dropout only with ``deterministic=False`` in training mode, its masks from
the ``generator`` passed to the forward. ``attention_impl="ring"`` splits
each attention call's tokens over the seq ranks (the global view of
``kernels.ring_attention``).

Spatial sharding (``train.spatial_shard``). Inside
``parallel.spatial.row_shards`` the input is this rank's block of image
rows, ``[B, H/K, W, C]``, as for the UNet. The patch embedding's windows
stay inside a rank's rows when the patch size divides them
(``ViT.check_rows``; JAX's GSPMD reshards where it does not, the port
raises), so its halo is empty. The tokens are H-major, so a rank's patch
rows are a contiguous share of them: it adds that share of the position
embedding (``rank_positions``), every attention call goes around the ring
(``kernels.attention.spatial_attention``), the LayerNorms, Dense layers and
the head are per token, and the dropout masks are cut along the token axis
from the global draw. The output is the rank's rows of eps. The train
step's all-reduce sums the ranks' gradients of the shared position
embedding (each reaches its own share) and of the time embedding (which
every seq rank computes for its batch rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import IMPLS, mha_attention
from ..parallel import SeqMesh
from ..parallel.spatial import row_shard_mesh
from .embeddings import Dense, FunctionalTimeEmbedding
from .unet import _DTYPES, Conv, dropout, rematerialized

LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 256
    patch_size: int = 16
    in_ch: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.1
    attention_impl: str = "auto"
    dtype: str = "float32"
    remat: bool = False           # recompute each block in the backward

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln`` computed in float32, cast back to ``x.dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN multi-head attention, the time embedding added to every
    token, then the swish MLP."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float,
                 dropout_rate: float, attention_impl: str = "auto"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.attention_impl = attention_impl
        hidden = int(embed_dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.q = Dense(embed_dim, embed_dim)
        self.k = Dense(embed_dim, embed_dim)
        self.v = Dense(embed_dim, embed_dim)
        self.out = Dense(embed_dim, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.mlp1 = Dense(embed_dim, hidden)
        self.mlp2 = Dense(hidden, embed_dim)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, E = x.shape
        H = self.num_heads
        rate = 0.0 if deterministic else self.dropout_rate
        h = layer_norm(self.norm1, x)
        q, k, v = (lin(h).reshape(B, N, H, E // H)
                   for lin in (self.q, self.k, self.v))
        o = mha_attention(q, k, v, impl=self.attention_impl).reshape(B, N, E)
        x = x + dropout(self.out(o), rate, generator, h_axis=1)
        if temb is not None:
            x = x + temb[:, None, :]
        h = F.silu(self.mlp1(layer_norm(self.norm2, x)))
        h = dropout(h, rate, generator, h_axis=1)
        h = dropout(self.mlp2(h), rate, generator, h_axis=1)
        return x + h


def rank_positions(pos_embed: torch.Tensor, n: int,
                   mesh: SeqMesh) -> torch.Tensor:
    """This seq rank's ``n`` tokens of the position embedding ``[1, N,
    E]``: its patch rows, which are contiguous in the H-major order."""
    return pos_embed.narrow(1, mesh.seq_rank * n, n)


class ViT(nn.Module):
    """``forward(x [B,H,W,C] f32, t [B])`` -> eps, float32 NHWC; the ViT
    is unconditional."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.attention_impl not in IMPLS:
            raise ValueError(
                f"unknown attention_impl {cfg.attention_impl!r}")
        if cfg.img_size % cfg.patch_size:
            raise ValueError(f"img_size {cfg.img_size} is not a multiple of "
                             f"patch_size {cfg.patch_size}")
        self.cfg = cfg
        E, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = Conv(cfg.in_ch, E, p, stride=p)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.n_patches, E))
        self.time_embedding = FunctionalTimeEmbedding(E, 4 * E)
        self.temb_proj = Dense(4 * E, E)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", TransformerBlock(
                E, cfg.num_heads, cfg.mlp_ratio, cfg.dropout,
                cfg.attention_impl))
        self.norm = nn.LayerNorm(E, eps=LN_EPS)
        self.head = Dense(E, p * p * cfg.in_ch)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights and zero biases, a normal(0, 0.02)
        position embedding and unit LayerNorm scales (as the Flax
        initializers), drawn from ``generator`` in module order."""
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                nn.init.xavier_uniform_(mod.weight, generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def check_rows(self, rows: int, seq: int) -> None:
        """Raise ValueError unless ``seq`` ranks split the ``rows`` global
        image rows into blocks of whole patch rows: the patch size must
        divide a rank's rows. (JAX's GSPMD reshards there; the port does
        not.)"""
        p = self.cfg.patch_size
        if rows % seq or (rows // seq) % p:
            raise ValueError(
                f"train.spatial_shard={seq} does not split the {rows} image "
                f"rows into whole patches of the ViT: patch_size {p} must "
                f"divide a rank's {rows / seq:g} rows")

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                labels: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """eps for ``x`` at ``t``. Dropout runs only with
        ``deterministic=False`` in training mode; ``generator`` draws its
        masks. With ``cfg.remat`` and a gradient wanted, each block is
        recomputed in the backward (``rematerialized``). Under
        ``parallel.spatial.row_shards`` ``x`` (and the output) is this
        rank's block of image rows (see the module docstring)."""
        if labels is not None:
            raise ValueError("the ViT is unconditional: it takes no labels")
        cfg = self.cfg
        deterministic = deterministic or not self.training
        dtype = cfg.torch_dtype
        B, H, W, C = x.shape
        p = cfg.patch_size
        mesh = row_shard_mesh()
        if mesh is not None:
            self.check_rows(H * mesh.seq, mesh.seq)
        h = self.patch_embed(x.to(dtype).permute(0, 3, 1, 2))
        hp, wp = h.shape[2], h.shape[3]
        pos = self.pos_embed
        if mesh is not None:
            pos = rank_positions(pos, hp * wp, mesh)
        h = h.flatten(2).transpose(1, 2) + pos.to(dtype)
        temb = self.temb_proj(self.time_embedding(t, dtype))
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.depth):
            block = getattr(self, f"block_{i}")
            if remat:
                h = rematerialized(block, generator, h, temb, deterministic)
            else:
                h = block(h, temb, deterministic, generator)
        h = self.head(layer_norm(self.norm, h))
        h = h.reshape(B, hp, wp, p, p, C).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(B, H, W, C).float()
