"""CLIP: the ViT image tower and the text tower.

Counterpart of ``itsd_tpu/metrics/clip.py``. The modules carry the names
of a HuggingFace ``CLIPModel`` state dict (``vision_model.*``,
``text_model.*``, ``visual_projection``, ``text_projection``,
``logit_scale``), so that such a file loads with ``load_state_dict`` and no
``transformers``. Quick-GELU, LayerNorm eps 1e-5, multi-head attention in
float32 as plain products and a softmax (JAX computes it so, at
``Precision.HIGHEST``), a class token and position embeddings, pre- and
post-LayerNorm in the vision tower; the text tower's causal mask and its
pooling at the argmax token (EOT).

``load_clip`` takes the head counts as arguments. When none are given it
uses width / 64, the head width of every released OpenAI CLIP (ViT-B/32:
768 / 12 vision, 512 / 8 text). The JAX package's loader asserts instead
when it is given a state dict (``clip.py:173``), so that every
``$ITSD_CLIP_WEIGHTS`` run fails there; the port does not copy that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..utils.resize import host_constant, resize

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
HEAD_WIDTH = 64


@dataclass(frozen=True)
class CLIPConfig:
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    patch_size: int = 32
    image_size: int = 224
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp: int = 2048
    vocab_size: int = 49408
    context_length: int = 77
    projection_dim: Optional[int] = 512     # None: no projections


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of {heads} "
                             "heads")
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, N, D = x.shape
        H = self.heads
        hd = D // H
        q, k, v = (p(x).reshape(B, N, H, hd).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        scores = (q @ k.transpose(-1, -2)) * hd ** -0.5
        if mask is not None:
            scores = scores + mask
        o = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, N, D))


class _MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_quick_gelu(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, width: int, heads: int, hidden: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.self_attn = _Attention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width, hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(width, heads, hidden)
                                    for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        D, P = cfg.vision_width, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, D, P, stride=P, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(D))
        n = (cfg.image_size // P) ** 2 + 1
        self.position_embedding = nn.Embedding(n, D)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(images.permute(0, 3, 1, 2))
        B, D = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(B, 1, D)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[None, :x.shape[1]]


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        D = cfg.vision_width
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(D, eps=1e-5)
        self.encoder = _Encoder(D, cfg.vision_layers, cfg.vision_heads,
                                cfg.vision_mlp)
        self.post_layernorm = nn.LayerNorm(D, eps=1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Preprocessed NHWC images -> the pooled class token [B, D]."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(images)))
        return self.post_layernorm(x[:, 0])


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.position_embedding = nn.Embedding(cfg.context_length,
                                               cfg.text_width)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg.text_width, cfg.text_layers,
                                cfg.text_heads, cfg.text_mlp)
        self.final_layer_norm = nn.LayerNorm(cfg.text_width, eps=1e-5)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids [B, L] (padded) -> the state at the argmax (EOT) token
        [B, D]."""
        B, L = token_ids.shape
        e = self.embeddings
        x = (e.token_embedding(token_ids)
             + e.position_embedding.weight[None, :L])
        mask = torch.full((L, L), float("-inf"), device=x.device,
                          dtype=x.dtype).triu(1)
        x = self.final_layer_norm(self.encoder(x, mask))
        eot = token_ids.argmax(dim=-1)
        return x[torch.arange(B, device=x.device), eot]


class CLIPModel(nn.Module):
    """Both towers and their projections (no bias), HuggingFace's names."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTower(cfg)
        self.text_model = CLIPTextTower(cfg)
        P = cfg.projection_dim
        self.visual_projection = (nn.Linear(cfg.vision_width, P, bias=False)
                                  if P else None)
        self.text_projection = (nn.Linear(cfg.text_width, P, bias=False)
                                if P else None)
        self.logit_scale = nn.Parameter(torch.tensor(np.log(1 / 0.07),
                                                     dtype=torch.float32))
        self.eval()

    def image_features(self, images: torch.Tensor, projected: bool = True
                       ) -> torch.Tensor:
        """Preprocessed NHWC images [B, S, S, 3] -> [B, projection_dim]."""
        pooled = self.vision_model(images)
        if projected and self.visual_projection is not None:
            pooled = self.visual_projection(pooled)
        return pooled

    def text_features(self, token_ids: torch.Tensor, projected: bool = True
                      ) -> torch.Tensor:
        pooled = self.text_model(token_ids)
        if projected and self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return pooled


def model_image_size(model: CLIPModel) -> int:
    """The vision tower's native input size, from its weights."""
    e = model.vision_model.embeddings
    patch = e.patch_embedding.weight.shape[-1]
    side = int(round(float(e.position_embedding.weight.shape[0] - 1) ** 0.5))
    return side * patch


def preprocess(images: torch.Tensor, image_size: int = 224,
               normalize: bool = True) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> bicubic to ``image_size`` (as
    ``jax.image.resize`` computes it: Keys a = -0.5, antialiased when
    shrinking), clipped to [0, 1], then CLIP-normalised unless
    ``normalize`` is false (the reference verifier's quirk)."""
    B, H, W, C = images.shape
    if (H, W) != (image_size, image_size):
        images = resize(images, image_size, image_size, "cubic")
        images = images.clamp(0.0, 1.0)
    if normalize:
        images = ((images - host_constant(CLIP_MEAN, images))
                  / host_constant(CLIP_STD, images))
    return images


def clip_similarity(model: CLIPModel, images: torch.Tensor,
                    token_ids: torch.Tensor,
                    normalize_images: bool = True) -> torch.Tensor:
    """Per-pair cosine of image [B] and text [B] features (the diagonal)."""
    img = model.image_features(preprocess(
        images, model_image_size(model), normalize=normalize_images))
    txt = model.text_features(token_ids)
    img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-8)
    txt = txt / (torch.linalg.vector_norm(txt, dim=-1, keepdim=True) + 1e-8)
    return (img * txt).sum(dim=-1)


def _count_layers(sd: dict, prefix: str) -> int:
    i = 0
    while f"{prefix}.encoder.layers.{i}.layer_norm1.weight" in sd:
        i += 1
    return i


def config_from_state_dict(sd: dict, vision_heads: Optional[int] = None,
                           text_heads: Optional[int] = None) -> CLIPConfig:
    """The ``CLIPConfig`` of a HuggingFace-layout state dict; each head
    count not given is the tower's width / 64."""
    patch = sd["vision_model.embeddings.patch_embedding.weight"]
    vpos = sd["vision_model.embeddings.position_embedding.weight"]
    tok = sd["text_model.embeddings.token_embedding.weight"]
    tpos = sd["text_model.embeddings.position_embedding.weight"]
    vw, tw = patch.shape[0], tok.shape[1]
    side = int(round(float(vpos.shape[0] - 1) ** 0.5))
    proj = sd.get("visual_projection.weight")
    return CLIPConfig(
        vision_width=vw,
        vision_layers=_count_layers(sd, "vision_model"),
        vision_heads=vision_heads or vw // HEAD_WIDTH,
        vision_mlp=sd["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        patch_size=patch.shape[-1], image_size=side * patch.shape[-1],
        text_width=tw, text_layers=_count_layers(sd, "text_model"),
        text_heads=text_heads or tw // HEAD_WIDTH,
        text_mlp=sd["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        vocab_size=tok.shape[0], context_length=tpos.shape[0],
        projection_dim=None if proj is None else proj.shape[0])


def clip_from_state_dict(sd: dict, vision_heads: Optional[int] = None,
                         text_heads: Optional[int] = None) -> CLIPModel:
    """A ``CLIPModel`` holding a HuggingFace ``CLIPModel`` state dict
    (its ``position_ids`` buffers are dropped), frozen."""
    sd = {k: v for k, v in sd.items() if not k.endswith("position_ids")}
    cfg = config_from_state_dict(sd, vision_heads, text_heads)
    model = CLIPModel(cfg)
    if "logit_scale" not in sd:
        sd["logit_scale"] = model.logit_scale.detach()
    model.load_state_dict(sd)
    return model.requires_grad_(False)


def load_clip(path: str, vision_heads: Optional[int] = None,
              text_heads: Optional[int] = None) -> CLIPModel:
    """A ``CLIPModel`` from a ``.pt``/``.pth`` file holding a HuggingFace
    ``CLIPModel`` state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return clip_from_state_dict(sd, vision_heads, text_heads)
