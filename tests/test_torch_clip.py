"""The port's CLIP (``itsd_tpu_torch/metrics/clip.py``) against the JAX
package's (``itsd_tpu/metrics/clip.py``) on the CPU.

A tiny HuggingFace-layout ``CLIPModel`` state dict made with numpy (2
layers, width 128, 2 heads, patch 8, image 32, vocab 100, context 16,
projection 64) goes into both: the JAX package's
``convert_transformers_clip(sd, 2, 2)`` and the port's
``clip_from_state_dict``, and, through ``clip_params_from_jax``, JAX's
converted pytree into the port. Image features, text features and
``clip_similarity`` agree to 1e-5 (absolute, on features of order 1); the
bicubic preprocess (``jax.image.resize`` with Keys a = -0.5, then the clip
to [0, 1] and CLIP's normalisation) to 1e-5 growing 32 -> 224 and
shrinking 256 -> 224.

The loader fault of the reference: JAX's ``make_clip_feature_fn`` asserts
on every state-dict file (it gives no head counts); the port loads the same
file with width / 64 heads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.metrics import clip as J
from itsd_tpu.metrics import features as JF
from itsd_tpu_torch.metrics import clip as P
from itsd_tpu_torch.metrics import features as PF
from itsd_tpu_torch.models import clip_params_from_jax

from _torch_port import one_torch_thread  # noqa: F401

TOL = 1e-5
WIDTH, LAYERS, HEADS, MLP, PATCH, IMAGE = 128, 2, 2, 256, 8, 32
VOCAB, CONTEXT, PROJ = 100, 16, 64


def hf_state_dict(seed: int = 0) -> dict:
    """A HuggingFace CLIPModel state dict of the tiny shape, numpy-seeded:
    weights O(1/sqrt(fan_in)), LayerNorm scales near 1, biases and
    embeddings O(0.1); with the position_ids buffers HF files carry."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(*shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    def ln(prefix, d):
        sd[f"{prefix}.weight"] = 1 + t(d, scale=0.1)
        sd[f"{prefix}.bias"] = t(d, scale=0.1)

    def dense(prefix, d_in, d_out, bias=True):
        sd[f"{prefix}.weight"] = t(d_out, d_in, scale=d_in ** -0.5)
        if bias:
            sd[f"{prefix}.bias"] = t(d_out, scale=0.1)

    def encoder(prefix):
        for i in range(LAYERS):
            lp = f"{prefix}.encoder.layers.{i}"
            ln(f"{lp}.layer_norm1", WIDTH)
            ln(f"{lp}.layer_norm2", WIDTH)
            for p in ("q", "k", "v", "out"):
                dense(f"{lp}.self_attn.{p}_proj", WIDTH, WIDTH)
            dense(f"{lp}.mlp.fc1", WIDTH, MLP)
            dense(f"{lp}.mlp.fc2", MLP, WIDTH)

    n_pos = (IMAGE // PATCH) ** 2 + 1
    sd["vision_model.embeddings.patch_embedding.weight"] = t(
        WIDTH, 3, PATCH, PATCH, scale=(3 * PATCH * PATCH) ** -0.5)
    sd["vision_model.embeddings.class_embedding"] = t(WIDTH, scale=0.1)
    sd["vision_model.embeddings.position_embedding.weight"] = t(
        n_pos, WIDTH, scale=0.1)
    sd["vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    ln("vision_model.pre_layrnorm", WIDTH)
    encoder("vision_model")
    ln("vision_model.post_layernorm", WIDTH)
    sd["text_model.embeddings.token_embedding.weight"] = t(
        VOCAB, WIDTH, scale=0.1)
    sd["text_model.embeddings.position_embedding.weight"] = t(
        CONTEXT, WIDTH, scale=0.1)
    sd["text_model.embeddings.position_ids"] = torch.arange(CONTEXT)[None]
    encoder("text_model")
    ln("text_model.final_layer_norm", WIDTH)
    dense("visual_projection", WIDTH, PROJ, bias=False)
    dense("text_projection", WIDTH, PROJ, bias=False)
    sd["logit_scale"] = torch.tensor(2.6592)
    return sd


@pytest.fixture(scope="module")
def both():
    sd = hf_state_dict()
    jparams = J.convert_transformers_clip(sd, HEADS, HEADS)
    return sd, jparams, P.clip_from_state_dict(sd, HEADS, HEADS)


def _unit(n, size, seed):
    return np.random.default_rng(seed).random(
        (n, size, size, 3)).astype(np.float32)


def _tokens():
    # padded rows, each ending at its largest id (the EOT token)
    return np.array([[1, 5, 9, 99, 0, 0, 0, 0], [1, 7, 99, 0, 0, 0, 0, 0],
                     [3, 4, 5, 6, 7, 8, 9, 98]], np.int64)


def test_config_from_the_state_dict(both):
    _, _, model = both
    cfg = model.cfg
    assert (cfg.vision_width, cfg.vision_layers, cfg.vision_heads,
            cfg.patch_size, cfg.image_size) == (WIDTH, LAYERS, HEADS, PATCH,
                                                IMAGE)
    assert (cfg.text_width, cfg.text_layers, cfg.vocab_size,
            cfg.context_length, cfg.projection_dim) == (WIDTH, LAYERS, VOCAB,
                                                        CONTEXT, PROJ)
    assert P.model_image_size(model) == J.model_image_size(both[1]) == IMAGE


@pytest.mark.parametrize("size", [32, 48])
def test_image_features_match_jax(both, size):
    _, jparams, model = both
    x = _unit(3, size, 1)
    want = np.asarray(J.clip_image_features(
        jparams, J.preprocess(jnp.asarray(x), IMAGE)))
    with torch.inference_mode():
        got = model.image_features(P.preprocess(torch.from_numpy(x), IMAGE))
    assert got.shape == (3, PROJ)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    unprojected = np.asarray(J.clip_image_features(
        jparams, J.preprocess(jnp.asarray(x), IMAGE), projected=False))
    with torch.inference_mode():
        got = model.image_features(P.preprocess(torch.from_numpy(x), IMAGE),
                                   projected=False)
    np.testing.assert_allclose(got.numpy(), unprojected, atol=TOL, rtol=0)


def test_text_features_and_similarity_match_jax(both):
    _, jparams, model = both
    ids = _tokens()
    want = np.asarray(J.clip_text_features(jparams, jnp.asarray(ids)))
    with torch.inference_mode():
        got = model.text_features(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    x = _unit(3, 32, 2)
    for norm in (True, False):
        want = np.asarray(J.clip_similarity(jparams, jnp.asarray(x),
                                            jnp.asarray(ids),
                                            normalize_images=norm))
        with torch.inference_mode():
            got = P.clip_similarity(model, torch.from_numpy(x),
                                    torch.from_numpy(ids),
                                    normalize_images=norm)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_jax_pytree_converts_into_the_port(both):
    sd, jparams, model = both
    np_params = {k: v for k, v in jparams.items()}
    conv = clip_params_from_jax(np_params)
    ported = P.clip_from_state_dict(conv, HEADS, HEADS)
    for k, v in model.state_dict().items():
        assert torch.equal(ported.state_dict()[k], v), k
    assert set(conv) == {k for k in sd if not k.endswith("position_ids")}


@pytest.mark.parametrize("size", [32, 256])
def test_bicubic_preprocess_matches_jax(size):
    x = _unit(2, size, 3)
    for norm in (True, False):
        want = np.asarray(J.preprocess(jnp.asarray(x), 224, normalize=norm))
        got = P.preprocess(torch.from_numpy(x), 224, normalize=norm).numpy()
        assert got.shape == (2, 224, 224, 3)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_jax_loader_asserts_where_the_port_loads(tmp_path, monkeypatch):
    """Reference fault: JAX's make_clip_feature_fn passes no head counts,
    so every state-dict file fails its assert; the port's loader takes
    width / 64 heads (here 2) and gives the features of the right heads."""
    sd = hf_state_dict()
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    monkeypatch.setenv("ITSD_CLIP_WEIGHTS", str(path))
    with pytest.raises(AssertionError, match="explicit head counts"):
        JF.make_clip_feature_fn()
    fn = PF.make_clip_feature_fn(device="cpu")
    x = _unit(2, 32, 4)
    want = np.asarray(J.clip_image_features(
        J.convert_transformers_clip(sd, HEADS, HEADS),
        J.preprocess(jnp.asarray(x), IMAGE)))
    with torch.inference_mode():
        got = fn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    monkeypatch.delenv("ITSD_CLIP_WEIGHTS")
    assert PF.make_clip_feature_fn(device="cpu") is None
