"""The port's ViT, multi-head attention, ``attention_impl`` and remat
against the JAX package.

Weights: small ViTs take a seeded Flax tree (``flax_params``: kernels
O(1/sqrt(fan_in)), norms near 1, biases and the position table O(0.1));
``artifacts/shapes32_vit`` (trained on the shapes dataset at 32x32, stored
in bf16) is restored and cast to f32 as ``bench.py`` does, then converted
in memory with ``vit_params_from_jax``. Both sides run in f32 on the CPU,
where the port's attention is its plain version and JAX's is
``_attention_xla`` (its "auto" never takes the flash path at a head width
of 64 or less: ``_flash_eligible`` wants C % 128 == 0).

Tolerances:
* one ViT forward, small or trained (|eps| up to ~7): 1e-5 absolute; the
  frameworks sum matmul products in other orders, and Flax's LayerNorm
  takes the variance as E[x^2] - E[x]^2 (measured 4.8e-6 on the trained
  ViT).
* 10 ancestral steps on the trained ViT with JAX's noise fed in: 1e-5
  absolute, as the UNet's chain in ``tests/test_torch_artifacts.py``.
* ``mha_attention``: 1e-6 absolute on outputs O(1).
* remat: the gradient with remat equals the one without bit for bit (the
  same ops on the CPU, the same dropout masks in the recompute); against
  JAX's gradient through ``nn.remat``, 1e-4 of the largest gradient
  element (f32 sums in another order through the backward).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.cli.runner import build_model as jax_build_model
from itsd_tpu.core import denoise_segment as jax_denoise_segment
from itsd_tpu.core import linear_schedule as jax_linear_schedule
from itsd_tpu.kernels.attention import mha_attention as jax_mha_attention
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import ViT as JaxViT
from itsd_tpu.models import ViTConfig as JaxViTConfig
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.train.checkpoint import restore_params
from itsd_tpu.utils import load_config as jax_load_config
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.core import denoise_segment, linear_schedule
from itsd_tpu_torch.kernels import attention
from itsd_tpu_torch.models import (UNet, ViT, ViTConfig, params_from_jax,
                                   uncond_unet_config, vit_params_from_jax)
from itsd_tpu_torch.models.convert import expected_shapes
from itsd_tpu_torch.utils import load_config

from _torch_port import flax_params, one_torch_thread  # noqa: F401

ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "artifacts", "shapes32_vit")
SMALL = dict(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=4,
             mlp_ratio=4.0, dropout=0.0)


def _inputs(B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    t = np.array([3, 917, 40][:B], np.int32)
    return x, t


def _small(seed=1, **kw):
    """(JAX ViT, its seeded params, the port's ViT with them)."""
    cfg = dict(SMALL, **kw)
    jm = JaxViT(JaxViTConfig(**cfg))
    x, t = _inputs()
    params = flax_params(jm, x, t, seed=seed)
    model = ViT(ViTConfig(**cfg))
    model.load_state_dict(vit_params_from_jax(params, model.cfg))
    return jm, params, model


def test_vit_param_names_and_shapes_cover_the_flax_tree():
    jm = JaxViT(JaxViTConfig(**SMALL))
    x, t = _inputs()
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(t))["params"]
    n_flax = len(jax.tree.leaves(tree))
    want = expected_shapes(ViTConfig(**SMALL), ViT)
    assert len(want) == n_flax
    assert want["pos_embed"] == (1, 16, 32)
    assert want["patch_embed.weight"] == (32, 3, 4, 4)
    assert want["block_1.mlp1.weight"] == (128, 32)
    assert want["head.weight"] == (4 * 4 * 3, 32)
    params = flax_params(jm, x, t, seed=2)
    params["params"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="extra"):
        vit_params_from_jax(params, ViTConfig(**SMALL))


@pytest.mark.parametrize("seed", [1, 2])
def test_small_vit_matches_jax(seed):
    jm, params, model = _small(seed)
    x, t = _inputs(B=3, seed=seed)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                        jnp.asarray(t)))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(want).max() > 0.3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_vit_init_is_seeded_and_takes_no_labels():
    a, b = ViT(ViTConfig(**SMALL)), ViT(ViTConfig(**SMALL))
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert 0.01 < a.pos_embed.std().item() < 0.03
    assert torch.equal(a.block_0.norm1.weight, torch.ones(32))
    assert a.head.weight.abs().max() > 0.05
    x, t = _inputs()
    with pytest.raises(ValueError, match="unconditional"):
        a(torch.from_numpy(x), torch.from_numpy(t), torch.zeros(2).long())


def test_build_model_makes_the_jax_runners_vit():
    ovs = ["model.backbone=vit", "img_size=32", "model.patch_size=2",
           "model.embed_dim=48", "model.depth=3", "model.num_heads=6",
           "model.remat=true", "model.dtype=bfloat16", "model.num_labels=10"]
    jm, jcond = jax_build_model(jax_load_config(None, ovs))
    model, cond = runner.build_model(load_config(None, ovs))
    assert isinstance(model, ViT) and cond is jcond is False
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jm.cfg)
    with pytest.raises(ValueError, match="backbone"):
        runner.build_model(load_config(None, ["model.backbone=dit"]))


@pytest.fixture(scope="module")
def trained():
    with open(ARTIFACT + ".json") as f:
        meta = json.load(f)
    a = meta["arch"]
    kw = dict(img_size=a["img"], patch_size=a["patch_size"],
              embed_dim=a["embed_dim"], depth=a["depth"],
              num_heads=a["num_heads"], mlp_ratio=a["mlp_ratio"],
              dropout=a["dropout"])
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                          restore_params(ARTIFACT))
    jm = JaxViT(JaxViTConfig(**kw))
    model = ViT(ViTConfig(**kw))
    model.load_state_dict(vit_params_from_jax(params, model.cfg))
    model.eval()
    return jm, params, meta, model


def test_trained_vit_matches_jax(trained):
    jm, params, meta, model = trained
    assert meta["backbone"] == "vit" and meta["arch"]["img"] == 32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    fwd = jax.jit(jm.apply)
    for t in (10, 900):
        tb = np.full((2,), t, np.int32)
        want = np.asarray(fwd(params, jnp.asarray(x), jnp.asarray(tb)))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(tb)).numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0.5
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_trained_vit_chain_matches_jax_with_fed_noise(trained):
    jm, params, meta, model = trained
    T, steps = meta["train_T"], 10
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda x, k: jax_denoise_segment(
        jax_linear_schedule(1e-4, 0.02, T),
        lambda x, t: jm.apply(params, x, t), x, k, T, T - steps))(
            jnp.asarray(x_T), key)
    noises = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(np.array(jax.random.normal(nkey, x_T.shape,
                                                 jnp.float32)))
    with torch.no_grad():
        got = denoise_segment(linear_schedule(1e-4, 0.02, T, device="cpu"),
                              model, torch.from_numpy(x_T), T, T - steps,
                              noise_fn=lambda i, t: torch.from_numpy(
                                  noises[i]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


VIT_KEYS = ["model.backbone=vit", "model.patch_size=2", "model.embed_dim=32",
            "model.depth=2", "model.num_heads=4", "img_size=8", "T=6",
            "data.dataset=shapes", "train.track_metrics=false",
            "train.batch_size=4", "data.use_full_dataset=false",
            "data.train_subset_ratio=0.005", "train.eval_batch_size=2"]


def test_vit_trains_evaluates_and_searches_through_the_runner(tmp_path):
    """backbone=vit through ``runner.train`` (remat on, a grid each
    epoch), ``evaluate`` from its checkpoint (DDIM) and ``run_search``."""
    keys = VIT_KEYS + [f"save_weight_dir={tmp_path}/ckpt",
                       f"sampled_dir={tmp_path}/s",
                       f"metrics_save_dir={tmp_path}/m"]
    out = runner.train(load_config(None, keys + [
        "model.remat=true", "train.epoch=1", "train.eval_freq=1"]),
        max_steps=2, device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert isinstance(out["state"].model, ViT)
    assert (tmp_path / "s" / "epoch_0_sampled.png").is_file()
    ev = runner.evaluate(load_config(None, keys + [
        "test_load_weight=ckpt_0", "diffusion.sampler=ddim",
        "diffusion.ddim_steps=3"]), device="cpu")
    assert ev["images"].shape == (2, 8, 8, 3)
    assert np.isfinite(ev["images"]).all()
    res = runner.run_search(load_config(None, keys + [
        "test_load_weight=ckpt_0", "search.n_candidates=2"]), device="cpu")
    assert np.isfinite(res["best_score"]) and res["nfes"] == 2


# ---------------------------------------------------------------------------
# multi-head attention and attention_impl


def test_mha_attention_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 24, 3, 8)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_mha_attention(*map(jnp.asarray, (q, k, v)),
                                        impl="xla"))
    got = attention.mha_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 24, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl,env,path", [
    ("auto", None, "flash"), ("auto", "auto", "flash"),
    ("auto", "flash", "flash"), ("auto", "xla", "xla"),
    ("flash", "xla", "flash"), ("xla", "flash", "xla"),
    ("auto", "ring", "ring"), ("ring", None, "ring"),
    ("auto", "fast", "bad env"), ("fast", None, "bad impl")])
def test_attention_impl_and_the_environment(impl, env, path, monkeypatch):
    """"auto" reads ITSD_ATTN_IMPL as JAX's spatial_attention does; an
    explicit impl does not. "flash" takes the kernels' entry (the plain
    version on a CPU tensor), "xla" the plain version, "ring" the ring over
    the default layout (one process: one seq rank, so the kernels' entry
    too), an unknown value ValueError."""
    if env is None:
        monkeypatch.delenv("ITSD_ATTN_IMPL", raising=False)
    else:
        monkeypatch.setenv("ITSD_ATTN_IMPL", env)
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    if path in ("bad env", "bad impl"):
        with pytest.raises(ValueError, match="ITSD_ATTN_IMPL"
                           if path == "bad env"
                           else "unknown attention impl"):
            attention.spatial_attention(q, k, v, impl=impl)
        return
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    assert attention.resolve_impl(impl) == path
    o = attention.spatial_attention(q, k, v, impl=impl)
    assert len(calls) == (path in ("flash", "ring"))
    want = attention.attention_plain(q, k, v, 8 ** -0.5)
    torch.testing.assert_close(o, want, atol=1e-6, rtol=0)
    o.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_models_take_attention_impl(impl):
    """The UNet and the ViT build with "flash" and "xla" and, on the CPU,
    compute what "auto" computes; with "ring" too, in one process (one seq
    rank: the local call; tests/test_torch_ring_attention.py runs two)."""
    x, t = _inputs()
    unet_kw = dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1)
    for build, kw in ((UNet, uncond_unet_config(**unet_kw)),
                      (ViT, ViTConfig(**SMALL))):
        auto = build(kw)
        auto.init_weights(torch.Generator().manual_seed(0))
        other = build(dataclasses.replace(kw, attention_impl=impl))
        other.load_state_dict(auto.state_dict())
        with torch.no_grad():
            a = auto.eval()(torch.from_numpy(x), torch.from_numpy(t))
            b = other.eval()(torch.from_numpy(x), torch.from_numpy(t))
        assert torch.equal(a, b)
        ring = build(dataclasses.replace(kw, attention_impl="ring"))
        ring.load_state_dict(auto.state_dict())
        with torch.no_grad():
            assert torch.equal(
                ring.eval()(torch.from_numpy(x), torch.from_numpy(t)), a)


# ---------------------------------------------------------------------------
# remat


def _grads(model, x, t, cot, generator_seed=None, deterministic=True):
    model.zero_grad()
    gen = (None if generator_seed is None
           else torch.Generator().manual_seed(generator_seed))
    eps = model(x, t, deterministic=deterministic, generator=gen)
    (eps * cot).sum().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return grads, (None if gen is None else gen.get_state())


@pytest.mark.parametrize("backbone", ["unet", "vit"])
def test_remat_gradient_equals_no_remat_and_jax(backbone):
    """The gradient of <eps, cot> through the remat'd model: with dropout
    (0.3, the masks drawn from one generator), equal bit for bit to the
    model without remat, the generator left in the same state; without
    dropout, against JAX's gradient through nn.remat."""
    x, t = _inputs()
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)
    if backbone == "unet":
        kw = dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
                  dropout=0.3)
        jm = JaxUNet(jax_uncond_config(remat=True, **dict(kw, dropout=0.0)))
        params = flax_params(jm, x, t, seed=4)
        convert, build, cfg = params_from_jax, UNet, uncond_unet_config(**kw)
    else:
        kw = dict(SMALL, dropout=0.3)
        jm = JaxViT(JaxViTConfig(remat=True, **dict(kw, dropout=0.0)))
        params = flax_params(jm, x, t, seed=4)
        convert, build, cfg = vit_params_from_jax, ViT, ViTConfig(**kw)
    sd = convert(params, cfg)
    models = {}
    for remat in (False, True):
        m = build(dataclasses.replace(cfg, remat=remat))
        m.load_state_dict(sd)
        models[remat] = m.train()
    xt, tt, ct = map(torch.from_numpy, (x, t, cot))
    plain, state = _grads(models[False], xt, tt, ct, 11, False)
    remat, remat_state = _grads(models[True], xt, tt, ct, 11, False)
    assert torch.equal(state, remat_state)
    for k, g in plain.items():
        assert torch.equal(remat[k], g), k
    # without dropout: against JAX's remat'd gradient
    got, _ = _grads(models[True], xt, tt, ct)
    jgrad = jax.grad(lambda p: jnp.sum(jm.apply(
        p, jnp.asarray(x), jnp.asarray(t)) * jnp.asarray(cot)))(params)
    want = convert(jax.device_get(jgrad), cfg)
    scale = max(w.abs().max().item() for w in want.values())
    assert scale > 1e-2
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, atol=1e-4 * scale, rtol=0,
                                   msg=k)
