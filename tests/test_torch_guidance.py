"""The port's guidance, conditional UNet and conditional train step against
the JAX package's.

Inputs come from numpy seeds. The JAX UNet runs with ``attention_impl=
"xla"`` (its plain attention), the port on the CPU through its wrappers'
plain versions. JAX's t, noise and label-dropout mask (which torch cannot
draw from a threefry key) are passed into the port, and the sampler's noise
is fed from JAX's key chain.

Tolerances:
* ``cfg_combine`` and the guided eps_fns on a toy conditional model: 1e-6
  absolute on values O(1), the same f32 arithmetic.
* The conditional UNet, f32: 1e-5 absolute on outputs O(1) (conv and matmul
  sums in another order; measured ~2e-6, as the unconditional UNet in
  test_torch_unet.py). bf16: 2^-5 of the largest output, as there.
* One guided forward of the small UNet (w = 1.8): (1 + 2w) = 4.6 times the
  f32 forward's 1e-5, since guidance scales an eps difference by up to that.
* A guided chain of 6 steps with JAX's noise fed in: 1e-4 absolute (each
  guided eps differs by ~1e-5, and enters x with weight coeff2 <= 0.2 over
  the last steps of a T=20 chain).
* Two conditional train steps (lr 1e-3, the clip acts): loss and gradient
  norm to 1e-5 relative; params as test_torch_train.py's three-step test
  (all but 5e-4 of the elements within 2e-6, none beyond 5e-4, outside the
  tensors whose exact gradient is zero).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.core import denoise_segment as jax_denoise_segment
from itsd_tpu.core import linear_schedule as jax_linear_schedule
from itsd_tpu.core import process as jax_process
from itsd_tpu.core.process import diffusion_train_terms as jax_train_terms
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.models.unet import TorchConvTranspose2d
from itsd_tpu.train import OptimizerConfig as JaxOptimizerConfig
from itsd_tpu.train import create_train_state as jax_create_train_state
from itsd_tpu.train import make_optimizer as jax_make_optimizer
from itsd_tpu.train import make_train_step as jax_make_train_step
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.core import denoise_segment, linear_schedule, process
from itsd_tpu_torch.models import UNet, cond_unet_config, params_from_jax
from itsd_tpu_torch.models.convert import _leaves, _torch_entry
from itsd_tpu_torch.models.convert import expected_shapes
from itsd_tpu_torch.models.unet import ConvT
from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                  make_optimizer, make_train_step)

from _torch_port import flax_params, one_torch_thread  # noqa: F401

W = 1.8
SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0, T=20,
             num_labels=10)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# guidance on a toy conditional model


def _toy(scale):
    """A conditional 'model' of x, t and labels whose three inputs all move
    its output, written once for numpy-backed jnp and once for torch."""
    def jax_fn(x, t, lab):
        tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1)
        ll = lab.astype(jnp.float32).reshape(-1, 1, 1, 1)
        return scale * x * (1 + 0.01 * tt) + 0.1 * ll + 0.05 * jnp.sin(x)

    def torch_fn(x, t, lab):
        tt = t.float().reshape(-1, 1, 1, 1)
        ll = lab.float().reshape(-1, 1, 1, 1)
        return scale * x * (1 + 0.01 * tt) + 0.1 * ll + 0.05 * torch.sin(x)

    return jax_fn, torch_fn


@pytest.mark.parametrize("w", [0.0, 1.8, 3.5])
def test_cfg_combine_matches_jax(w):
    a, b = _arrays(0, (3, 4, 4, 2), (3, 4, 4, 2))
    want = np.asarray(jax_process.cfg_combine(jnp.asarray(a),
                                              jnp.asarray(b), w))
    got = process.cfg_combine(torch.from_numpy(a), torch.from_numpy(b), w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("interval,ok", [((10, 5), False), ((0.5, 10), False),
                                         ((5, 5), True), ((0, 10), True)])
def test_validate_interval(interval, ok):
    """Reversed intervals raise on both sides; a fractional endpoint, which
    the JAX package truncates, raises in the port; an empty interval is
    the explicit "guidance off" arm."""
    if ok:
        process._validate_interval(interval)
        jax_process._validate_interval(interval)
        return
    with pytest.raises(ValueError, match="cfg interval"):
        process._validate_interval(interval)


@pytest.mark.parametrize("batch", [3, 6, 9])
def test_tile_labels_matches_jax(batch):
    labels = np.array([3, 0, 7], np.int32)
    want = np.asarray(jax_process._tile_labels(jnp.asarray(labels), batch))
    got = process._tile_labels(torch.from_numpy(labels), batch)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tile_labels_rejects_a_batch_that_is_no_multiple():
    with pytest.raises(ValueError, match="not a multiple"):
        process._tile_labels(torch.tensor([1, 2]), 3)


@pytest.mark.parametrize("T,interval", [(100, None), (100, (20, 60)),
                                        (100, (50, 500)), (100, (-10, 30)),
                                        (100, (40, 40))])
def test_cfg_nfes_matches_jax(T, interval):
    assert process.cfg_nfes(T, interval) == jax_process.cfg_nfes(T, interval)


@pytest.mark.parametrize("interval", [None, (0, 10), (5, 15), (20, 30)])
def test_cfg_eps_fn_matches_jax(interval):
    """The dual-batched CFG eps_fn at t=12 (inside (0, 10)'s complement,
    inside (5, 15), below (20, 30)), with w traced as a float on the JAX
    side; the port decides the interval from the step the sampler passes."""
    (x,) = _arrays(1, (3, 4, 4, 2))
    labels = np.array([1, 4, 9], np.int32)
    t = np.full((3,), 12, np.int32)
    jf, tf = _toy(0.7)
    want = jax.jit(lambda x, t, w: jax_process.make_cfg_eps_fn(
        jf, jnp.asarray(labels), w, interval)(x, t))(
            jnp.asarray(x), jnp.asarray(t), W)
    eps_fn = process.make_cfg_eps_fn(tf, torch.from_numpy(labels), W,
                                     interval)
    assert eps_fn.takes_step
    got = eps_fn(torch.from_numpy(x), torch.from_numpy(t), step=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_cfg_eps_fn_runs_the_dual_forward_only_inside_the_interval():
    (x,) = _arrays(2, (2, 4, 4, 2))
    calls = []

    def model(x, t, lab):
        calls.append((x.shape[0], lab.tolist()))
        return x * 2

    eps_fn = process.make_cfg_eps_fn(model, torch.tensor([3, 5]), W, (5, 15))
    xt, tb = torch.from_numpy(x), torch.full((2,), 9)
    eps_fn(xt, tb, step=9)
    eps_fn(xt, tb, step=15)
    assert calls == [(4, [3, 5, 0, 0]), (2, [3, 5])]
    with pytest.raises(ValueError, match="step"):
        eps_fn(xt, tb)


@pytest.mark.parametrize("interval", [None, (5, 15), (20, 30)])
def test_autoguidance_eps_fn_matches_jax(interval):
    (x,) = _arrays(3, (3, 4, 4, 2))
    labels = np.array([2, 2, 8], np.int32)
    t = np.full((3,), 12, np.int32)
    js, ts = _toy(0.7)
    jw, tw = _toy(0.4)
    want = jax.jit(lambda x, t, w: jax_process.make_autoguidance_eps_fn(
        js, jw, jnp.asarray(labels), w, interval)(x, t))(
            jnp.asarray(x), jnp.asarray(t), W)
    eps_fn = process.make_autoguidance_eps_fn(
        ts, tw, torch.from_numpy(labels), W, interval)
    got = eps_fn(torch.from_numpy(x), torch.from_numpy(t), step=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# the conditional UNet


def _cond_inputs(B=3, S=16):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    t = np.array([3, 19, 11][:B], np.int32)
    labels = np.array([0, 7, 10][:B], np.int32)  # the null class included
    return x, t, labels


def _models(dtype="float32", **kw):
    cfg_kw = dict(SMALL, dtype=dtype, **kw)
    jm = JaxUNet(jax_cond_config(attention_impl="xla", **cfg_kw))
    model = UNet(cond_unet_config(**cfg_kw))
    return jm, model


@pytest.mark.parametrize("time_embed,dtype", [("table", "float32"),
                                              ("functional", "float32"),
                                              ("table", "bfloat16")])
def test_cond_unet_matches_jax(time_embed, dtype):
    """Table and functional time embedding, dual-conv downsampling,
    transpose-conv upsampling, attention in every down block, a null label
    in the batch."""
    x, t, labels = _cond_inputs()
    jm, model = _models(dtype, time_embed=time_embed)
    params = flax_params(jm, x, t, 5, labels)
    assert np.abs(params["params"]["cond_embedding"]["table"][0]).max() > 0
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                        jnp.asarray(t), jnp.asarray(labels)))
    model.load_state_dict(params_from_jax(params, model.cfg))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, labels))).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    atol = 1e-5 if dtype == "float32" else 2.0 ** -5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_null_label_embeds_to_zero_whatever_row_zero_holds():
    model = UNet(cond_unet_config(**SMALL))
    model.init_weights(torch.Generator().manual_seed(0))
    emb = model.cond_embedding
    assert emb.table[0].abs().max() > 0
    lab = torch.tensor([0, 3])
    out = emb.table[lab] * (lab != 0)[:, None]
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    h = emb(lab, torch.float32)
    h.sum().backward()
    assert torch.equal(emb.table.grad[0], torch.zeros_like(emb.table[0]))
    assert emb.table.grad[3].abs().max() > 0


def test_cond_init_is_seeded_with_a_sinusoid_time_table():
    a, b = (UNet(cond_unet_config(**SMALL)) for _ in range(2))
    a.init_weights(torch.Generator().manual_seed(2))
    b.init_weights(torch.Generator().manual_seed(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    want = jax.jit(lambda: JaxUNet(jax_cond_config(**SMALL)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)))()
    np.testing.assert_allclose(
        a.time_embedding.table.detach().numpy(),
        np.asarray(want["params"]["time_embedding"]["table"]), atol=2e-5,
        rtol=0)
    std = a.cond_embedding.table.std().item()
    assert 0.8 < std < 1.2


def test_transpose_conv_kernel_converts_without_a_flip():
    """The Flax module flips its (kh, kw, in, out) kernel to compute
    ConvTranspose2d(5, 2, 2, output_padding=1); the converter maps it to
    torch's (in, out, kh, kw) as it is."""
    (x,) = _arrays(6, (2, 5, 5, 4))
    mod = TorchConvTranspose2d(6)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    p = params["params"]
    name, w = _torch_entry(("up_1_us", "t", "kernel"), np.asarray(
        p["kernel"]))
    assert name == "up_1_us.t.weight" and w.shape == (4, 6, 5, 5)
    conv = ConvT(4, 6, 5, stride=2, padding=2, output_padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(ch=128, ch_mult=(1, 4, 8, 8, 4, 2), num_res_blocks=2, T=3000),
    dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, T=50),
    dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, T=50,
         time_embed="functional"),
])
def test_cond_param_names_and_shapes_cover_the_flax_tree(kw):
    """Every leaf of the Flax tree maps onto the port's state dict with the
    port's shape, without allocating the weights (the first case is the
    full width of configs/cifar10_cfg.yaml: 548 M parameters)."""
    kw = dict(kw, num_labels=10)
    shapes = jax.eval_shape(
        JaxUNet(jax_cond_config(**kw)).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32))
    stub = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    got = {k: tuple(a.shape) for k, a in
           (_torch_entry(p, a) for p, a in _leaves(stub["params"]))}
    want = expected_shapes(cond_unet_config(**kw))
    assert got == dict(want)
    n = sum(int(np.prod(s)) for s in want.values())
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
    if kw["ch"] == 128:
        assert 547e6 < n < 549e6


# ---------------------------------------------------------------------------
# guided forward and chain of the small UNet


@pytest.fixture(scope="module")
def small_pair():
    x, t, labels = _cond_inputs()
    jm, model = _models()
    params = flax_params(jm, x, t, 7, labels)
    model.load_state_dict(params_from_jax(params, model.cfg))
    model.eval()
    return jm, params, model


def test_guided_unet_forward_matches_jax(small_pair):
    jm, params, model = small_pair
    x, t, labels = _cond_inputs()
    labels = np.array([1, 7, 10], np.int32)
    jeps = lambda x, t, lab: jm.apply(params, x, t, lab)  # noqa: E731
    want = jax.jit(jax_process.make_cfg_eps_fn(jeps, jnp.asarray(labels),
                                               W))(jnp.asarray(x),
                                                   jnp.asarray(t))
    eps_fn = runner.make_eps_fn(model, True, torch.from_numpy(labels), W)
    with torch.no_grad():
        got = eps_fn(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=(1 + 2 * W) * 1e-5, rtol=0)


def test_guided_chain_matches_jax_with_fed_noise(small_pair):
    """6 ancestral steps (t = 19..14) of CFG guided on 15 <= t < 18, so the
    chain runs both branches; JAX's key chain's noise fed to the port."""
    jm, params, model = small_pair
    T, steps = SMALL["T"], 6
    labels = np.array([2, 5, 9], np.int32)
    (x_T,) = _arrays(8, (3, 16, 16, 3))
    key = jax.random.PRNGKey(9)
    jeps = lambda x, t, lab: jm.apply(params, x, t, lab)  # noqa: E731
    want = jax.jit(lambda x, k: jax_denoise_segment(
        jax_linear_schedule(1e-4, 0.02, T),
        jax_process.make_cfg_eps_fn(jeps, jnp.asarray(labels), W, (15, 18)),
        x, k, T, T - steps))(jnp.asarray(x_T), key)
    noises = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(np.array(jax.random.normal(nkey, x_T.shape,
                                                 jnp.float32)))
    eps_fn = runner.make_eps_fn(model, True, torch.from_numpy(labels), W,
                                cfg_interval=(15, 18))
    with torch.no_grad():
        got = denoise_segment(
            linear_schedule(1e-4, 0.02, T, device="cpu"), eps_fn,
            torch.from_numpy(x_T), T, T - steps,
            noise_fn=lambda i, t: torch.from_numpy(noises[i]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# the conditional train step


OPT = dict(lr=1e-3, weight_decay=0.5, grad_clip=1.0, multiplier=2.0,
           epochs=3, steps_per_epoch=1)
PARAM_TOL, PARAM_OUTLIERS, PARAM_MAX = 2e-6, 5e-4, 5e-4


def test_two_cond_train_steps_match_jax():
    """Labels shifted by one, a label-dropout mask (JAX's, injected) that
    sends some to the null class, the sum / B^2 loss, clip, AdamW, EMA."""
    x0, _, _ = _cond_inputs(B=3)
    raw = np.array([0, 6, 9], np.int32)
    jm, _ = _models()
    params = flax_params(jm, x0, np.zeros(3, np.int32), 10, raw)
    jsched = jax_linear_schedule(1e-4, 0.02, SMALL["T"])
    tx = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    jstate = jax_create_train_state(params, tx)
    jstep = jax_make_train_step(
        lambda p, *a, **kw: jm.apply(p, *a, **kw), jsched, tx,
        conditional=True, loss_reduction="sum_div_b2", label_dropout=0.4,
        ema_decay=0.999, donate=False)

    model = UNet(cond_unet_config(**SMALL))
    model.load_state_dict(params_from_jax(params, model.cfg))
    state = create_train_state(model, make_optimizer(
        OptimizerConfig(**OPT), model.parameters()))
    step = make_train_step(linear_schedule(1e-4, 0.02, SMALL["T"],
                                           device="cpu"),
                           conditional=True, loss_reduction="sum_div_b2",
                           label_dropout=0.4, ema_decay=0.999)
    drops = []
    for i in range(2):
        key = jax.random.PRNGKey(200 + i)
        _, tkey, lkey = jax.random.split(key, 3)
        t, noise, _ = jax_train_terms(jsched, tkey, jnp.asarray(x0))
        drop = np.asarray(jax.random.uniform(lkey, raw.shape) < 0.4)
        drops.append(drop)
        jstate, m = jstep(jstate, {"image": jnp.asarray(x0),
                                   "label": jnp.asarray(raw)}, key)
        got = step(state, {"image": torch.from_numpy(x0),
                           "label": torch.from_numpy(raw)}, None,
                   torch.from_numpy(np.array(t)).long(),
                   torch.from_numpy(np.array(noise)),
                   torch.from_numpy(drop))
        np.testing.assert_allclose(got["loss"].item(), float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"].item(),
                                   float(m["grad_norm"]), rtol=1e-5)
    assert any(d.any() for d in drops) and not all(d.all() for d in drops)
    noise_keys = {k for k, p in model.named_parameters()
                  if p.grad.abs().max().item() < 1e-6}
    want = params_from_jax(jax.device_get(jstate.params), model.cfg)
    diff = {k: (v.detach() - want[k]).abs().flatten()
            for k, v in model.state_dict().items()}
    real = torch.cat([d for k, d in diff.items() if k not in noise_keys])
    assert (real > PARAM_TOL).float().mean().item() <= PARAM_OUTLIERS
    assert real.max().item() <= PARAM_MAX
    assert max((diff[k].max().item() for k in noise_keys), default=0) <= 1e-2


def test_cond_train_step_draws_labels_dropout_from_the_generator():
    """Without an injected mask the step draws t, the noise, then the
    label-dropout uniforms from the generator: a rerun from the same seed
    repeats the step exactly."""
    model = UNet(cond_unet_config(**SMALL))
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(linear_schedule(1e-4, 0.02, SMALL["T"],
                                           device="cpu"),
                           conditional=True, label_dropout=0.5)
    batch = {"image": torch.randn(4, 8, 8, 3,
                                  generator=torch.Generator().manual_seed(1)),
             "label": torch.tensor([0, 1, 2, 3], dtype=torch.int32)}
    losses = []
    for _ in range(2):
        model.load_state_dict(init)
        state = create_train_state(model, make_optimizer(
            OptimizerConfig(**OPT), model.parameters()))
        losses.append(step(state, batch,
                           torch.Generator().manual_seed(3))["loss"].item())
    assert losses[0] == losses[1]


def test_cond_config_fields_match_jax_for_the_runner():
    """build_model's conditional branch builds the JAX runner's config."""
    from itsd_tpu.cli.runner import build_model as jax_build_model
    from itsd_tpu.utils import load_config as jax_load_config
    from itsd_tpu_torch.utils import load_config

    for te in ("table", "functional"):
        ovs = ["model.num_labels=10", f"model.time_embed={te}", "T=77",
               "channel=32", "channel_mult=[1,2]"]
        jcfg = dataclasses.asdict(jax_build_model(
            jax_load_config(None, ovs))[0].cfg)
        cfg = dataclasses.asdict(runner.build_model(
            load_config(None, ovs))[0].cfg)
        assert cfg == jcfg
