"""Spatial sharding in the port (image rows over the seq ranks:
``itsd_tpu_torch/parallel/spatial.py``, the UNet and the ViT on row shards,
``train.spatial_shard``) at two gloo ranks on the CPU, against one process
and against JAX's unsharded train step; the counterpart of
tests/test_spatial_partition.py, where GSPMD partitions the same
computation.

Two worker processes (tests/_torch_dist_worker.py, suite "spatial") start a
process group and run every case once (the ``ranks`` fixture); the tests
read what they wrote.

Tolerances (float32):
* A convolution of a rank's rows with their halo sums the same products as
  the unsharded one, 1e-5; its weight gradient is two ranks' sums added,
  1e-5.
* GroupNorm over row shards: the same two passes with the partial sums of
  two ranks added, 1e-5; its gradients 1e-5 on O(1) values.
* One train step against JAX's unsharded step (the spatial test's
  settings: lr 1e-5, dropout 0; t, the noise and the label-dropout masks
  JAX's): loss 1e-5 relative, params and EMA rtol 2e-4 / atol 2e-6, as
  tests/test_spatial_partition.py, except the tensors whose exact gradient
  is 0 (a bias before a GroupNorm, and what feeds only such biases): their
  computed gradient is f32 noise, which Adam turns into a step of up to lr
  either way, so they agree within 2 lr a step. Against the port in one
  process the same limits.
* The sampler, evaluate and train through the runner against one process:
  1e-5 (the same arithmetic but for GroupNorm's and the ring's sums).
* The ViT (img 16, patch 2, E 32, depth 2, 2 heads, f32: 32 tokens a rank)
  on two ranks' rows: its forward against one process and against JAX's
  ViT on the same weights, unsharded and on JAX's ring path (a (1, 2)
  data x seq mesh of virtual CPU devices), 1e-5; its gradients against one
  process, 1e-5. Its train steps take the UNet's limits; with remat the
  step equals the step without it on the same ranks bit for bit (the
  recompute reruns the same hops on the same draws).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu import core as JC
from itsd_tpu.core.process import diffusion_train_terms as jax_train_terms
from itsd_tpu.kernels.groupnorm import groupnorm_swish_xla
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import ViT as JaxViT
from itsd_tpu.models import ViTConfig as JaxViTConfig
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.train import OptimizerConfig as JaxOptimizerConfig
from itsd_tpu.train import create_train_state as jax_create_train_state
from itsd_tpu.train import make_optimizer as jax_make_optimizer
from itsd_tpu.train import make_train_step as jax_make_train_step
from itsd_tpu_torch import core as PC
from itsd_tpu_torch import parallel
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.kernels import groupnorm as gn
from itsd_tpu_torch.models import unet as unet_module
from itsd_tpu_torch.models import (UNet, ViT, ViTConfig, params_from_jax,
                                   uncond_unet_config, vit_params_from_jax)
from itsd_tpu_torch.parallel import SeqMesh, spatial
from itsd_tpu_torch.utils import load_config

import _torch_dist_worker as worker
from _torch_port import flax_params, one_torch_thread  # noqa: F401

WORKER_TIMEOUT = 180  # seconds, each worker
TOL = 1e-5
OPT = dict(lr=1e-5, epochs=2, steps_per_epoch=4)
CONVS = {"conv3": ("conv3", 4), "down_conv": ("down", 4, "conv"),
         "down_dual_conv": ("down", 4, "dual_conv"),
         "up_nearest_conv": ("up", 4, "nearest_conv"),
         "up_transpose_conv": ("up", 4, "transpose_conv")}
# attention at the 4x4 level of 8x8 images: 16 tokens, 8 a rank
UNCOND = dict(ch=16, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
              dropout=0.0)
# the CFG UNet's layout: dual-conv down, transpose-conv up, attention in
# every down block and the middle
COND = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0, T=20,
            num_labels=10)
# 8x8 patches of 2x2, 4 patch rows a rank; 2 heads of 16
VIT = dict(img_size=16, patch_size=2, embed_dim=32, depth=2, num_heads=2,
           mlp_ratio=4.0, dropout=0.0)
JAX_CASES = {
    "jax_uncond": ("uncond", UNCOND, 100, dict(ema_decay=0.999)),
    "jax_cond": ("cond", COND, COND["T"],
                 dict(conditional=True, loss_reduction="sum_div_b2",
                      label_dropout=0.4, ema_decay=0.999)),
    "jax_vit": ("vit", VIT, 100, dict(ema_decay=0.999))}
# the seeded cases: dropout 0.1 from one seeded generator
SEEDED = {"seeded": ("uncond", dict(UNCOND, dropout=0.1), 8),
          "seeded_vit": ("vit", dict(VIT, dropout=0.1), 16),
          "seeded_vit_remat": ("vit", dict(VIT, dropout=0.1, remat=True),
                               16)}
# evaluate's other samplers on the rows: DDIM's noise (eta 1), DPM-Solver++,
# restart's renoise, Picard's stopping test (a mean over the whole images)
SAMPLERS = {
    "ddim_eta1": ["diffusion.sampler=ddim", "diffusion.ddim_steps=5",
                  "diffusion.ddim_eta=1.0"],
    "dpm": ["diffusion.sampler=dpm", "diffusion.ddim_steps=5"],
    "restart": ["diffusion.sampler=ddim", "diffusion.ddim_steps=5",
                "diffusion.restart_intervals=[[6,3,1]]"],
    "picard": ["diffusion.sampler=picard", "diffusion.ddim_steps=5"]}
TINY = ["channel=16", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
        "T=10", "img_size=8", "data.dataset=shapes",
        "train.track_metrics=false", "data.use_full_dataset=false",
        "data.train_subset_ratio=0.005", "train.eval_batch_size=2",
        "train.batch_size=4", "train.epoch=1", "train.eval_freq=1",
        "model.dropout=0.1", "train.eval_metric_interval=3"]
VIT_TINY = TINY + ["model.backbone=vit", "model.patch_size=2",
                   "model.embed_dim=32", "model.depth=2", "model.num_heads=2",
                   "img_size=16"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _conv_inputs(rng):
    out = {}
    for name, spec in CONVS.items():
        m = worker.conv_module(spec)
        x = _t(rng.standard_normal((2, 4, 8, 6)))
        with torch.no_grad():
            y = m(x)
        out[name] = {"spec": spec, "params": m.state_dict(), "x": x,
                     "cot": _t(rng.standard_normal(tuple(y.shape)))}
    return out


def _jax_keys(i):
    key = jax.random.PRNGKey(300 + i)
    return key, jax.random.split(key, 3)


def _jax_model(kind, kw):
    if kind == "vit":
        return JaxViT(JaxViTConfig(**kw))
    return JaxUNet((jax_cond_config if kind == "cond"
                    else jax_uncond_config)(**kw))


def _port_params(kind, kw, params):
    """JAX's params in the port's layout."""
    if kind == "vit":
        return vit_params_from_jax(params, ViTConfig(**kw))
    return params_from_jax(params, worker.build_unet((kind, kw)).cfg)


def _train_inputs(rng):
    """The train-step cases: JAX's seeded params, one batch and JAX's draws
    (t, the noise, the label-dropout mask) for two steps; and seeded inits
    with the dropout at 0.1 from a seeded generator (the ViT with and
    without remat)."""
    x0 = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    vit_rng = np.random.default_rng(29)
    x0_vit = vit_rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    raw = np.array([0, 6, 9, 3], np.int32)
    cases, jax_params = {}, {}
    for name, (kind, kw, T, step_kw) in JAX_CASES.items():
        cond = kind == "cond"
        jm = _jax_model(kind, kw)
        x = x0_vit if kind == "vit" else x0
        params = flax_params(jm, x, np.zeros(4, np.int32), 10,
                             raw if cond else None)
        jax_params[name] = (jm, params)
        draws = []
        for i in range(2):
            _, (_, tkey, lkey) = _jax_keys(i)
            t, noise, _ = jax_train_terms(JC.linear_schedule(1e-4, 0.02, T),
                                          tkey, jnp.asarray(x))
            drop = (torch.from_numpy(np.array(
                jax.random.uniform(lkey, raw.shape) < 0.4)) if cond
                else None)
            draws.append((torch.from_numpy(np.array(t)).long(),
                          torch.from_numpy(np.array(noise)), drop))
        batch = {"image": x, "label": raw} if cond else {"image": x}
        cases[name] = dict(
            model=(kind, kw), opt=OPT, T=T, step=step_kw, seed=None,
            params=_port_params(kind, kw, params), draws=draws, masks=None,
            batches=[{k: torch.from_numpy(v) for k, v in batch.items()}] * 2)
    for name, (kind, kw, size) in SEEDED.items():
        r = rng if kind != "vit" else np.random.default_rng(31)
        cases[name] = dict(
            model=(kind, kw), params=None, opt=OPT, T=100, seed=5,
            draws=None, masks=None, step=dict(ema_decay=0.999),
            batches=[{"image": _t(r.standard_normal((4, size, size, 3)))}
                     for _ in range(2)])
    return cases, jax_params


def _jax_train(cases, jax_params):
    """JAX's two unsharded steps of each JAX case: the losses, the params
    and the EMA, in the port's layout."""
    out = {}
    for name, (kind, kw, T, step_kw) in JAX_CASES.items():
        jm, params = jax_params[name]
        tx = jax_make_optimizer(JaxOptimizerConfig(**OPT))
        jstate = jax_create_train_state(params, tx)
        jstep = jax_make_train_step(
            lambda p, *a, **k: jm.apply(p, *a, **k),
            JC.linear_schedule(1e-4, 0.02, T), tx, donate=False, **step_kw)
        batch = {k: v.numpy() for k, v in cases[name]["batches"][0].items()}
        losses = []
        for i in range(2):
            key, _ = _jax_keys(i)
            jstate, m = jstep(jstate, batch, key)
            losses.append(float(m["loss"]))
        out[name] = dict(
            losses=losses,
            params=_port_params(kind, kw, jax.device_get(jstate.params)),
            ema=_port_params(kind, kw, jax.device_get(jstate.ema_params)))
    return out


def _runner_inputs(rng):
    cfg = load_config(None, TINY)
    model, _ = runner.build_model(cfg)
    return {"overrides": TINY, "params": runner.init_params(cfg, model),
            "real_features": rng.standard_normal((64, 3)),
            "samplers": SAMPLERS}


def _sampler_inputs(rng):
    model = UNet(uncond_unet_config(**UNCOND))
    model.init_weights(torch.Generator().manual_seed(2))
    return {"model": ("uncond", UNCOND), "params": model.state_dict(),
            "x_T": _t(rng.standard_normal((2, 8, 8, 3))), "T": 10, "seed": 3}


def _vit_inputs():
    """The ViT cases: JAX's seeded params (and in the port's layout), two
    images with their t and a cotangent, the dropout test's token shape
    [B, N, E], and the runner's tiny ViT with its seeded init."""
    rng = np.random.default_rng(37)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 71], np.int32)
    jm = JaxViT(JaxViTConfig(**VIT))
    params = flax_params(jm, x, t, 11)
    cfg = load_config(None, VIT_TINY)
    model, _ = runner.build_model(cfg)
    return {"model": ("vit", VIT), "params": _port_params("vit", VIT, params),
            "x": _t(x), "t": torch.from_numpy(t).long(),
            "cot": _t(rng.standard_normal(x.shape)),
            "dropout_shape": (2, 64, 8), "overrides": VIT_TINY,
            "runner_params": runner.init_params(cfg, model),
            "real_features": rng.standard_normal((64, 3))}, (jm, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(23)
    cases, jax_params = _train_inputs(rng)
    vit, jax_vit = _vit_inputs()
    g = {"x": _t(rng.standard_normal((2, 8, 8, 6)) * 2 + 0.5),
         "weight": _t(1 + 0.1 * rng.standard_normal(8)),
         "bias": _t(0.1 * rng.standard_normal(8)), "groups": 4, "act": True,
         "cot": _t(rng.standard_normal((2, 8, 8, 6)))}
    inputs = {"spatial": {"convs": _conv_inputs(rng), "gn": g,
                          "train": cases, "sampler": _sampler_inputs(rng),
                          "runner": _runner_inputs(rng), "vit": vit}}
    torch.save(inputs, out / "inputs.pt")
    jax_out, got, logs = worker.run_ranks(
        out, "spatial", WORKER_TIMEOUT, lambda: _jax_train(cases, jax_params))
    return dict(got=got, inputs=inputs["spatial"], jax=jax_out, dir=out,
                logs=logs, jax_vit=jax_vit)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the layers


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_halo_matches_unsharded(ranks, name):
    """Every convolution of the UNets on two ranks' rows with their halos
    (3x3 stride 1; the down-samplers' 3x3 and 5x5 stride 2; nearest and
    5x5 transposed up-sampling, each then 3x3): the output, the gradient
    of x (the halo's gradient sent back to its owner) and the weights'
    gradients, against the unsharded module."""
    case = ranks["inputs"]["convs"][name]
    m = worker.conv_module(case["spec"])
    m.load_state_dict(case["params"])
    x = case["x"].clone().requires_grad_()
    y = m(x)
    (y * case["cot"]).sum().backward()
    for got in ranks["got"]:
        g = got["convs"][name]
        _close(g["out"], y.detach())
        _close(g["dx"], x.grad)
        for k, p in m.named_parameters():
            _close(g["dparams"][k], p.grad)


def test_row_groupnorm_matches_plain_and_jax(ranks):
    """GroupNorm+swish over two ranks' rows (partial sums all-reduced
    twice, then the normalization): the output against
    ``groupnorm_swish_plain`` and JAX's ``groupnorm_swish_xla`` on the
    whole images, and the gradients of x, the scale and the bias against
    both."""
    g = ranks["inputs"]["gn"]
    x, w, b = (g[n].clone().requires_grad_() for n in ("x", "weight",
                                                        "bias"))
    y = gn.groupnorm_swish_plain(x, w, b, g["groups"], act=g["act"])
    (y * g["cot"]).sum().backward()

    def jax_fn(x, w, b):
        return jnp.transpose(groupnorm_swish_xla(
            jnp.transpose(x, (0, 2, 3, 1)), w, b, g["groups"],
            act=g["act"]), (0, 3, 1, 2))

    args = [jnp.asarray(g[n].numpy()) for n in ("x", "weight", "bias")]
    jy, vjp = jax.vjp(jax_fn, *args)
    jgrads = vjp(jnp.asarray(g["cot"].numpy()))
    for got in ranks["got"]:
        r = got["gn"]
        _close(r["out"], y.detach())
        _close(r["out"], np.asarray(jy))
        for mine, plain, jg in zip(
                (r["dx"], r["dparams"]["weight"], r["dparams"]["bias"]),
                (x.grad, w.grad, b.grad), jgrads):
            _close(mine, plain)
            _close(mine, np.asarray(jg))


# ---------------------------------------------------------------------------
# the train step


NOISE_MAX = 2 * 2 * OPT["lr"]  # two steps of up to lr either way


def _check_params(got, want, grads_zero, noise_max=NOISE_MAX):
    for k, w in want.items():
        if k in grads_zero:
            assert (got[k] - w).abs().max().item() <= noise_max, k
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                       rtol=2e-4, atol=2e-6, err_msg=k)


def _one_process(ranks, name):
    """The case in this process on the whole images."""
    return worker.train_steps(ranks["inputs"]["train"][name], None,
                              lambda a: a)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_spatial_train_step_matches_jax(ranks, name):
    """Two steps with the image rows over two ranks (the ring in every
    attention block, the halos in every convolution, GroupNorm over the
    rows) against JAX's unsharded step on the same params and draws: the
    unconditional UNet with the mean loss, the CFG layout with the sum / b^2
    loss and JAX's label-dropout masks."""
    want = ranks["jax"][name]
    zero = _one_process(ranks, name)["tiny_grads"]
    for got in ranks["got"]:
        g = got["train"][name]
        np.testing.assert_allclose([m[0] for m in g["metrics"]],
                                   want["losses"], rtol=1e-5)
        _check_params(g["params"], want["params"], zero)
        _check_params(g["ema"], want["ema"], zero)


@pytest.mark.parametrize("name", list(JAX_CASES) + list(SEEDED))
def test_spatial_train_step_equals_one_process(ranks, name):
    """The same steps in one process on the whole images; the seeded cases
    draw t, the noise and the dropout masks (rate 0.1) for the global
    batch and images from one seeded generator, and each rank keeps its
    rows (the UNet's image rows, the ViT's tokens)."""
    ref = _one_process(ranks, name)
    for got in ranks["got"]:
        g = got["train"][name]
        np.testing.assert_allclose(g["metrics"], ref["metrics"], rtol=1e-5)
        _check_params(g["params"], ref["params"], ref["tiny_grads"])
        _check_params(g["ema"], ref["ema"], ref["tiny_grads"])


# ---------------------------------------------------------------------------
# sampling and the runner


def test_spatially_sharded_sampler_matches_unsharded(ranks):
    """The ancestral chain on two ranks' rows, its noise drawn for the
    whole images and cut, against one process's chain from the same
    generator."""
    s = ranks["inputs"]["sampler"]
    model = worker.build_unet(s["model"])
    model.load_state_dict(s["params"])
    model.eval()
    sched = PC.linear_schedule(1e-4, 0.02, s["T"], device="cpu")
    with torch.no_grad():
        want = PC.sample(sched, lambda x, t: model(x, t), s["x_T"],
                         generator=torch.Generator().manual_seed(s["seed"]))
    for got in ranks["got"]:
        _close(got["sampler"], want)


def test_evaluate_with_spatial_shard_matches_one_process(ranks, tmp_path):
    """runner.evaluate with train.spatial_shard=2 at two ranks (its noise
    and chain on each rank's rows, the images gathered) against the same
    evaluate in one process, where a seq axis of 2 does not tile one
    rank."""
    r = ranks["inputs"]["runner"]
    cfg = load_config(None, r["overrides"] + [f"sampled_dir={tmp_path}"])
    want = runner.evaluate(cfg, params=r["params"], device="cpu")["images"]
    for got in ranks["got"]:
        _close(got["evaluate"], want)
    assert parallel.get_seq_mesh() is None


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_evaluate_samplers_with_spatial_shard_match_one_process(
        ranks, tmp_path, name):
    """evaluate's other samplers on two ranks' rows against one process:
    DDIM at eta 1 and restart draw noise for the whole images and cut it;
    Picard stops on the mean change over the whole images, the same on
    both ranks."""
    r = ranks["inputs"]["runner"]
    cfg = load_config(None, r["overrides"] + SAMPLERS[name] + [
        f"sampled_dir={tmp_path}"])
    want = runner.evaluate(cfg, params=r["params"], device="cpu")["images"]
    for got in ranks["got"]:
        _close(got["samplers"][name], want)


def test_sample_with_metrics_with_spatial_shard_matches_one_process(
        ranks, tmp_path):
    """The metric-tracked chain with train.spatial_shard=2 at two ranks:
    its snapshots gathered before they are scored (each image's mean
    colour against seeded real features), the one-process run's images
    and Fréchet distances."""
    r = ranks["inputs"]["runner"]
    cfg = load_config(None, r["overrides"] + [
        f"sampled_dir={tmp_path}", f"metrics_save_dir={tmp_path}"])
    want = runner.sample_with_metrics(
        cfg, r["params"], feature_fn=worker.pixel_means,
        real_features=r["real_features"], device="cpu")
    assert len(want["history"]) > 1
    for got in ranks["got"]:
        g = got["tracked"]
        _close(g["images"], want["images"])
        assert [h[0] for h in g["history"]] == [h[0] for h in
                                                want["history"]]
        np.testing.assert_allclose([h[1] for h in g["history"]],
                                   [h[1] for h in want["history"]],
                                   rtol=1e-4)


def test_runner_train_with_spatial_shard_matches_one_process(ranks):
    """runner.train with train.spatial_shard=2 at two ranks for 2 steps
    (dropout 0.1, the epoch's grid sampled on the rows): the one-process
    run's losses and weights; rank 0 alone writes."""
    out = ranks["dir"]
    assert (out / "r0" / "ckpt" / "ckpt_0").is_file()
    assert (out / "r0" / "sampled" / "epoch_0_sampled.png").is_file()
    assert not (out / "r1" / "ckpt").exists()
    cfg = load_config(None, TINY + [f"save_weight_dir={out}/one/ckpt",
                                    f"metrics_save_dir={out}/one/metrics",
                                    f"sampled_dir={out}/one/sampled"])
    want = runner.train(cfg, max_steps=2, device="cpu")
    model = want["state"].model
    zero = {k for k, p in model.named_parameters()
            if p.grad.abs().max().item() < 1e-6}
    for got in ranks["got"]:
        g = got["runner_train"]
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=TOL)
        # the schedule's peak lr is lr * multiplier
        _check_params(g["params"], model.state_dict(), zero,
                      4 * cfg.train.lr * cfg.train.multiplier)


# ---------------------------------------------------------------------------
# one process


def test_levels_the_seq_ranks_do_not_divide_raise():
    """A level whose rows the seq ranks cannot split raises ValueError
    naming it, before any exchange: the CFG UNet's ch_mult reaches 1x1 at
    32x32 (JAX's GSPMD pads there)."""
    model = UNet(uncond_unet_config(ch=16, ch_mult=(1, 2, 2), attn=(),
                                    num_res_blocks=1))
    model.check_rows(8, 2)
    with pytest.raises(ValueError, match="the 1 image rows of level 2"):
        model.check_rows(4, 2)
    with spatial.row_shards(SeqMesh(data=1, seq=2)), \
            pytest.raises(ValueError, match="level 2"):
        model(torch.zeros(1, 2, 4, 3), torch.zeros(1, dtype=torch.int64))


def test_train_mesh_follows_jax(monkeypatch, capsys):
    """``train.spatial_shard`` as JAX's ``_train_mesh``: K must divide the
    world size and img_size (JAX's messages); K=1 with ring prints JAX's
    note and sizes the seq axis 1; the ViT takes the UNet's layout, seq
    = K."""
    cfg = load_config(None, TINY + ["train.spatial_shard=2"])
    with pytest.raises(ValueError,
                       match="spatial_shard=2 must divide device count 1"):
        runner.train(cfg, max_steps=1, device="cpu")
    monkeypatch.setattr(runner, "world_size", lambda: 2)
    odd = copy.deepcopy(cfg)
    odd.data.img_size = 9
    with pytest.raises(ValueError, match="must divide img_size 9"):
        runner._train_mesh(odd)
    vit = copy.deepcopy(cfg)
    vit.model.backbone = "vit"
    monkeypatch.setattr(runner, "make_seq_mesh", lambda k: ("layout", k))
    assert runner._train_mesh(vit) == ("layout", 2)
    monkeypatch.undo()
    ring = load_config(None, TINY + ["model.attention_impl=ring"])
    mesh = runner._train_mesh(ring)
    assert (mesh.data, mesh.seq) == (1, 1)
    assert "ring runs with a size-1 seq axis" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the ViT


def test_vit_check_rows_needs_whole_patches():
    """The ViT on row shards wants whole patch rows a rank: img 12 with
    patch 4 splits over 3 ranks (4 rows each) but not over 2 (6 rows),
    where it raises ValueError before any exchange (JAX's GSPMD
    reshards)."""
    model = ViT(ViTConfig(img_size=12, patch_size=4, embed_dim=8, depth=1,
                          num_heads=1))
    model.check_rows(12, 3)
    with pytest.raises(ValueError, match="patch_size 4 must divide a "
                       "rank's 6 rows"):
        model.check_rows(12, 2)
    with spatial.row_shards(SeqMesh(data=1, seq=2)), \
            pytest.raises(ValueError, match="patch_size 4"):
        model(torch.zeros(1, 6, 12, 3), torch.zeros(1, dtype=torch.int64))


def test_zero_row_halo_posts_no_message(monkeypatch):
    """A halo of no rows (the ViT's patch embedding: kernel = stride =
    patch, no padding) is x itself, with or without a gradient, and posts
    no message; the patch embedding of a rank's rows is those rows of the
    unsharded one."""
    def posted(*args, **kwargs):
        raise AssertionError("a message was posted")

    monkeypatch.setattr(spatial, "p2p", posted)
    mesh = SeqMesh(data=1, seq=2)
    x = _t(np.random.default_rng(41).standard_normal((2, 3, 8, 8)))
    assert spatial.halo(x, 0, 0, mesh) is x
    xg = x.clone().requires_grad_()
    assert spatial.halo(xg, 0, 0, mesh) is xg
    conv = ViT(ViTConfig(**VIT)).patch_embed
    with torch.no_grad():
        whole = conv(x)
        with spatial.row_shards(mesh):
            top = conv(x[:, :, :4])
    _close(top, whole[:, :, :2])


def _vit_one_process(ranks):
    """The ViT case in this process on the whole images: the model (its
    parameters' gradients of sum(out * cot) set), the output and the
    gradient of x."""
    v = ranks["inputs"]["vit"]
    model = worker.build_unet(v["model"])
    model.load_state_dict(v["params"])
    x = v["x"].clone().requires_grad_()
    out = model(x, v["t"])
    (out * v["cot"]).sum().backward()
    return model, out.detach(), x.grad


def test_vit_on_rows_matches_one_process_and_jax(ranks):
    """The ViT on two ranks' rows (each rank's share of the position
    embedding, the ring in every block): the gathered output against one
    process and JAX's ViT on the same weights, and the gradients of x and
    of every parameter (summed over the ranks) against one process's."""
    v = ranks["inputs"]["vit"]
    jm, jparams = ranks["jax_vit"]
    model, out, dx = _vit_one_process(ranks)
    want = jm.apply(jparams, jnp.asarray(v["x"].numpy()),
                    jnp.asarray(v["t"].numpy()))
    for got in ranks["got"]:
        g = got["vit"]["forward"]
        _close(g["out"], out)
        _close(g["out"], np.asarray(want))
        _close(g["dx"], dx)
        for k, p in model.named_parameters():
            _close(g["dparams"][k], p.grad)


def test_vit_on_rows_matches_jax_ring_path(ranks, monkeypatch):
    """JAX's ViT with its input on a (1, 2) data x seq mesh of virtual CPU
    devices under ``seq_mesh_scope``, as ``train.spatial_shard=2`` runs it:
    every attention call goes around JAX's ring (GSPMD partitions the
    rest); the ranks' gathered output matches it."""
    from itsd_tpu.kernels import attention as jax_attention
    from itsd_tpu.parallel import make_mesh, seq_mesh_scope, spatial_sharding

    v = ranks["inputs"]["vit"]
    jm, jparams = ranks["jax_vit"]
    ring_calls = []
    dispatch = jax_attention._ring_dispatch

    def counted(*args, **kwargs):
        ring_calls.append(None)
        return dispatch(*args, **kwargs)

    monkeypatch.setattr(jax_attention, "_ring_dispatch", counted)
    mesh = make_mesh((1, 2), ("data", "seq"), devices=jax.devices()[:2])
    x = jax.device_put(jnp.asarray(v["x"].numpy()), spatial_sharding(mesh))
    with seq_mesh_scope(mesh):
        want = jm.apply(jparams, x, jnp.asarray(v["t"].numpy()))
    assert len(ring_calls) == VIT["depth"]
    for got in ranks["got"]:
        _close(got["vit"]["forward"]["out"], np.asarray(want))


def test_vit_dropout_masks_are_cut_along_the_tokens(ranks):
    """A ViT dropout mask ([B, N, E]) under ``RowDraws`` at two seq ranks:
    drawn for the global tokens and cut along them (axis 1), the ranks'
    masks put together are one process's mask from the same generator;
    the UNet's default axis (NCHW rows) is unchanged."""
    shape = ranks["inputs"]["vit"]["dropout_shape"]
    want = unet_module.dropout(torch.ones(shape), 0.5,
                               torch.Generator().manual_seed(4), h_axis=1)
    for got in ranks["got"]:
        assert torch.equal(got["vit"]["dropout"], want)
    h = torch.ones(2, 4, 6, 6)
    assert torch.equal(
        unet_module.dropout(h, 0.5, torch.Generator().manual_seed(4)),
        unet_module.dropout(h, 0.5, torch.Generator().manual_seed(4),
                            h_axis=2))


def test_vit_remat_step_equals_no_remat_on_rows(ranks):
    """Two seeded ViT steps (dropout 0.1) on two ranks' rows with remat:
    the recompute reruns each block's ring hops in the backward on every
    rank in one order, with the same dropout masks, and gives the step
    without remat bit for bit."""
    for got in ranks["got"]:
        a, b = got["train"]["seeded_vit_remat"], got["train"]["seeded_vit"]
        assert a["metrics"] == b["metrics"]
        for k, p in b["params"].items():
            assert torch.equal(a["params"][k], p), k


def test_vit_evaluate_with_spatial_shard_matches_one_process(ranks,
                                                             tmp_path):
    """runner.evaluate of the tiny ViT with train.spatial_shard=2 at two
    ranks against one process."""
    v = ranks["inputs"]["vit"]
    cfg = load_config(None, v["overrides"] + [f"sampled_dir={tmp_path}"])
    want = runner.evaluate(cfg, params=v["runner_params"],
                           device="cpu")["images"]
    for got in ranks["got"]:
        _close(got["vit"]["evaluate"], want)


def test_vit_sample_with_metrics_with_spatial_shard_matches_one_process(
        ranks, tmp_path):
    """The tiny ViT's metric-tracked chain with train.spatial_shard=2 at
    two ranks: the one-process run's images and Fréchet distances."""
    v = ranks["inputs"]["vit"]
    cfg = load_config(None, v["overrides"] + [
        f"sampled_dir={tmp_path}", f"metrics_save_dir={tmp_path}"])
    want = runner.sample_with_metrics(
        cfg, v["runner_params"], feature_fn=worker.pixel_means,
        real_features=v["real_features"], device="cpu")
    for got in ranks["got"]:
        g = got["vit"]["tracked"]
        _close(g["images"], want["images"])
        np.testing.assert_allclose([h[1] for h in g["history"]],
                                   [h[1] for h in want["history"]],
                                   rtol=1e-4)


def test_vit_runner_train_with_spatial_shard_matches_one_process(ranks):
    """runner.train of the tiny ViT with train.spatial_shard=2 at two ranks
    for 2 steps (dropout 0.1, masks cut along the tokens): the one-process
    run's losses and weights."""
    out = ranks["dir"]
    assert (out / "r0" / "vit_ckpt" / "ckpt_0").is_file()
    assert not (out / "r1" / "vit_ckpt").exists()
    cfg = load_config(None, VIT_TINY + [
        f"save_weight_dir={out}/one_vit/ckpt",
        f"metrics_save_dir={out}/one_vit/metrics",
        f"sampled_dir={out}/one_vit/sampled"])
    want = runner.train(cfg, max_steps=2, device="cpu")
    model = want["state"].model
    # the key projection's bias has an exact gradient of 0 (the softmax
    # does not see a shift of every key by one vector)
    zero = {k for k, p in model.named_parameters()
            if p.grad.abs().max().item() < 1e-6}
    assert {k for k in zero if not k.endswith("k.bias")} == set(), zero
    for got in ranks["got"]:
        g = got["vit"]["runner_train"]
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=TOL)
        _check_params(g["params"], model.state_dict(), zero,
                      4 * cfg.train.lr * cfg.train.multiplier)
