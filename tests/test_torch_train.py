"""The port's training path against the JAX package's: the attention and
GroupNorm backward, the training terms, the schedule, the optimizer step,
checkpoints, the data pipeline, the runner and the CLI.

Inputs come from numpy seeds; JAX's t and noise (which torch cannot draw
from a threefry key) are passed into the port. On the CPU the port's
wrappers run their plain versions.

Tolerances:
* f32 backward of attention and GroupNorm, same formula: 2e-5 absolute on
  values O(1); only the order of f32 sums differs (~1e-6).
* f32 against the Pallas backward in interpret mode: 2e-5, the same
  formula computed blockwise.
* The schedule: 1e-6 relative; JAX evaluates it in f32, the port in f64.
* Three train steps of a tiny UNet (lr 1e-3, peak 2e-3; the clip acts at
  every step): the loss and the gradient norm to 1e-5 relative (f32 sums in
  another order). Adam's update lr * m / (sqrt(v) + eps) has about the
  same size whatever the gradient's, so where a gradient is at the level
  of its own f32 noise the update is decided by the noise and can differ
  by up to ~lr. So: tensors whose exact gradient is zero (their computed
  one is < 1e-6) within 1e-2, the bound of three updates; in the other
  tensors, all but 5e-4 of the elements within 2e-6 and none beyond 5e-4
  (measured: 53-84 elements of 690k beyond 2e-6, at most 8.8e-5). A wrong
  schedule, clip, bias correction or EMA moves every param by ~lr; the
  weight decay (0.5 here) by lr * 0.5 * |p| ~ 1e-4 a step.
* Resume: bit-equal, the same ops on the same device in the same order.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from itsd_tpu.core.process import diffusion_train_terms as jax_train_terms
from itsd_tpu.core.process import loss_reduce as jax_loss_reduce
from itsd_tpu.core.process import min_snr_weight as jax_min_snr_weight
from itsd_tpu.core.schedules import linear_schedule as jax_linear_schedule
from itsd_tpu.data import datasets as jax_datasets
from itsd_tpu.kernels.attention import _attention_flash_bwd, _attention_xla
from itsd_tpu.kernels.groupnorm import groupnorm_swish_xla
from itsd_tpu.kernels.ring_attention import _attention_xla_stats
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.train import OptimizerConfig as JaxOptimizerConfig
from itsd_tpu.train import create_train_state as jax_create_train_state
from itsd_tpu.train import make_optimizer as jax_make_optimizer
from itsd_tpu.train import make_train_step as jax_make_train_step
from itsd_tpu.train.schedule import \
    warmup_cosine_epochs as jax_warmup_cosine_epochs
from itsd_tpu_torch.cli import main as cli_main
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.core import (diffusion_train_terms, linear_schedule,
                                 loss_reduce, min_snr_weight)
from itsd_tpu_torch.data import datasets
from itsd_tpu_torch.kernels import attention, groupnorm
from itsd_tpu_torch.models import UNet, params_from_jax, uncond_unet_config
from itsd_tpu_torch.models.unet import dropout
from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                  make_optimizer, make_train_step,
                                  warmup_cosine_epochs)
from itsd_tpu_torch.train import checkpoint
from itsd_tpu_torch.train.loop import clip_by_global_norm_
from itsd_tpu_torch.train.trainer import Trainer
from itsd_tpu_torch.utils import load_config

from _torch_port import flax_params, one_torch_thread  # noqa: F401

F32_TOL = 2e-5
TINY = ["channel=16", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
        "T=10", "img_size=8", "train.eval_batch_size=2",
        "data.dataset=shapes", "train.track_metrics=false",
        "train.batch_size=4", "data.use_full_dataset=false",
        "data.train_subset_ratio=0.005"]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# attention backward


def test_attention_bwd_plain_matches_pallas_bwd_interpret():
    q, k, v, do = _arrays(0, *[(1, 128, 128)] * 4)
    scale = 128 ** -0.5
    o, lse = attention.attention_plain_stats(*_t(q, k, v), scale)
    want = _attention_flash_bwd(*map(jnp.asarray, (q, k, v, o.numpy())),
                                jnp.asarray(lse.numpy())[..., None],
                                jnp.asarray(do), scale, block_q=64,
                                block_k=64, interpret=True)
    got = attention.attention_bwd_plain(*_t(q, k, v), o, lse, *_t(do),
                                        scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=0)


@pytest.mark.parametrize("with_dlse", [False, True])
def test_attention_bwd_plain_matches_jax_vjp(with_dlse):
    q, k, v, do = _arrays(1, *[(2, 48, 32)] * 4)
    (dlse,) = _arrays(2, (2, 48))
    scale = 32 ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    (o, lse), vjp = jax.vjp(lambda q, k, v: _attention_xla_stats(q, k, v,
                                                                 scale),
                            jq, jk, jv)
    want = vjp((jnp.asarray(do), jnp.asarray(dlse if with_dlse
                                             else np.zeros_like(dlse))[
                                                 ..., None]))
    got = attention.attention_bwd_plain(
        *_t(q, k, v, o, np.asarray(lse)[..., 0], do), scale,
        torch.from_numpy(dlse) if with_dlse else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=0)


def test_flash_attention_autograd_matches_jax_vjp():
    q, k, v, do = _arrays(3, *[(2, 40, 16)] * 4)
    scale = 16 ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: _attention_xla(q, k, v, scale),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = attention.spatial_attention(tq, tk, tv)
    o.backward(torch.from_numpy(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=0)


def test_flash_attention_lse_output_is_differentiable():
    q, k, v, do = _arrays(4, *[(1, 24, 8)] * 4)
    (dlse,) = _arrays(5, (1, 24))
    _, vjp = jax.vjp(lambda q, k, v: _attention_xla_stats(q, k, v, 0.5),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)[..., None]))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o, lse = attention.flash_attention(tq, tk, tv, 0.5)
    torch.autograd.backward((o, lse), _t(do, dlse))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# GroupNorm backward


@pytest.mark.parametrize("act", [True, False])
def test_groupnorm_autograd_matches_jax_vjp(act):
    x, gy = _arrays(6, (2, 4, 4, 64), (2, 4, 4, 64))
    x = x * 2 + 0.5
    scale = (1 + 0.1 * _arrays(7, (64,))[0]).astype(np.float32)
    bias = (0.1 * _arrays(8, (64,))[0]).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s, b: groupnorm_swish_xla(x, s, b, 32, act=act),
                     *map(jnp.asarray, (x, scale, bias)))
    wx, ws, wb = vjp(jnp.asarray(gy))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.transpose(0, 3, 1, 2)))
    tx = nchw(x).requires_grad_()
    ts, tb = (t.requires_grad_() for t in _t(scale, bias))
    y = groupnorm.groupnorm_swish(tx, ts, tb, 32, act=act)
    y.backward(nchw(gy))
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(wx), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ws), atol=1e-4,
                               rtol=0)  # sums over 32 values of O(1)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(wb), atol=1e-4,
                               rtol=0)


def test_groupnorm_grads_come_back_in_param_and_input_dtypes():
    x = torch.randn(2, 32, 4, 4).bfloat16().requires_grad_()
    w = torch.ones(32, requires_grad=True)
    b = torch.zeros(32, requires_grad=True)
    groupnorm.groupnorm_swish(x, w, b, 8).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert w.grad.dtype == b.grad.dtype == torch.float32


# ---------------------------------------------------------------------------
# diffusion terms and the schedule


def test_train_terms_min_snr_and_loss_reduce_match_jax():
    jsched = jax_linear_schedule(1e-4, 0.02, 100)
    sched = linear_schedule(1e-4, 0.02, 100, device="cpu")
    (x0,) = _arrays(9, (3, 4, 4, 3))
    t, noise, x_t = jax_train_terms(jsched, jax.random.PRNGKey(1),
                                    jnp.asarray(x0))
    got_t, got_noise, got = diffusion_train_terms(
        sched, None, *_t(x0), *_t(t, noise))
    assert torch.equal(got_t, torch.from_numpy(np.asarray(t)))
    assert torch.equal(got_noise, torch.from_numpy(np.asarray(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(x_t), atol=1e-6,
                               rtol=0)
    ts = np.array([0, 1, 5, 50, 99], np.int32)
    np.testing.assert_allclose(
        min_snr_weight(sched, torch.from_numpy(ts).long(), 5.0).numpy(),
        np.asarray(jax_min_snr_weight(jsched, jnp.asarray(ts), 5.0)),
        rtol=1e-6)
    (loss,) = _arrays(10, (3, 4, 4, 3))
    for mode in ("mean", "sum_div_b2"):
        np.testing.assert_allclose(
            loss_reduce(torch.from_numpy(loss), mode).item(),
            float(jax_loss_reduce(jnp.asarray(loss), mode)), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown loss reduction"):
        loss_reduce(torch.from_numpy(loss), "max")


def test_train_terms_draw_from_the_generator():
    sched = linear_schedule(1e-4, 0.02, 100, device="cpu")
    x0 = torch.zeros(4, 2, 2, 3)
    a = diffusion_train_terms(sched, torch.Generator().manual_seed(3), x0)
    b = diffusion_train_terms(sched, torch.Generator().manual_seed(3), x0)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].min() >= 0 and a[0].max() < 100


def test_warmup_cosine_matches_jax_over_three_epochs():
    for args in ((2e-4, 2.0, 3, 1, 4), (1e-3, 1.5, 3, 0, 2)):
        want = jax_warmup_cosine_epochs(*args)
        got = warmup_cosine_epochs(*args)
        steps = range(3 * args[-1] + 2)
        np.testing.assert_allclose([got(s) for s in steps],
                                   [float(want(s)) for s in steps],
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step


SMALL = dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
             dropout=0.0)


def _jax_run(weighting, params, x0, steps, opt):
    jm = JaxUNet(jax_uncond_config(dtype="float32", **SMALL))
    jsched = jax_linear_schedule(1e-4, 0.02, 100)
    tx = jax_make_optimizer(JaxOptimizerConfig(**opt))
    state = jax_create_train_state(params, tx)
    step = jax_make_train_step(lambda p, *a, **kw: jm.apply(p, *a, **kw),
                               jsched, tx, loss_weighting=weighting,
                               ema_decay=0.999, donate=False)
    out = []
    for i in range(steps):
        key = jax.random.PRNGKey(100 + i)
        _, tkey, _ = jax.random.split(key, 3)
        t, noise, _ = jax_train_terms(jsched, tkey, jnp.asarray(x0))
        state, m = step(state, {"image": jnp.asarray(x0)}, key)
        out.append((np.asarray(t), np.asarray(noise), float(m["loss"]),
                    float(m["grad_norm"])))
    return state, out


# weight decay large enough that its part of an update (lr * wd * |p|)
# shows above the params' tolerance
OPT = dict(lr=1e-3, weight_decay=0.5, grad_clip=1.0, multiplier=2.0,
           epochs=3, steps_per_epoch=1)


def _port_state(params):
    model = UNet(uncond_unet_config(dtype="float32", **SMALL))
    model.load_state_dict(params_from_jax(params, model.cfg))
    tx = make_optimizer(OptimizerConfig(**OPT), model.parameters())
    return create_train_state(model, tx)


PARAM_TOL, PARAM_OUTLIERS, PARAM_MAX, NOISE_MAX = 2e-6, 5e-4, 5e-4, 1e-2


@pytest.mark.parametrize("weighting", ["none", "min_snr"])
def test_three_train_steps_match_jax(weighting):
    (x0,) = _arrays(11, (2, 16, 16, 3))
    jm = JaxUNet(jax_uncond_config(dtype="float32", **SMALL))
    params = flax_params(jm, x0, np.zeros(2, np.int32), seed=12)
    jstate, jout = _jax_run(weighting, params, x0, 3, OPT)

    state = _port_state(params)
    step = make_train_step(linear_schedule(1e-4, 0.02, 100, device="cpu"),
                           loss_weighting=weighting, ema_decay=0.999)
    for t, noise, loss, gnorm in jout:
        m = step(state, {"image": torch.from_numpy(x0)}, None,
                 *_t(t, noise))
        np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), gnorm, rtol=1e-5)
    assert state.step == 3
    cfg = state.model.cfg
    # tensors whose gradient is zero in exact arithmetic, so f32 noise
    # (~1e-9 here, against >= 3e-4 for every other tensor): attention's k
    # bias (softmax is shift-invariant) and per-channel constants that a
    # GroupNorm with one channel a group removes (stage 0 at ch 32)
    noise = {k for k, p in state.model.named_parameters()
             if p.grad.abs().max().item() < 1e-6}
    assert any(k.endswith("attn.k.bias") for k in noise)
    for got, want in ((state.model.state_dict(), jstate.params),
                      (state.ema, jstate.ema_params)):
        want = params_from_jax(jax.device_get(want), cfg)
        diff = {k: (got[k].detach() - w).abs().flatten()
                for k, w in want.items()}
        real = torch.cat([d for k, d in diff.items() if k not in noise])
        assert (real > PARAM_TOL).float().mean().item() <= PARAM_OUTLIERS
        assert real.max().item() <= PARAM_MAX
        assert max(diff[k].max().item() for k in noise) <= NOISE_MAX


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    grads = [jnp.asarray(g * scale)
             for g in _arrays(13, (5, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    tg = [torch.tensor(np.asarray(g)) for g in grads]
    norm = clip_by_global_norm_(tg, 1.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)),
                               rtol=1e-6)
    assert (norm.item() > 1.0) == (scale > 1)
    for g, w in zip(tg, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_dropout_keeps_and_scales_as_flax():
    h = torch.ones(4000)
    out = dropout(h, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0.7 < kept.float().mean().item() < 0.8
    assert torch.all(out[kept] == 1 / 0.75)
    assert dropout(h, 0.0, None) is h


def test_unet_dropout_only_in_train_mode_when_asked():
    model = UNet(uncond_unet_config(ch=16, ch_mult=(1,), attn=(),
                                    num_res_blocks=1, dropout=0.5))
    model.init_weights(torch.Generator().manual_seed(0))
    for k, v in model.state_dict().items():
        if k.endswith("conv2.weight"):
            v.normal_(0, 0.1)  # let the dropped branch move the output
    x, t = torch.randn(2, 8, 8, 3), torch.tensor([1, 2])
    with torch.no_grad():
        base = model(x, t)
        assert not torch.equal(model(x, t, deterministic=False), base)
        model.eval()
        assert torch.equal(model(x, t, deterministic=False), base)
        model.train()
        gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
        assert torch.equal(model(x, t, deterministic=False, generator=gen()),
                           model(x, t, deterministic=False, generator=gen()))


# ---------------------------------------------------------------------------
# checkpoints


def _tiny_state():
    model = UNet(uncond_unet_config(ch=16, ch_mult=(1, 2), attn=(1,),
                                    num_res_blocks=1, dropout=0.1))
    model.init_weights(torch.Generator().manual_seed(0))
    tx = make_optimizer(OptimizerConfig(lr=1e-3, epochs=4,
                                        steps_per_epoch=2),
                        model.parameters())
    return create_train_state(model, tx)


def test_resume_equals_straight_run(tmp_path):
    step = make_train_step(linear_schedule(1e-4, 0.02, 50, device="cpu"),
                           loss_weighting="min_snr")
    batches = [{"image": torch.randn(2, 8, 8, 3,
                                     generator=torch.Generator()
                                     .manual_seed(i))} for i in range(4)]
    gen = torch.Generator().manual_seed(9)

    straight = _tiny_state()
    for b in batches[:2]:
        step(straight, b, gen)
    checkpoint.save_checkpoint(str(tmp_path / "c"), straight)
    gen_state = gen.get_state()
    for b in batches[2:]:
        step(straight, b, gen)

    resumed = checkpoint.restore_checkpoint(str(tmp_path / "c"),
                                            _tiny_state())
    assert resumed.step == 2
    gen.set_state(gen_state)
    for b in batches[2:]:
        step(resumed, b, gen)
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(straight.ema.values(), resumed.ema.values()):
        assert torch.equal(a, b)
    assert (straight.tx.optimizer.param_groups[0]["lr"]
            == resumed.tx.optimizer.param_groups[0]["lr"])


def test_async_manager_writes_and_eval_loads_both_layouts(tmp_path):
    state = _tiny_state()
    mgr = checkpoint.AsyncCheckpointManager()
    mgr.save(str(tmp_path / "full"), state)
    mgr.close()
    checkpoint.save_params(str(tmp_path / "weights"),
                           state.model.state_dict())
    full = checkpoint.restore_checkpoint(str(tmp_path / "full"))
    assert full["step"] == 0 and set(full) == set(checkpoint.FULL_KEYS)
    cfg = load_config(None, [f"save_weight_dir={tmp_path}"])
    for name in ("full", "weights"):
        got = runner.load_eval_params(cfg, name)
        for k, v in state.model.state_dict().items():
            assert torch.equal(got[k], v), (name, k)
    with pytest.raises(KeyError, match="not a full training checkpoint"):
        checkpoint.restore_checkpoint(str(tmp_path / "weights"))


def test_async_manager_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    mgr = checkpoint.AsyncCheckpointManager()
    mgr.save(str(blocker / "sub" / "c"), _tiny_state())
    with pytest.raises(OSError):
        mgr.wait()


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("name", ["shapes_dataset", "synthetic_dataset"])
def test_datasets_match_jax(name):
    got = getattr(datasets, name)(n=12, img_size=16, seed=3)
    want = getattr(jax_datasets, name)(n=12, img_size=16, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_iterator_matches_jax():
    imgs, labels = datasets.synthetic_dataset(n=10, img_size=8, seed=1)
    kw = dict(batch_size=3, seed=4)
    got = list(datasets.BatchIterator(imgs, labels, **kw))
    want = list(jax_datasets.BatchIterator(imgs, labels, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
    assert len(datasets.BatchIterator(imgs, None, 3,
                                      drop_remainder=False)) == 4


@pytest.mark.parametrize("prefetch", ["prefetch_to_device",
                                      "threaded_prefetch"])
def test_prefetch_keeps_order_and_raises_producer_errors(prefetch):
    fn = getattr(datasets, prefetch)
    src = [{"image": np.full((1,), i, np.float32)} for i in range(5)]
    got = [b["image"].item() for b in fn(iter(src), size=2, device="cpu")]
    assert got == [0, 1, 2, 3, 4]

    def broken():
        yield src[0]
        raise RuntimeError("bad batch")

    with pytest.raises(RuntimeError, match="bad batch"):
        list(fn(broken(), size=2, device="cpu"))


def test_dataset_loaders_that_read_files_are_not_ported(tmp_path):
    """The image folder (it needs Pillow) is not ported; load_cifar10 is,
    and says where it looked when the batches are not there."""
    with pytest.raises(FileNotFoundError, match="CIFAR-10 not found"):
        datasets.load_cifar10(str(tmp_path / "none"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        datasets.load_image_folder("./images")


def test_load_cifar10_matches_jax_on_synthesized_batches(tmp_path):
    """The cifar-10-batches-py pickles (synthesized: no CIFAR-10 is in
    the repository), in the directory and as the .tar.gz, read as JAX's
    load_cifar10 reads them: equal arrays."""
    import pickle
    import tarfile

    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(0)
    for name, n in [(f"data_batch_{i}", 20) for i in range(1, 6)] + [
            ("test_batch", 10)]:
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             b"labels": rng.integers(0, 10, n).tolist()}
        with open(base / name, "wb") as f:
            pickle.dump(d, f)
    for kw in ({}, {"train": False}, {"subset_ratio": 0.5, "seed": 3}):
        x, y = datasets.load_cifar10(str(tmp_path), **kw)
        jx, jy = jax_datasets.load_cifar10(str(tmp_path), **kw)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == np.float32 and y.dtype == np.int32
    assert x.shape == (50, 32, 32, 3) and -1 <= x.min() <= x.max() <= 1
    tgz_root = tmp_path / "tgz"
    tgz_root.mkdir()
    with tarfile.open(tgz_root / "cifar-10-python.tar.gz", "w:gz") as tf:
        tf.add(base, arcname="cifar-10-batches-py")
    x3, _ = datasets.load_cifar10(str(tgz_root))
    assert x3.shape == (100, 32, 32, 3)


# ---------------------------------------------------------------------------
# runner, trainer and CLI


def _cfg(tmp_path, *extra):
    return load_config(None, TINY + [
        f"save_weight_dir={tmp_path}/ckpt", f"sampled_dir={tmp_path}/s",
        f"metrics_save_dir={tmp_path}/m", *extra])


def test_train_on_cpu_writes_checkpoints_metrics_and_grids(tmp_path):
    cfg = _cfg(tmp_path, "train.epoch=2", "train.model_save_freq=1",
               "train.eval_freq=1", "train.async_checkpoint=false")
    out = runner.train(cfg, max_steps=4, device="cpu")
    assert out["steps"] == 4 and len(out["losses"]) == 4
    assert np.isfinite(out["losses"]).all()
    assert out["checkpoints"] == [str(tmp_path / "ckpt" / f"ckpt_{e}")
                                  for e in (0, 1)]
    for e in (0, 1):
        assert (tmp_path / "s" / f"epoch_{e}_sampled.png").is_file()
    records = [json.loads(line) for line in
               (tmp_path / "m" / "train_metrics.jsonl").read_text()
               .splitlines()]
    steps = [r for r in records if "grad_norm" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert [r["loss"] for r in steps] == out["losses"]
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    full = checkpoint.restore_checkpoint(out["checkpoints"][-1])
    assert full["step"] == 4
    ev = runner.evaluate(load_config(None, TINY + [
        f"save_weight_dir={tmp_path}/ckpt", "test_load_weight=ckpt_1",
        f"sampled_dir={tmp_path}/ev"]), device="cpu")
    assert np.isfinite(ev["images"]).all()


@pytest.mark.parametrize("time_embed", ["table", "functional"])
def test_cond_train_on_cpu_carries_labels_and_samples_guided_grids(
        tmp_path, time_embed, monkeypatch):
    """The conditional train loop: the dataset's labels reach the step with
    the images (through the producer thread), the loss is the sum / B^2
    reduction, a guided grid is sampled, and the checkpoint restores for a
    guided eval."""
    seen = []
    real = make_train_step

    def spy(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, *rest):
            seen.append(batch["label"].clone())
            return step(state, batch, *rest)
        return wrapped

    monkeypatch.setattr(runner, "make_train_step", spy)
    cfg = _cfg(tmp_path, "model.num_labels=10", f"model.time_embed={time_embed}",
               "train.loss_reduction=sum_div_b2", "w=1.8", "train.epoch=1",
               "train.eval_freq=1", "train.async_checkpoint=false")
    out = runner.train(cfg, max_steps=2, device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert len(seen) == 2 and all(s.shape == (4,) and int(s.max()) < 10
                                  for s in seen)
    assert out["losses"][0] > 1.0  # sum / B^2 = 8*8*3/4 times the mean
    assert (tmp_path / "s" / "epoch_0_sampled.png").is_file()
    ev = runner.evaluate(_cfg(tmp_path, "model.num_labels=10",
                              f"model.time_embed={time_embed}", "w=1.8",
                              "test_load_weight=ckpt_0",
                              f"sampled_dir={tmp_path}/ev"), device="cpu")
    assert np.isfinite(ev["images"]).all()


@pytest.mark.parametrize("override", [
    "train.track_metrics=none", "train.spatial_shard=2",
    "train.profile_steps=1",
    "train.extract_representation_freq=1", "data.dataset=cifar10",
    "data.dataset=imagefolder"])
def test_unported_train_options_raise(tmp_path, override, monkeypatch):
    """What is not ported raises "not yet ported". Tracked metrics (on by
    default, "none") are ported and train; CIFAR-10 is read from disk and
    raises FileNotFoundError when it is not there."""
    monkeypatch.setenv("ITSD_PIXEL_FEATURES", "1")
    cfg = _cfg(tmp_path, override, f"data.root={tmp_path}/none")
    if override == "train.track_metrics=none":
        assert runner.resolve_track_metrics(cfg)
        assert runner.train(cfg, max_steps=1, device="cpu")["steps"] == 1
        return
    error, match = ((FileNotFoundError, "CIFAR-10 not found")
                    if override == "data.dataset=cifar10"
                    else (NotImplementedError, "not yet ported"))
    with pytest.raises(error, match=match):
        runner.train(cfg, max_steps=1, device="cpu")


def test_finetune_t_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        runner.finetune_extended_T(_cfg(tmp_path), device="cpu")


def test_trainer_fit_sample_save_load(tmp_path):
    cfg = _cfg(tmp_path, "train.epoch=1", "train.eval_freq=5")
    tr = Trainer(cfg, device="cpu")
    tr.fit(max_steps=2)
    imgs = tr.sample(2)
    assert imgs.shape == (2, 8, 8, 3) and np.isfinite(imgs).all()
    path = tr.save("again")
    other = Trainer(cfg, device="cpu")
    other.load("again")
    assert other.state.step == 2
    for k, v in tr.params.items():
        assert torch.equal(other.params[k], v)
    np.testing.assert_array_equal(other.sample(2), imgs)
    assert path.endswith("again")
    # search runs on the trainer's weights (the EMA), as sampling does
    out = tr.search()
    res = out["result"]
    assert out["nfes"] == 4 and np.isfinite(out["best_score"])
    assert res.best_images.shape == (2, 8, 8, 3)
    assert out["best_score"] == float(np.nanmax(res.history["scores"]))
    assert (tmp_path / "s" / "search_random_best.png").is_file()


def test_cli_train_on_cpu(tmp_path, capsys):
    rc = cli_main.main(["train", "--device", "cpu", *TINY, "train.epoch=1",
                        "train.eval_freq=5",
                        f"save_weight_dir={tmp_path}/ckpt",
                        f"sampled_dir={tmp_path}/s",
                        f"metrics_save_dir={tmp_path}/m"])
    assert rc == 0
    assert "final loss:" in capsys.readouterr().out
    assert (tmp_path / "ckpt" / "ckpt_0").is_file()
    rc = cli_main.main(["train", "--device", "cpu", *TINY,
                        "train.spatial_shard=2"])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err
