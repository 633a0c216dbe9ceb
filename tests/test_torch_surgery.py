"""The cross-T surgery, the T-extension fine-tune and the reference
checkpoint loader of the port against the JAX package.

Inputs come from numpy seeds. JAX's t, noise and label-dropout masks
(which torch cannot draw from a threefry key) are fed through the port's
train step (``make_train_step``'s t, noise and drop). Both sides run in
f32 on the CPU.

Tolerances:
* ``detect_checkpoint_T`` and ``extend_time_embedding`` "interpolate":
  exact, the same float64 numpy arithmetic on both sides. "reinit" is
  each package's float32 sinusoid table: exactly the port's, and JAX's
  within one float32 spacing of the largest sin argument, T - 1 (torch
  and XLA round the frequencies and their products with t apart by an
  ulp: measured 6.1e-5 at T=2000, d=128; 6e-8 at d=16).
* The frozen fine-tune step and the 2-step ``finetune_extended_T`` (lr
  1e-3, tiny conditional table UNet, T=16 extended to 32): the loss to
  1e-5 relative (f32 sums in another order); the frozen parameters bit
  for bit, on both sides equal to the loaded ones; the time embedding as
  in ``tests/test_torch_train.py``: all but 5e-4 of its elements within
  2e-6 and none beyond 5e-4 (Adam's update is ~lr whatever the
  gradient's size, so an element whose gradient is at its f32 noise level
  can move differently).
* ``artifacts/shapes64_cond`` at T=2000: 1e-5 absolute on eps, as its
  forward at T=1000 in ``tests/test_torch_artifacts.py`` (conv and matmul
  sums in another order; measured ~1e-6).
* The reference loader: the same weights in both frameworks, 1e-5
  absolute on eps O(1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.cli import runner as jax_runner
from itsd_tpu.core.process import diffusion_train_terms as jax_train_terms
from itsd_tpu.core.schedules import linear_schedule as jax_linear_schedule
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.models.embeddings import sinusoidal_features as jax_sinusoids
from itsd_tpu.models.torch_convert import \
    convert_reference_unet as jax_convert_reference_unet
from itsd_tpu.train import OptimizerConfig as JaxOptimizerConfig
from itsd_tpu.train import create_train_state as jax_create_train_state
from itsd_tpu.train import make_optimizer as jax_make_optimizer
from itsd_tpu.train import make_train_step as jax_make_train_step
from itsd_tpu.train import surgery as jax_surgery
from itsd_tpu.train.checkpoint import restore_params as jax_restore_params
from itsd_tpu.train.checkpoint import save_params as jax_save_params
from itsd_tpu.utils import load_config as jax_load_config
from itsd_tpu_torch.cli import main as cli_main
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.core import linear_schedule
from itsd_tpu_torch.models import (UNet, cond_unet_config, params_from_jax,
                                   uncond_unet_config)
from itsd_tpu_torch.models import torch_convert
from itsd_tpu_torch.models.convert import expected_shapes
from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                  make_optimizer, make_train_step, surgery)
from itsd_tpu_torch.train.checkpoint import restore_params, save_params
from itsd_tpu_torch.train.trainer import Trainer
from itsd_tpu_torch.utils import load_config

from _torch_port import (flax_params, jax_train_draws,  # noqa: F401
                         one_torch_thread)

ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "artifacts", "shapes64_cond")
# ch 32: at stage 1 (64 channels) a GroupNorm group holds 2 channels, so
# the time embedding, a per-channel constant, is not normalised away (at
# one channel a group it would have no effect and a zero gradient)
SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0,
             num_labels=10)
PARAM_TOL, PARAM_OUTLIERS, PARAM_MAX = 2e-6, 5e-4, 5e-4


def _table_tree(seed=0, T=16, d=16):
    rng = np.random.default_rng(seed)
    return {"params": {"time_embedding": {
        "table": rng.standard_normal((T, d)).astype(np.float32),
        "mlp": {"fc1": {"kernel": rng.standard_normal((d, 4 * d)).astype(
            np.float32)}}}}}


def _state_dict(tree):
    p = tree["params"]["time_embedding"]
    return {"time_embedding.table": torch.from_numpy(np.asarray(p["table"])),
            "time_embedding.mlp.fc1.weight": torch.from_numpy(
                np.asarray(p["mlp"]["fc1"]["kernel"]).T.copy())}


@pytest.mark.parametrize("new_T,strategy", [
    (32, "interpolate"), (2000, "interpolate"), (9, "interpolate"),
    (32, "reinit"), (2000, "reinit")])
def test_extend_time_embedding_matches_jax_exactly(new_T, strategy):
    tree = _table_tree()
    sd = _state_dict(tree)
    assert surgery.detect_checkpoint_T(sd) == 16
    assert jax_surgery.detect_checkpoint_T(tree) == 16
    got = surgery.extend_time_embedding(sd, new_T, strategy)
    want = jax_surgery.extend_time_embedding(tree, new_T, strategy)
    want_table = np.asarray(want["params"]["time_embedding"]["table"])
    assert got["time_embedding.table"].shape == (new_T, 16)
    if strategy == "interpolate":
        np.testing.assert_array_equal(got["time_embedding.table"].numpy(),
                                      want_table)
    else:
        np.testing.assert_allclose(
            got["time_embedding.table"].numpy(), want_table, rtol=0,
            atol=float(np.spacing(np.float32(new_T - 1))))
    # the MLP is kept, the input is not modified
    assert got["time_embedding.mlp.fc1.weight"] is sd[
        "time_embedding.mlp.fc1.weight"]
    assert sd["time_embedding.table"].shape == (16, 16)
    if strategy == "interpolate":
        np.testing.assert_array_equal(got["time_embedding.table"][0],
                                      sd["time_embedding.table"][0])
        np.testing.assert_array_equal(got["time_embedding.table"][-1],
                                      sd["time_embedding.table"][-1])


def test_extend_leaves_functional_and_same_T_alone():
    sd = _state_dict(_table_tree())
    assert surgery.extend_time_embedding(sd, 16) is sd
    functional = {"time_embedding.mlp.fc1.weight": torch.zeros(2, 2)}
    assert surgery.detect_checkpoint_T(functional) is None
    assert surgery.extend_time_embedding(functional, 99) is functional
    with pytest.raises(ValueError, match="unknown strategy"):
        surgery.extend_time_embedding(sd, 32, "nearest")


def test_reinit_table_is_the_port_sinusoid_table():
    from itsd_tpu_torch.models import sinusoidal_features

    sd = surgery.extend_time_embedding(_state_dict(_table_tree()), 2000,
                                       "reinit")
    assert torch.equal(sd["time_embedding.table"],
                       sinusoidal_features(torch.arange(2000), 16))


def _jax_cond(T):
    return JaxUNet(jax_cond_config(attention_impl="xla", T=T, **SMALL))


def _start_params(T=16):
    """JAX params of the tiny conditional table UNet at ``T``."""
    x = np.zeros((2, 8, 8, 3), np.float32)
    return flax_params(_jax_cond(T), x, np.zeros(2, np.int32), 31,
                       np.array([1, 2], np.int32))


def test_time_embedding_mask_matches_jax():
    params = _start_params()
    model = UNet(cond_unet_config(T=16, **SMALL))
    got = surgery.time_embedding_mask(model)
    want = {}
    for path, m in jax.tree_util.tree_flatten_with_path(
            jax_surgery.time_embedding_mask(params))[0]:
        want["/".join(k.key for k in path[1:])] = m
    assert sum(got.values()) == sum(want.values()) == 5
    assert {k for k, v in got.items() if v} == {
        "time_embedding.table", "time_embedding.mlp.fc1.weight",
        "time_embedding.mlp.fc1.bias", "time_embedding.mlp.fc2.weight",
        "time_embedding.mlp.fc2.bias"}
    assert {k for k, v in want.items() if v} == {
        "time_embedding/table", "time_embedding/mlp/fc1/kernel",
        "time_embedding/mlp/fc1/bias", "time_embedding/mlp/fc2/kernel",
        "time_embedding/mlp/fc2/bias"}
    trained = surgery.freeze_except_time_embedding(model)
    assert [p.requires_grad for p in model.parameters()] == list(
        got.values())
    assert len(trained) == 5


def _close_time_embedding(got, want):
    """Every time-embedding tensor against JAX's, to the statistic of the
    module docstring."""
    diff = torch.cat([(got[k].detach() - want[k]).abs().flatten()
                      for k in got if k.startswith("time_embedding.")])
    assert (diff > PARAM_TOL).float().mean().item() <= PARAM_OUTLIERS
    assert diff.max().item() <= PARAM_MAX


OPT = dict(lr=1e-3, weight_decay=0.5, grad_clip=1.0, multiplier=2.0,
           epochs=3, steps_per_epoch=1)


def test_one_frozen_step_matches_jax():
    """One step of the frozen fine-tune: JAX's optax mask against the
    port's frozen parameters and optimizer over the time embedding; the
    table extended from T=16 to 32 on both sides first."""
    params = _start_params()
    jparams = jax_surgery.extend_time_embedding(params, 32)
    jm = _jax_cond(32)
    jsched = jax_linear_schedule(1e-4, 0.02, 32)
    tx = jax_surgery.freeze_except_time_embedding(
        jax_make_optimizer(JaxOptimizerConfig(ema_decay=None, **OPT)),
        jparams)
    jstate = jax_create_train_state(jparams, tx, ema=False)
    jstep = jax_make_train_step(
        lambda p, *a, **kw: jm.apply(p, *a, **kw), jsched, tx,
        conditional=True, label_dropout=0.3, ema_decay=None, donate=False)
    x0 = np.random.default_rng(5).standard_normal((4, 8, 8, 3)).astype(
        np.float32)
    raw = np.array([0, 3, 9, 4], np.int32)
    key = jax.random.PRNGKey(7)
    _, tkey, lkey = jax.random.split(key, 3)
    t, noise, _ = jax_train_terms(jsched, tkey, jnp.asarray(x0))
    drop = np.asarray(jax.random.uniform(lkey, raw.shape) < 0.3)
    jstate, m = jstep(jstate, {"image": jnp.asarray(x0),
                               "label": jnp.asarray(raw)}, key)

    model = UNet(cond_unet_config(T=32, **SMALL))
    start = surgery.extend_time_embedding(
        params_from_jax(params, cond_unet_config(T=16, **SMALL)), 32)
    model.load_state_dict(start)
    tx = make_optimizer(OptimizerConfig(ema_decay=None, **OPT),
                        surgery.freeze_except_time_embedding(model))
    state = create_train_state(model, tx, ema=False)
    step = make_train_step(linear_schedule(1e-4, 0.02, 32, device="cpu"),
                           conditional=True, label_dropout=0.3,
                           ema_decay=None)
    got = step(state, {"image": torch.from_numpy(x0),
                       "label": torch.from_numpy(raw)}, None,
               torch.from_numpy(np.array(t)).long(),
               torch.from_numpy(np.array(noise)),
               torch.from_numpy(drop.copy()))
    np.testing.assert_allclose(got["loss"].item(), float(m["loss"]),
                               rtol=1e-5)
    assert state.ema is None
    want = params_from_jax(jax.device_get(jstate.params), model.cfg)
    moved = 0
    for k, v in model.state_dict().items():
        if k.startswith("time_embedding."):
            moved += not torch.equal(v, start[k])
        else:
            assert torch.equal(v, start[k]), k
            assert torch.equal(v, want[k]), k
    assert moved == 5
    _close_time_embedding(model.state_dict(), want)


KEYS = ["channel=32", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
        "dropout=0.0", "img_size=8", "model.num_labels=10",
        "model.time_embed=table", "data.dataset=shapes",
        "data.use_full_dataset=false", "data.train_subset_ratio=0.005",
        "train.batch_size=4", "train.fine_tune_lr=1e-3", "train.epoch=1",
        "train.label_dropout=0.3", "train.track_metrics=false",
        "test_load_weight=t16"]


def test_two_step_finetune_matches_jax(tmp_path, monkeypatch):
    """``finetune_extended_T`` from a weights-only T=16 checkpoint to
    T=32, two steps, against JAX's: the same batches, JAX's t, noise and
    label-dropout masks fed to the port's step."""
    params = _start_params()
    jcfg = jax_load_config(None, KEYS + [
        "T=32", f"save_weight_dir={tmp_path}/jax"])
    jax_save_params(os.path.join(jcfg.save_weight_dir, "t16"), params)
    jout = jax_runner.finetune_extended_T(jcfg, max_steps=2)

    draws = jax_train_draws(jcfg, 2, 0.3)

    real = runner.make_train_step

    def injected(*a, **kw):
        step = real(*a, **kw)
        fed = iter(draws)

        def run(state, batch, generator):
            return step(state, batch, generator, *next(fed))
        return run

    monkeypatch.setattr(runner, "make_train_step", injected)
    cfg = load_config(None, KEYS + ["T=32", f"save_weight_dir={tmp_path}"])
    start = params_from_jax(params, cond_unet_config(T=16, **SMALL))
    torch.save(start, tmp_path / "t16")
    out = runner.finetune_extended_T(cfg, max_steps=2, device="cpu")
    assert out["steps"] == 2 and out["ckpt_T_detected"] == 16
    assert jout["ckpt_T_detected"] == 16
    np.testing.assert_allclose(out["final_loss"], jout["final_loss"],
                               rtol=1e-5)
    assert out["checkpoints"] == [str(tmp_path / "fine_tuned_T32_epoch_0")]
    state = out["state"]
    got = state.model.state_dict()
    want = params_from_jax(jax.device_get(jout["state"].params),
                           state.model.cfg)
    extended = surgery.extend_time_embedding(start, 32)
    for k, v in got.items():
        if not k.startswith("time_embedding."):
            assert torch.equal(v, extended[k]) and torch.equal(v, want[k]), k
    assert not torch.equal(got["time_embedding.table"],
                           extended["time_embedding.table"])
    _close_time_embedding(got, want)
    saved = restore_params(out["checkpoints"][0])
    assert saved.keys() == got.keys()
    assert all(torch.equal(saved[k], v) for k, v in got.items())


def test_finetune_cli_and_trainer_on_cpu(tmp_path, capsys):
    """``finetune-t`` through the CLI (from a full checkpoint, its EMA
    weights, "reinit") and ``Trainer.finetune_extended_T``; eval samples
    the fine-tuned checkpoint at T=32 and the T=16 one at inference_T=32
    (surgery at load)."""
    keys = KEYS + [f"save_weight_dir={tmp_path}",
                   f"metrics_save_dir={tmp_path}/m",
                   f"sampled_dir={tmp_path}/s"]
    tr = Trainer(load_config(None, keys + ["T=16", "train.epoch=1",
                                           "train.eval_freq=9"]),
                 device="cpu")
    tr.fit(max_steps=1)
    tr.save("t16")
    rc = cli_main.main(["finetune-t", "--device", "cpu", *keys, "T=32",
                        "train.epoch=2",
                        "train.time_embedding_strategy=reinit"])
    assert rc == 0
    assert "final loss:" in capsys.readouterr().out
    for e in (0, 1):
        sd = restore_params(str(tmp_path / f"fine_tuned_T32_epoch_{e}"))
        assert sd["time_embedding.table"].shape == (32, 32)
        frozen = {k: v for k, v in sd.items()
                  if not k.startswith("time_embedding.")}
        assert all(torch.equal(v, tr.params[k]) for k, v in frozen.items())
    out = Trainer(load_config(None, keys + ["T=32"]),
                  device="cpu").finetune_extended_T(max_steps=1)
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
    for extra in (["T=32", "test_load_weight=fine_tuned_T32_epoch_1"],
                  ["T=16", "diffusion.inference_T=32"]):
        imgs = runner.evaluate(load_config(None, keys + extra + [
            f"sampled_dir={tmp_path}/ev"]), device="cpu")["images"]
        assert imgs.shape == (4, 8, 8, 3) and np.isfinite(imgs).all()


def test_finetune_raises_on_spatial_shard(tmp_path, capsys):
    """train.spatial_shard does not apply to finetune-t: as JAX's, it
    prints a note and runs unsharded, with the result of the run without
    it."""
    cfg = load_config(None, KEYS + ["T=32", f"save_weight_dir={tmp_path}",
                                    "train.spatial_shard=2",
                                    "test_load_weight=w"])
    model, _ = runner.build_model(cfg)
    save_params(str(tmp_path / "w"), runner.init_params(cfg, model))
    got = runner.finetune_extended_T(cfg, max_steps=1, device="cpu")
    assert "not applied by finetune-t" in capsys.readouterr().out
    cfg.train.spatial_shard = 1
    want = runner.finetune_extended_T(cfg, max_steps=1, device="cpu")
    assert got["losses"] == want["losses"]


def test_jax_cross_T_eval_raises_where_the_port_samples(tmp_path):
    """JAX's fault (ROADMAP.md, Queue 3): a table checkpoint of T=32
    evaluated at inference_T=64. ``load_eval_params`` extends the table
    to 64 rows but ``build_model`` sizes it from diffusion.T, so JAX's
    evaluate raises ScopeParamShapeError; the port builds the sampling
    model with 64 rows and samples."""
    from flax.errors import ScopeParamShapeError

    keys = KEYS[:-1] + ["T=32", "train.eval_batch_size=2",
                        "test_load_weight=t32"]
    jcfg = jax_load_config(None, keys + [f"save_weight_dir={tmp_path}/jax"])
    jm, conditional = jax_runner.build_model(jcfg)
    jparams = jax_runner.init_params(jcfg, jm, conditional)
    jax_save_params(os.path.join(jcfg.save_weight_dir, "t32"), jparams)
    ecfg = jax_load_config(None, keys + [
        f"save_weight_dir={tmp_path}/jax", "diffusion.inference_T=64",
        f"sampled_dir={tmp_path}/jax_s"])
    loaded = jax_runner.load_eval_params(ecfg, jm, conditional)
    assert loaded["params"]["time_embedding"]["table"].shape == (64, 32)
    with pytest.raises(ScopeParamShapeError):
        jax_runner.evaluate(ecfg)

    cfg = load_config(None, keys + [f"save_weight_dir={tmp_path}"])
    model, _ = runner.build_model(cfg)
    torch.save(params_from_jax(jparams, model.cfg), tmp_path / "t32")
    out = runner.evaluate(load_config(None, keys + [
        f"save_weight_dir={tmp_path}", "diffusion.inference_T=64",
        f"sampled_dir={tmp_path}/s"]), device="cpu")
    assert out["images"].shape == (2, 8, 8, 3)
    assert np.isfinite(out["images"]).all()


def test_trained_shapes64_cond_forward_at_T2000_matches_jax():
    """``artifacts/shapes64_cond`` (trained at T=1000) as a table
    checkpoint, extended to T=2000 and run at t = 0, 1234, 1999 against
    JAX's UNet built at T=2000 with JAX's extended table. The artifact's
    embedding is functional, which is the table embedding whose table holds
    the sinusoids of 0..T-1: its table is built so, at T=1000, and its MLP
    kept."""
    import json

    with open(ARTIFACT + ".json") as f:
        a = json.load(f)["arch"]
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jax_restore_params(ARTIFACT))
    te = params["params"]["time_embedding"]
    te["table"] = np.asarray(jax_sinusoids(jnp.arange(1000), a["ch"]))
    arch = dict(ch=a["ch"], ch_mult=tuple(a["ch_mult"]),
                num_res_blocks=a["num_res_blocks"], dropout=a["dropout"],
                num_labels=a["num_labels"], time_embed="table")
    extended = jax_surgery.extend_time_embedding(params, 2000)
    jm = JaxUNet(jax_cond_config(attention_impl="xla", T=2000, **arch))

    cfg = load_config(None, [
        f"channel={a['ch']}", f"channel_mult={list(a['ch_mult'])}",
        f"num_res_blocks={a['num_res_blocks']}", f"dropout={a['dropout']}",
        f"model.num_labels={a['num_labels']}", "model.time_embed=table",
        "T=1000", "diffusion.inference_T=2000", "img_size=64"])
    model, _ = runner.build_model(cfg, inference=True)
    assert model.time_embedding.table.shape == (2000, a["ch"])
    runner.load_weights(cfg, model, params_from_jax(
        params, cond_unet_config(T=1000, **arch)))
    model.eval()

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    t = np.array([0, 1234, 1999], np.int32)
    labels = np.array([1, 0, 7], np.int32)
    want = np.asarray(jax.jit(jm.apply)(extended, jnp.asarray(x),
                                        jnp.asarray(t), jnp.asarray(labels)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, labels))).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the reference's PyTorch checkpoints


def _reference_state_dict(cfg, seed):
    """A synthesized state dict in the layout of the reference's UNet
    (``Diffusion/Model.py`` or ``ModelCondition.py``): the port's shapes
    under the reference's names, 1x1 convs as [out, in, 1, 1], with
    seeded values; plus a DataParallel prefix."""
    shapes = expected_shapes(cfg)
    rng = np.random.default_rng(seed)
    sd = {}
    mods = torch_convert.reference_modules(cfg)
    if cfg.time_embed == "table":
        mods = [("time_embedding.timembedding.0", "time_embedding", False)
                ] + mods
    if cfg.conditional:
        mods = [("cond_embedding.condEmbedding.0", "cond_embedding", False)
                ] + mods
    for ref, port, one_by_one in mods:
        for leaf in ("weight", "bias"):
            key = f"{port}.{leaf}"
            if port in ("time_embedding", "cond_embedding"):
                if leaf == "bias":
                    continue
                key = f"{port}.table"
            shape = shapes[key]
            if one_by_one and leaf == "weight":
                shape = shape + (1, 1)
            fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            sd[f"module.{ref}.{leaf}"] = torch.from_numpy(
                (rng.standard_normal(shape) / np.sqrt(fan)).astype(
                    np.float32))
    return sd


@pytest.mark.parametrize("which", ["uncond", "cond"])
def test_reference_checkpoint_loads_as_jax_converts_it(tmp_path, which):
    """A synthesized reference state dict through the port's
    ``load_reference_checkpoint`` and JAX's ``convert_reference_unet``:
    equal forwards; every tensor of the port's UNet is filled."""
    if which == "uncond":
        kw = dict(ch=16, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
                  dropout=0.0)
        cfg, jcfg = uncond_unet_config(**kw), jax_uncond_config(
            attention_impl="xla", **kw)
        labels = None
    else:
        kw = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0,
                  T=20, num_labels=10)
        cfg, jcfg = cond_unet_config(**kw), jax_cond_config(
            attention_impl="xla", **kw)
        labels = np.array([0, 4], np.int32)
    sd = _reference_state_dict(cfg, seed=3)
    torch.save({"state_dict": sd}, tmp_path / "ref.pt")
    got_sd = torch_convert.load_reference_checkpoint(str(tmp_path / "ref.pt"),
                                                     cfg)
    assert list(got_sd) == list(expected_shapes(cfg))
    model = UNet(cfg)
    model.load_state_dict(got_sd)
    model.eval()
    jparams = jax_convert_reference_unet(torch_convert.strip_module_prefix(
        sd), jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    args = (x, t) + (() if labels is None else (labels,))
    want = np.asarray(JaxUNet(jcfg).apply(jparams,
                                          *map(jnp.asarray, args)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    del sd["module.tail.2.bias"]
    with pytest.raises(KeyError, match="tail.2.bias"):
        torch_convert.convert_reference_unet(sd, cfg)
