"""Metric-tracked sampling, ``inference_metrics``, tracked training and the
``inference-metrics`` CLI of the port (``itsd_tpu_torch/cli/runner.py``)
against the JAX package's runner on the CPU.

``sample_with_metrics`` runs the narrow UNets (T=20, snapshots every 5
steps, eval batch 4, 8x8), unconditional and guided by CFG w=1.8, in both
packages on the same weights. The port's chain takes JAX's x_T and its
per-step noise (``noise_fn``), as test_torch_fast_samplers_unet.py does.
The extractors are fixed functions written once for each framework: channel
means as FID features (3-d, so that the 4 fakes' covariance has full
rank), a linear classifier on 2x2-pooled pixels as IS logits (2 splits),
and a linear map of the pooled pixels as CLIP features. The history's
timesteps must be equal; FID, IS and CLIP agree to 1e-4 relative (the
snapshots differ by up to ~1e-5, test_torch_fast_samplers_unet.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.cli import runner as jax_runner
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.search.verifiers import adaptive_avg_pool as jax_pool
from itsd_tpu.utils import load_config as jax_load_config
from itsd_tpu_torch.cli import main as cli_main
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.models import (ClassifierConfig, SmallCNN,
                                   params_from_jax, save_classifier)
from itsd_tpu_torch.search.verifiers import adaptive_avg_pool
from itsd_tpu_torch.utils import load_config

from _torch_port import flax_params, one_torch_thread  # noqa: F401

T, B, SIZE, INTERVAL = 20, 4, 8, 5
REL_TOL = 1e-4
MODEL_KEYS = {
    "uncond": ["channel=16", "channel_mult=[1,2]", "attn=[1]",
               "num_res_blocks=1", "dropout=0.0"],
    "cfg": ["channel=32", "channel_mult=[1,2]", "num_res_blocks=1",
            "dropout=0.0", "model.num_labels=10", "w=1.8"],
}
JAX_MODELS = {
    "uncond": lambda: JaxUNet(jax_uncond_config(
        ch=16, ch_mult=(1, 2), attn=(1,), num_res_blocks=1, dropout=0.0,
        T=T)),
    "cfg": lambda: JaxUNet(jax_cond_config(
        num_labels=10, ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0,
        T=T, time_embed="functional", attention_impl="xla")),
}
METAKEYS = {"feature_extractor", "is_logit_source", "clip_tracking",
            "is_splits", "comparable_to_published_fid"}

_rng = np.random.default_rng(11)
W_LOGITS = _rng.standard_normal((12, 10)).astype(np.float32) * 4
W_CLIP = _rng.standard_normal((12, 6)).astype(np.float32)
REAL = (_rng.random((16, SIZE, SIZE, 3))).astype(np.float32)


def _keys(model, tmp_path, *extra):
    return [*MODEL_KEYS[model], f"T={T}", f"img_size={SIZE}",
            f"train.eval_batch_size={B}", f"train.metric_interval={INTERVAL}",
            "train.is_splits=2", "data.dataset=shapes", "seed=3",
            f"metrics_save_dir={tmp_path}/m", f"sampled_dir={tmp_path}/s",
            f"save_weight_dir={tmp_path}/w", *extra]


def _jax_extractors():
    pool = lambda x: jax_pool(x, 2).reshape(x.shape[0], -1)  # noqa: E731
    return (lambda x: x.mean(axis=(1, 2)),
            lambda x: pool(x) @ jnp.asarray(W_LOGITS),
            lambda x: pool(x) @ jnp.asarray(W_CLIP))


def _port_extractors():
    pool = lambda x: adaptive_avg_pool(x, 2).reshape(  # noqa: E731
        x.shape[0], -1)
    return (lambda x: x.mean(dim=(1, 2)),
            lambda x: pool(x) @ torch.from_numpy(W_LOGITS),
            lambda x: pool(x) @ torch.from_numpy(W_CLIP))


def _split_chain(key, n):
    out = []
    for _ in range(n):
        key, nkey = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(nkey, (B, SIZE, SIZE, 3), jnp.float32))))
    return out


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.mark.parametrize("model", ["uncond", "cfg"])
def test_sample_with_metrics_matches_jax(model, tmp_path):
    keys = _keys(model, tmp_path)
    jcfg, cfg = jax_load_config(None, keys), load_config(None, keys)
    x = np.zeros((2, SIZE, SIZE, 3), np.float32)
    labels = np.ones(2, np.int32) if model == "cfg" else None
    params = flax_params(JAX_MODELS[model](), x, np.zeros(2, np.int32), 5,
                         labels)
    pmodel, _ = runner.build_model(cfg)
    sd = params_from_jax(params, pmodel.cfg)

    jf, jl, jc = _jax_extractors()
    pf, pl, pc = _port_extractors()
    jreal = jax_runner.compute_real_features(REAL, jf, batch_size=5)
    jreal_c = jax_runner.compute_real_features(REAL, jc, batch_size=5)
    real = runner.compute_real_features(REAL, pf, batch_size=5, device="cpu")
    real_c = runner.compute_real_features(REAL, pc, batch_size=5,
                                          device="cpu")
    np.testing.assert_allclose(real, jreal, atol=1e-6)
    np.testing.assert_allclose(real_c, jreal_c, atol=1e-5)

    want = jax_runner.sample_with_metrics(
        jcfg, params, feature_fn=jf, logit_fn=jl, real_features=jreal,
        clip_feature_fn=jc, real_clip_features=jreal_c, tag="jax")
    kx, ks = jax.random.split(jax.random.PRNGKey(cfg.seed))
    x_T = torch.from_numpy(np.array(jax.random.normal(
        kx, (B, SIZE, SIZE, 3))))
    noise = _split_chain(ks, T)
    got = runner.sample_with_metrics(
        cfg, sd, feature_fn=pf, logit_fn=pl, real_features=real,
        clip_feature_fn=pc, real_clip_features=real_c, tag="port",
        device="cpu", x_T=x_T, noise_fn=lambda i, t: noise[i])

    assert [h[0] for h in got["history"]] == [h[0] for h in want["history"]]
    assert [h[0] for h in got["history"]] == [15, 10, 5, 0]
    for g, w in zip(got["history"], want["history"]):
        for k in (1, 2, 3):
            assert np.isfinite(g[k]) and _rel(g[k], w[k]) < REL_TOL, (g, w)
    np.testing.assert_allclose(got["images"], want["images"], atol=1e-4)
    with open(tmp_path / "m" / "metrics_history_port.json") as f:
        port_json = json.load(f)
    with open(tmp_path / "m" / "metrics_history_jax.json") as f:
        jax_json = json.load(f)
    assert [set(r) for r in port_json] == [set(r) for r in jax_json]
    assert (tmp_path / "m" / "metrics_curves_port.png").is_file()
    grids = sorted(p.name for p in (tmp_path / "s").iterdir())
    assert len(grids) == 2 and grids[0].startswith(
        f"sampled_jax_T{T}_bs{B}_fid") and grids[1].startswith(
        f"sampled_port_T{T}_bs{B}_fid")


def test_absent_extractors_give_nan(tmp_path):
    """A metric is NaN exactly when its extractor or real features are
    absent; errors of an extractor propagate."""
    cfg = load_config(None, _keys("uncond", tmp_path))
    model, _ = runner.build_model(cfg)
    sd = runner.init_params(cfg, model)
    pf, pl, pc = _port_extractors()
    out = runner.sample_with_metrics(cfg, sd, feature_fn=pf, logit_fn=None,
                                     real_features=None, clip_feature_fn=pc,
                                     device="cpu")
    assert all(np.isnan(h[1:]).all() for h in out["history"])
    out = runner.sample_with_metrics(cfg, sd, logit_fn=pl, device="cpu")
    assert all(np.isfinite(h[2]) and np.isnan([h[1], h[3]]).all()
               for h in out["history"])

    def broken(x):
        raise RuntimeError("extractor failed")

    with pytest.raises(RuntimeError, match="extractor failed"):
        runner.sample_with_metrics(cfg, sd, feature_fn=broken,
                                   real_features=np.zeros((4, 3)),
                                   device="cpu")


def test_restart_intervals_raise_as_jax_does(tmp_path):
    keys = _keys("uncond", tmp_path, "diffusion.restart_intervals=[[15,5,1]]")
    with pytest.raises(ValueError) as want:
        jax_runner.sample_with_metrics(jax_load_config(None, keys), None)
    cfg = load_config(None, keys)
    with pytest.raises(ValueError) as got:
        runner.sample_with_metrics(cfg, None, device="cpu")
    assert str(got.value) == str(want.value)


def _checkpoint(tmp_path, model="uncond"):
    cfg = load_config(None, _keys(model, tmp_path))
    net, _ = runner.build_model(cfg)
    (tmp_path / "w").mkdir(exist_ok=True)
    torch.save(runner.init_params(cfg, net), tmp_path / "w" / "w.pt")


def test_inference_metrics_on_a_port_checkpoint(tmp_path, monkeypatch,
                                                capsys):
    """Pixel features, the IS logits of the port's classifier found by
    "auto" under JAX's name, and JAX's metrics_meta.json keys; without the
    dataset on disk FID and CLIP are NaN."""
    monkeypatch.setenv("ITSD_PIXEL_FEATURES", "1")
    monkeypatch.delenv("ITSD_CLIP_WEIGHTS", raising=False)
    _checkpoint(tmp_path)
    clf = SmallCNN(ClassifierConfig(num_classes=10, ch=8, depth=2))
    clf.init_weights(torch.Generator().manual_seed(0))
    save_classifier(str(tmp_path / "w" / f"classifier_shapes{SIZE}"),
                    clf.state_dict())
    cfg = load_config(None, _keys("uncond", tmp_path, "test_load_weight=w.pt",
                                  "train.fid_num_real_samples=32"))
    out = runner.inference_metrics(cfg, device="cpu")
    meta = json.loads((tmp_path / "m" / "metrics_meta.json").read_text())
    assert set(meta) == METAKEYS
    assert meta["feature_extractor"] == "pixel" and not meta["clip_tracking"]
    assert meta["is_logit_source"].startswith("classifier:")
    assert meta["comparable_to_published_fid"] is False
    assert [h[0] for h in out["history"]] == [15, 10, 5, 0]
    assert all(np.isfinite(h[1:3]).all() and np.isnan(h[3])
               for h in out["history"])

    cfg = load_config(None, _keys("uncond", tmp_path, "test_load_weight=w.pt",
                                  "data.dataset=cifar10",
                                  f"data.root={tmp_path}/none"))
    out = runner.inference_metrics(cfg, device="cpu")
    assert "no real dataset available" in capsys.readouterr().out
    # no classifier_cifar108 either: the pixel extractor has no logits
    assert all(np.isnan(h[1:]).all() for h in out["history"])


def test_cli_inference_metrics_exits_0(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ITSD_PIXEL_FEATURES", "1")
    _checkpoint(tmp_path, "cfg")
    rc = cli_main.main(["inference-metrics", "--device", "cpu",
                        *_keys("cfg", tmp_path, "test_load_weight=w.pt",
                               "train.fid_num_real_samples=16")])
    assert rc == 0
    assert "tracked 4 metric points" in capsys.readouterr().out
    hist = json.loads((tmp_path / "m" / "metrics_history.json").read_text())
    assert [r["t"] for r in hist] == [15, 10, 5, 0]
    assert all(np.isfinite(r["fid"]) for r in hist)


def test_tracked_train_writes_the_epoch_history(tmp_path, monkeypatch):
    monkeypatch.setenv("ITSD_PIXEL_FEATURES", "1")
    cfg = load_config(None, _keys(
        "uncond", tmp_path, "train.batch_size=4", "train.epoch=1",
        "train.eval_freq=1", "data.use_full_dataset=false",
        "data.train_subset_ratio=0.02", "train.fid_num_real_samples=8"))
    assert runner.resolve_track_metrics(cfg)
    out = runner.train(cfg, device="cpu")
    hist = json.loads(
        (tmp_path / "m" / "metrics_history_epoch_0.json").read_text())
    assert [r["t"] for r in hist] == [15, 10, 5, 0]
    assert all(np.isfinite(r["fid"]) for r in hist)
    assert out["metrics_history"][0]["epoch"] == 0
    records = [json.loads(line) for line in
               (tmp_path / "m" / "train_metrics.jsonl").read_text().split(
                   "\n") if line]
    evals = [r for r in records if "eval_fid" in r]
    assert len(evals) == 1 and evals[0]["eval_fid"] == hist[-1]["fid"]
    # 40 shapes images: 4 held out as the val split, 9 batches of 4 left
    assert out["steps"] == 9
    assert (tmp_path / "m" / "loss_curve.png").is_file()


def test_clip_verifier_without_weights_gives_jax_message(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("ITSD_CLIP_WEIGHTS", raising=False)
    keys = _keys("uncond", tmp_path, "search.verifier=clip")
    with pytest.raises(ValueError) as want:
        jax_runner.build_cli_verifier(jax_load_config(None, keys), False, B)
    with pytest.raises(ValueError) as got:
        runner.build_cli_verifier(load_config(None, keys), False, B,
                                  device="cpu")
    assert str(got.value) == str(want.value)
