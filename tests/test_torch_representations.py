"""Representation extraction and analysis, profiling and the image-folder
loader of the port against the JAX package.

Inputs come from numpy seeds; both sides run in f32 on the CPU. The train
runs start from the same seeded weights (``train.training_load_weight``,
saved in each package's format) and take JAX's t, noise and label-dropout
masks through the port's train step.

Tolerances:
* ``return_representation`` of the conditional UNet: 1e-5 absolute on
  activations O(1) (conv and matmul sums in another order, as the UNet's
  eps in ``tests/test_torch_unet.py``).
* The representations ``train`` writes after one and two steps (lr 1e-4,
  2e-4 at the warmup's peak): 2e-4 absolute on values O(1), the labels
  equal. Adam's update is ~lr whatever the gradient's size, so a weight
  whose exact gradient is 0 (attention's k bias) takes an update that
  differs between the frameworks by up to ~lr (``tests/test_torch_
  train.py``); measured 4.6e-5. A step moves the representations by
  ~1e-2, so the pre-step weights would fail.
* ``cli.analyze``'s statistics on the same dumps: equal (the same numpy
  calls).
* ``load_image_folder``: equal arrays (the same Pillow calls).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.cli import analyze as jax_analyze
from itsd_tpu.cli import runner as jax_runner
from itsd_tpu.data import datasets as jax_datasets
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.train.checkpoint import save_params as jax_save_params
from itsd_tpu.utils import load_config as jax_load_config
from itsd_tpu_torch.cli import analyze, runner
from itsd_tpu_torch.data import datasets
from itsd_tpu_torch.models import UNet, cond_unet_config, params_from_jax
from itsd_tpu_torch.utils import load_config, profiling

from _torch_port import (flax_params, jax_train_draws,  # noqa: F401
                         one_torch_thread)

SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0, T=20,
             num_labels=10)


def test_cond_return_representation_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    t = np.array([1, 10, 19], np.int32)
    labels = np.array([0, 4, 10], np.int32)
    jm = JaxUNet(jax_cond_config(attention_impl="xla", **SMALL))
    params = flax_params(jm, x, t, 5, labels)
    want, want_rep = jax.jit(lambda p, *a: jm.apply(
        p, *a, return_representation=True))(
            params, *map(jnp.asarray, (x, t, labels)))
    model = UNet(cond_unet_config(**SMALL))
    model.load_state_dict(params_from_jax(params, model.cfg))
    model.eval()
    with torch.no_grad():
        got, rep = model(*map(torch.from_numpy, (x, t, labels)),
                         return_representation=True)
    assert rep.shape == want_rep.shape == (3, 16, 16, 32)
    np.testing.assert_allclose(rep.numpy(), np.asarray(want_rep), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


KEYS = ["channel=32", "channel_mult=[1,2]", "num_res_blocks=1",
        "dropout=0.0", "img_size=8", "T=20", "model.num_labels=10",
        "data.dataset=shapes", "data.use_full_dataset=false",
        "data.train_subset_ratio=0.008", "train.batch_size=8",
        "train.track_metrics=false", "train.epoch=1",
        "train.eval_freq=100", "train.model_save_freq=100",
        "train.label_dropout=0.3", "train.extract_representation_freq=1",
        "train.training_load_weight=init"]


def test_train_writes_the_representations_jax_writes(tmp_path, monkeypatch):
    """Two conditional train steps with extraction every batch: the .npz
    of epoch 0 (two batches of 8: representations [16, 32], labels [16])
    against JAX's train on the same weights, batches and draws (a batch
    of 8 tiles the JAX tests' 8 virtual CPU devices)."""
    jcfg = jax_load_config(None, KEYS + [f"save_weight_dir={tmp_path}/jax",
                                         f"metrics_save_dir={tmp_path}/jm",
                                         f"sampled_dir={tmp_path}/js"])
    jm, _ = jax_runner.build_model(jcfg)
    params = flax_params(jm, np.zeros((2, 8, 8, 3), np.float32),
                         np.zeros(2, np.int32), 6, np.array([1, 2]))
    jax_save_params(os.path.join(jcfg.save_weight_dir, "init"), params)
    jax_runner.train(jcfg, max_steps=2)
    draws = jax_train_draws(jcfg, 2, 0.3)

    real = runner.make_train_step

    def injected(*a, **kw):
        step = real(*a, **kw)
        fed = iter(draws)
        return lambda state, batch, gen: step(state, batch, gen, *next(fed))

    monkeypatch.setattr(runner, "make_train_step", injected)
    cfg = load_config(None, KEYS + [f"save_weight_dir={tmp_path}",
                                    f"metrics_save_dir={tmp_path}/m",
                                    f"sampled_dir={tmp_path}/s"])
    model, _ = runner.build_model(cfg)
    torch.save(params_from_jax(params, model.cfg), tmp_path / "init")
    out = runner.train(cfg, max_steps=2, device="cpu")
    assert out["steps"] == 2
    with np.load(tmp_path / "representations" / "epoch_0.npz") as got, \
            np.load(tmp_path / "jax" / "representations" /
                    "epoch_0.npz") as want:
        assert got["representations"].shape == (16, 32)
        assert got["representations"].dtype == np.float32
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["representations"],
                                   want["representations"], atol=2e-4,
                                   rtol=0)


def test_unconditional_train_and_save_representations_false(tmp_path):
    """Extraction applies to the conditional model only, and writes
    nothing with save_representations=false."""
    base = [k for k in KEYS if k not in ("model.num_labels=10",
                                         "train.training_load_weight=init")]
    for extra, conditional in ((["attn=[1]"], False),
                               (["model.num_labels=10",
                                 "train.save_representations=false"], True)):
        cfg = load_config(None, base + extra + [
            f"save_weight_dir={tmp_path}", f"metrics_save_dir={tmp_path}/m",
            f"sampled_dir={tmp_path}/s"])
        assert runner.build_model(cfg)[1] is conditional
        assert runner.train(cfg, max_steps=1, device="cpu")["steps"] == 1
        assert not (tmp_path / "representations").exists()


def _dumps(tmp_path, epochs=3, n=40, d=6):
    rng = np.random.default_rng(0)
    rdir = tmp_path / "reps"
    rdir.mkdir()
    for e in range(epochs):
        np.savez(rdir / f"epoch_{e}.npz",
                 representations=rng.standard_normal((n, d)).astype(
                     np.float32) + e,
                 labels=rng.integers(0, 10, n).astype(np.int32))
    return rdir


def test_analyze_stats_and_plots_match_jax(tmp_path, capsys):
    rdir = _dumps(tmp_path)
    got = analyze.load_representations(str(rdir))
    want = jax_analyze.load_representations(str(rdir))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for e in got:
        assert analyze.representation_stats(*got[e]) == \
            jax_analyze.representation_stats(*want[e])
    out = tmp_path / "an"
    assert analyze.main(["--repr-dir", str(rdir), "--out-dir", str(out),
                         "--max-samples", "30"]) == 0
    text = capsys.readouterr().out
    assert "epoch 2: {'n': 40, 'dim': 6" in text
    for name in ("tsne_epoch_2.png", "representation_evolution.png"):
        data = (out / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000
    assert analyze.main(["--representation_dir", str(rdir), "--epoch", "7",
                         "--output_dir", str(out)]) == 1
    assert "for epoch 7" in capsys.readouterr().out


def test_analyze_without_sklearn_and_matplotlib_prints_the_stats(
        tmp_path, capsys, monkeypatch):
    """The card's machine has neither: the statistics print and each plot
    says in one line that it was skipped."""
    for mod in ("sklearn", "sklearn.decomposition", "sklearn.manifold",
                "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, mod, None)
    rdir = _dumps(tmp_path, epochs=1)
    assert analyze.main(["--repr-dir", str(rdir), "--out-dir",
                         str(tmp_path / "an")]) == 0
    text = capsys.readouterr().out
    assert "epoch 0: {'n': 40" in text
    assert "scikit-learn is not installed" in text
    assert "matplotlib is not installed" in text
    assert not (tmp_path / "an").exists()


def test_profile_steps_write_a_chrome_trace(tmp_path):
    """train.profile_steps=2: the first two steps traced into
    metrics_save_dir/trace/trace.json, each a region step_{i}; a loop that
    ends before the last traced step still writes it."""
    base = [k for k in KEYS if k != "train.training_load_weight=init"]
    cfg = load_config(None, base + ["train.profile_steps=2",
                                    f"save_weight_dir={tmp_path}",
                                    f"metrics_save_dir={tmp_path}/m",
                                    f"sampled_dir={tmp_path}/s"])
    out = runner.train(cfg, max_steps=2, device="cpu")
    path = tmp_path / "m" / "trace" / "trace.json"
    assert out["trace"] == str(path)
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"step_0", "step_1"} <= names and "step_2" not in names
    prof = profiling.trace_steps(5, str(tmp_path / "short"))
    for _ in range(2):
        with prof.step():
            torch.ones(3).sum()
    prof.close()
    assert (tmp_path / "short" / "trace.json").stat().st_size > 0
    with profiling.trace(None):  # no directory: no trace
        pass
    with profiling.trace(str(tmp_path / "block")):
        with profiling.annotate("inside"):
            torch.ones(2).sum()
    assert "inside" in (tmp_path / "block" / "trace.json").read_text()


def _image_tree(root):
    """Two classes of PNG and JPEG files of several sizes, and a file of
    another kind that the loader skips."""
    from PIL import Image

    rng = np.random.default_rng(1)
    sizes = [(20, 12), (9, 15), (16, 16), (31, 10), (10, 10)]
    for ci, cls in enumerate(("cat", "ant")):
        d = root / cls
        d.mkdir(parents=True)
        for i, (w, h) in enumerate(sizes[ci:ci + 4]):
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ext = ".png" if i % 2 else ".JPG"
            Image.fromarray(arr).save(d / f"im{i}{ext}")
        (d / "notes.txt").write_text("x")
    Image.fromarray(rng.integers(0, 256, (8, 8), np.uint8)).save(
        root / "ant" / "gray.png")


@pytest.mark.parametrize("kw", [dict(), dict(subset_ratio=0.5, seed=3),
                                dict(max_images=3, img_size=5)])
def test_load_image_folder_matches_jax(tmp_path, kw):
    pytest.importorskip("PIL")
    _image_tree(tmp_path)
    kw = dict(dict(img_size=8), **kw)
    x, y = datasets.load_image_folder(str(tmp_path), **kw)
    jx, jy = jax_datasets.load_image_folder(str(tmp_path), **kw)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.dtype == np.float32 and y.dtype == np.int32
    assert x.shape[1:] == (kw["img_size"],) * 2 + (3,)
    assert -1 <= x.min() <= x.max() <= 1


def test_image_folder_trains_and_needs_pillow(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    _image_tree(tmp_path / "data")
    base = [k for k in KEYS if k != "train.training_load_weight=init"]
    cfg = load_config(None, base + [
        "data.dataset=imagefolder", f"data.root={tmp_path}/data",
        "data.use_full_dataset=true", "train.batch_size=2",
        f"save_weight_dir={tmp_path}/c", f"metrics_save_dir={tmp_path}/m",
        f"sampled_dir={tmp_path}/s"])
    out = runner.train(cfg, max_steps=2, device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        datasets.load_image_folder(str(tmp_path / "data"))
