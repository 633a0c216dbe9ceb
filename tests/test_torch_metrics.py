"""The port's metrics (``itsd_tpu_torch/metrics/``) against the JAX
package's on the CPU: ``compute_fid`` and the IS split protocol on seeded
arrays (float64 on the host in both: 1e-9 relative), the ``FID``, ``IS``
and ``CLIPScore`` evaluators with stand-in extractors and with the tiny
CLIP of ``test_torch_clip.py`` (1e-5), ``load_images``, and the plotting
functions, which write a PNG, or print a line and write nothing where
matplotlib is missing.
"""

import builtins

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.metrics import clip as JC
from itsd_tpu.metrics import evaluator as JE
from itsd_tpu.metrics import frechet as JFr
from itsd_tpu.metrics import is_score as JIS
from itsd_tpu.search.verifiers import adaptive_avg_pool as jax_pool
from itsd_tpu_torch import metrics as M
from itsd_tpu_torch.metrics import clip as PC
from itsd_tpu_torch.search.verifiers import adaptive_avg_pool
from itsd_tpu_torch.utils import plotting

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_clip import HEADS, hf_state_dict

TOL = 1e-5


def _feats(n, d, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) + shift).astype(np.float32)


def _unit(n, size, seed):
    return np.random.default_rng(seed).random(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("n,d,shift", [(64, 8, 0.0), (40, 16, 0.5),
                                       (10, 32, 1.0)])
def test_compute_fid_matches_jax(n, d, shift):
    real, fake = _feats(n, d, 1), _feats(n + 3, d, 2, shift)
    want = JFr.compute_fid(real, fake)
    got = M.compute_fid(real, fake)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    assert M.compute_fid(real, real) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("n,splits", [(50, 10), (7, 10), (33, 4), (8, 1)])
def test_is_split_protocol_matches_jax(n, splits):
    rng = np.random.default_rng(n)
    logits = (3 * rng.standard_normal((n, 10))).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = JIS.inception_score_from_probs(probs, splits)
    got = M.inception_score_from_probs(probs, splits)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    w = jnp.asarray(rng.standard_normal((48, 10)).astype(np.float32))
    images = _unit(n, 4, 3)

    def jax_logits(x):
        return x.reshape(x.shape[0], -1) @ w

    def torch_logits(x):
        return x.reshape(x.shape[0], -1) @ torch.from_numpy(np.array(w))

    want = JIS.inception_score(jax_logits, jnp.asarray(images), splits,
                               batch_size=16)
    got = M.inception_score(torch_logits, torch.from_numpy(images), splits,
                            batch_size=16)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fid_and_is_evaluators_with_stand_in_extractors(monkeypatch):
    """Pooled-pixel features (``$ITSD_PIXEL_FEATURES=1`` in both) and one
    linear classifier in both; a 2x2 pool as a passed-in extractor."""
    monkeypatch.setenv("ITSD_PIXEL_FEATURES", "1")
    real, fake = _unit(24, 8, 4), np.clip(_unit(20, 8, 5) + 0.2, 0, 1)
    want = JE.FID(batch_size=8)
    got = M.FID(batch_size=8, device="cpu")
    assert got.provenance == want.provenance == "pixel"
    np.testing.assert_allclose(got.get_features(real),
                               want.get_features(real), atol=TOL)
    assert got(real, fake) == pytest.approx(want(real, fake), rel=1e-5)
    assert got(real, real) == pytest.approx(0.0, abs=1e-6)

    pooled = M.FID(batch_size=8, device="cpu", feature_fn=lambda x:
                   adaptive_avg_pool(x, 2).reshape(x.shape[0], -1))
    jpool = lambda x: jax_pool(x, 2).reshape(x.shape[0], -1)  # noqa: E731
    want_fid = JFr.compute_fid(np.asarray(jpool(jnp.asarray(real))),
                               np.asarray(jpool(jnp.asarray(fake))))
    assert pooled(real, fake) == pytest.approx(want_fid, rel=1e-5)

    w = np.random.default_rng(6).standard_normal((192, 10)).astype(
        np.float32)
    is_ = M.IS(batch_size=8, splits=4, device="cpu",
               logit_fn=lambda x: x.reshape(x.shape[0], -1)
               @ torch.from_numpy(w))
    want = JIS.inception_score(
        lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(w),
        jnp.asarray(fake), splits=4, batch_size=8)
    np.testing.assert_allclose(is_(fake), want, rtol=1e-6)
    with pytest.raises(RuntimeError, match="needs a classifier"):
        M.IS(device="cpu")


def test_clip_score_matches_jax():
    sd = hf_state_dict()
    jparams = JC.convert_transformers_clip(sd, HEADS, HEADS)
    model = PC.clip_from_state_dict(sd, HEADS, HEADS)
    want = JE.CLIPScore(jparams, batch_size=4)
    got = M.CLIPScore(model, batch_size=4, device="cpu")
    fake, real = _unit(6, 32, 7), _unit(5, 16, 8)
    real_f = got.get_features(real)
    np.testing.assert_allclose(real_f, want.get_features(real), atol=TOL)
    assert got.similarity(fake, real_f) == pytest.approx(
        want.similarity(fake, real_f), abs=TOL)
    assert got.diversity(fake) == pytest.approx(want.diversity(fake),
                                                abs=TOL)
    stand_in = M.CLIPScore(feature_fn=lambda x: x.mean(dim=(1, 2)),
                           device="cpu")
    f = fake.mean(axis=(1, 2))
    f = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-8)
    np.testing.assert_allclose(stand_in.get_features(fake), f, atol=1e-6)


def test_load_images_reads_pngs(tmp_path):
    from PIL import Image

    imgs = (_unit(3, 8, 9) * 255).astype(np.uint8)
    paths = []
    for i, a in enumerate(imgs):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(a).save(paths[-1])
    got = M.load_images(paths)
    np.testing.assert_array_equal(got, JE.load_images(paths))
    np.testing.assert_allclose(got * 255, imgs, atol=1e-4)
    assert M.load_images(paths, size=4).shape == (3, 4, 4, 3)
    with pytest.raises(ValueError, match="no image paths"):
        M.load_images([])
    fid = M.FID(device="cpu", feature_fn=lambda x: x.mean(dim=(1, 2)))
    assert fid.extract_features(paths).shape == (3, 3)


def test_plots_write_pngs(tmp_path):
    loss = plotting.plot_loss_curve(np.linspace(1, 0.1, 120),
                                    str(tmp_path / "a" / "loss.png"))
    hist = [(15, 3.0, 1.1, 0.5), (10, float("nan"), 1.2, 0.6),
            (0, 1.0, 1.3, float("nan"))]
    curves = plotting.plot_metrics_curves(hist, str(tmp_path / "m.png"),
                                          T=20)
    for path in (loss, curves):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_without_matplotlib_write_nothing(tmp_path, monkeypatch,
                                                capsys):
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    path = str(tmp_path / "loss.png")
    assert plotting.plot_loss_curve([1.0, 0.5], path) is None
    assert plotting.plot_metrics_curves([(0, 1.0, 1.0, 1.0)],
                                        str(tmp_path / "m.png")) is None
    out = capsys.readouterr().out
    assert "matplotlib is not installed" in out and path in out
    assert not list(tmp_path.iterdir())
