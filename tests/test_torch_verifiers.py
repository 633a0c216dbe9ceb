"""The port's verifiers, metrics pieces and SmallCNN against the JAX
package's.

Every verifier is held to its JAX function on the same seeded numpy
images, by value and by its gradient with respect to the images
(``jax.grad`` against ``torch.autograd``). The feature extractors that
the feature-based verifiers take are small fixed maps (a tanh of a seeded
linear map of the pooled pixels), written once for each framework. The
ensemble verifier gets JAX's projection matrix passed in (threefry cannot
be reproduced in torch).

Tolerances, all float32 on values O(1):
* elementwise arithmetic and reductions of <= 3,072 terms: 1e-5 absolute
  and relative (the frameworks sum in other orders, ~1e-7 a term);
* the Fréchet verifiers (eigh of a 4x4 covariance, square roots of its
  eigenvalues): 1e-4 relative on the value and its gradient; the batch of
  8 images keeps the 4-d feature covariance full rank, so no square root
  sits at 0, where its gradient would blow up;
* SmallCNN forward on the same weights: 1e-5 on logits O(0.1-10)
  (convolutions summed in other orders); trained artifact: 1e-4, logits
  up to ~30.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.metrics import frechet as jax_frechet
from itsd_tpu.metrics.is_score import is_score_jax
from itsd_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from itsd_tpu.models.classifier import SmallCNN as JaxSmallCNN
from itsd_tpu.search import verifiers as J
from itsd_tpu.train.checkpoint import restore_params as jax_restore_params
from itsd_tpu_torch.data import shapes_dataset
from itsd_tpu_torch.metrics import (frechet_distance, frechet_distance_torch,
                                    gaussian_stats, is_score)
from itsd_tpu_torch.models import (ClassifierConfig, SmallCNN,
                                   classifier_params_from_jax,
                                   load_classifier,
                                   load_classifier_extractors,
                                   save_classifier, train_classifier)
from itsd_tpu_torch.search import verifiers as P

from _torch_port import one_torch_thread  # noqa: F401

ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "artifacts", "classifier_shapes32")
TOL = 1e-5
FID_TOL = 1e-4
D = 4  # feature width of the test extractors


def _images(seed, shape=(8, 16, 16, 3)):
    return np.random.default_rng(seed).uniform(
        -1.1, 1.1, shape).astype(np.float32)


_W = np.random.default_rng(40).standard_normal((3 * 4 * 4, D)).astype(
    np.float32) / 6.0
_WL = np.random.default_rng(41).standard_normal((D, 5)).astype(np.float32)


def _jax_feats(unit):
    pooled = J.adaptive_avg_pool(unit, 4).reshape(unit.shape[0], -1)
    return jnp.tanh((pooled - 0.5) @ _W * 2.0)


def _torch_feats(unit):
    pooled = P.adaptive_avg_pool(unit, 4).reshape(unit.shape[0], -1)
    return torch.tanh((pooled - 0.5) @ torch.from_numpy(_W) * 2.0)


def _jax_run(unit):
    f = _jax_feats(unit)
    return f, f @ _WL


def _torch_run(unit):
    f = _torch_feats(unit)
    return f, f @ torch.from_numpy(_WL)


_STATS = dict(zip(("mu", "sigma"), jax_frechet.gaussian_stats(
    np.asarray(_jax_feats(jnp.asarray((_images(42) + 1) / 2))))))
_REAL = np.asarray(_jax_feats(jnp.asarray((_images(43, (12, 16, 16, 3))
                                           + 1) / 2)))
_PROJ = np.array(jax.random.normal(jax.random.PRNGKey(7), (D, 3))
                 / jnp.sqrt(D))
_COND = np.random.default_rng(44).standard_normal((8, D)).astype(np.float32)
_REF = np.random.default_rng(45).standard_normal((8, 192)).astype(np.float32)
_TARGETS = np.arange(8) % 5


def _jax_logits(unit):
    return _jax_feats(unit) @ _WL


def _torch_logits(unit):
    return _torch_feats(unit) @ torch.from_numpy(_WL)


# name -> (JAX verifier, port verifier, tolerance)
VERIFIERS = {
    "pixel_variance": (J.batch_pixel_variance_score,
                       P.batch_pixel_variance_score, TOL),
    "oracle_no_stats": (J.oracle_verifier(), P.oracle_verifier(), TOL),
    "oracle_fid": (J.oracle_verifier(_STATS, _jax_feats),
                   P.oracle_verifier(_STATS, _torch_feats), FID_TOL),
    "supervised_norm": (J.supervised_verifier(_jax_feats),
                        P.supervised_verifier(_torch_feats), TOL),
    "supervised_cond": (J.supervised_verifier(_jax_feats, _COND),
                        P.supervised_verifier(_torch_feats,
                                              torch.from_numpy(_COND)), TOL),
    "clip_score": (J.clip_score_verifier(_jax_feats, _COND[0]),
                   P.clip_score_verifier(_torch_feats,
                                         torch.from_numpy(_COND[0])), TOL),
    "self_supervised": (J.self_supervised_verifier(),
                        P.self_supervised_verifier(), TOL),
    "self_supervised_ref": (J.self_supervised_verifier(_REF),
                            P.self_supervised_verifier(
                                torch.from_numpy(_REF)), TOL),
    "aesthetic": (J.aesthetic_score, P.aesthetic_score, TOL),
    "integrated_uniform": (
        J.integrated_verifier({"a": J.aesthetic_score,
                               "o": J.batch_pixel_variance_score}),
        P.integrated_verifier({"a": P.aesthetic_score,
                               "o": P.batch_pixel_variance_score}), TOL),
    "integrated_weighted": (
        J.integrated_verifier({"a": J.aesthetic_score,
                               "s": J.self_supervised_verifier()},
                              {"a": 0.7, "s": 0.3}),
        P.integrated_verifier({"a": P.aesthetic_score,
                               "s": P.self_supervised_verifier()},
                              {"a": 0.7, "s": 0.3}), TOL),
    "ensemble_fid_is": (
        J.ensemble_fid_is_verifier(_jax_run, _REAL, is_weight=2.0,
                                   proj_dim=3),
        P.ensemble_fid_is_verifier(_torch_run, _REAL, is_weight=2.0,
                                   proj_dim=3, proj=torch.from_numpy(_PROJ)),
        FID_TOL),
    "classifier": (J.classifier_verifier(_jax_logits, jnp.asarray(_TARGETS)),
                   P.classifier_verifier(_torch_logits,
                                         torch.from_numpy(_TARGETS)), TOL),
}


@pytest.mark.parametrize("name", VERIFIERS)
def test_verifier_value_and_gradient_match_jax(name):
    jv, pv, tol = VERIFIERS[name]
    x = _images(1)
    want, want_g = jax.value_and_grad(jv)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pv(xt)
    (got_g,) = torch.autograd.grad(got, xt)
    assert got.dim() == 0 and np.isfinite(float(got.detach()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=tol,
                               atol=tol)
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0 or name == "oracle_no_stats"
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=tol,
                               atol=tol * np.abs(want_g).max())


def test_ensemble_default_projection_is_seeded():
    """Without JAX's matrix the projection is drawn from a torch generator
    seeded with ``seed``: the same seed gives the same score."""
    a, b, c = (P.ensemble_fid_is_verifier(_torch_run, _REAL, proj_dim=3,
                                          seed=s) for s in (7, 7, 8))
    x = torch.from_numpy(_images(2))
    assert float(a(x)) == float(b(x)) != float(c(x))


def test_integrated_verifier_rejects_unknown_weights():
    with pytest.raises(ValueError, match="unknown verifiers"):
        P.integrated_verifier({"a": P.aesthetic_score}, {"b": 1.0})
    assert P.reference_integrated_weights() == \
        J.reference_integrated_weights()


@pytest.mark.parametrize("size,out_hw", [(16, 8), (16, 4), (12, 8), (10, 4),
                                         (8, 8)])
def test_adaptive_avg_pool_matches_jax(size, out_hw):
    """Block means where out_hw divides the size; JAX's antialiased linear
    resize where it does not (12 -> 8, 10 -> 4)."""
    x = _images(3, (2, size, size, 3))
    want = J.adaptive_avg_pool(jnp.asarray(x), out_hw)
    got = P.adaptive_avg_pool(torch.from_numpy(x), out_hw)
    assert got.shape == (2, out_hw, out_hw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_unit_range_and_l2_normalize_match_jax():
    x = _images(4)
    np.testing.assert_array_equal(
        P.to_unit_range(torch.from_numpy(x)).numpy(),
        np.asarray(J.to_unit_range(jnp.asarray(x))))
    f = x.reshape(8, -1)
    np.testing.assert_allclose(P._l2_normalize(torch.from_numpy(f)).numpy(),
                               np.asarray(J._l2_normalize(jnp.asarray(f))),
                               atol=TOL, rtol=0)


def test_frechet_distances_and_is_score_match_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((30, 6)) * 1.3 + 0.4
    mu1, s1 = gaussian_stats(a)
    mu2, s2 = gaussian_stats(b, biased=False)
    for got, want in zip((mu1, s1, mu2, s2),
                         (*jax_frechet.gaussian_stats(a),
                          *jax_frechet.gaussian_stats(b, biased=False))):
        np.testing.assert_array_equal(got, want)
    want = jax_frechet.frechet_distance(mu1, s1, mu2, s2)
    assert frechet_distance(mu1, s1, mu2, s2) == want and want > 0.1
    assert frechet_distance(mu1, s1, mu1, s1) < 1e-6
    f32 = [np.asarray(v, np.float32) for v in (mu1, s1, mu2, s2)]
    want32 = jax_frechet.frechet_distance_jax(*map(jnp.asarray, f32))
    got32 = frechet_distance_torch(*map(torch.from_numpy, f32))
    np.testing.assert_allclose(float(got32), float(want32), rtol=FID_TOL)
    np.testing.assert_allclose(float(got32), want, rtol=1e-3)
    probs = np.asarray(jax.nn.softmax(rng.standard_normal((16, 10)) * 2))
    np.testing.assert_allclose(
        float(is_score(torch.from_numpy(probs.astype(np.float32)))),
        float(is_score_jax(jnp.asarray(probs, jnp.float32))), rtol=TOL)


def test_fid_proxy_matches_jax():
    real = _images(6, (64, 16, 16, 3))
    fake = _images(7, (8, 16, 16, 3)) * 0.5
    want = J.make_fid_proxy(jnp.asarray(real))(jnp.asarray(fake))
    got = P.make_fid_proxy(real)(torch.from_numpy(fake))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# SmallCNN


@pytest.mark.parametrize("size,depth", [(32, 3), (15, 2), (12, 3)])
def test_small_cnn_on_jax_init_weights_matches_jax(size, depth):
    """Flax's "SAME" padding at even sizes (0 before, 1 after a stride-2
    conv) and odd ones (1 and 1), through the converted weights."""
    jcfg = JaxClassifierConfig(num_classes=7, ch=8, depth=depth)
    x = (_images(8, (3, size, size, 3)) + 1) / 2
    params = JaxSmallCNN(jcfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((2, size, size, 3)))
    want_l, want_f = JaxSmallCNN(jcfg).apply(params, jnp.asarray(x),
                                             return_features=True)
    model = SmallCNN(ClassifierConfig(num_classes=7, ch=8, depth=depth))
    model.load_state_dict(classifier_params_from_jax(params, model.cfg))
    with torch.no_grad():
        got_l, got_f = model(torch.from_numpy(x), return_features=True)
    assert got_l.shape == (3, 7) and got_f.shape == (3, 8 * 2 ** (depth - 1))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=TOL,
                               rtol=TOL)


@pytest.fixture(scope="module")
def trained_classifier():
    """artifacts/classifier_shapes32, restored in memory: (Flax params,
    the port's SmallCNN with the same weights)."""
    params = jax_restore_params(ARTIFACT, template=None)
    p = params["params"]
    cfg = ClassifierConfig(num_classes=int(p["head"]["kernel"].shape[-1]),
                           ch=int(p["conv0a"]["kernel"].shape[-1]),
                           depth=sum(1 for k in p if k.startswith("conv")
                                     and k.endswith("a")))
    model = SmallCNN(cfg)
    model.load_state_dict(classifier_params_from_jax(params, cfg))
    return params, model.eval()


def test_trained_classifier_matches_jax(trained_classifier):
    params, model = trained_classifier
    images, labels = shapes_dataset(n=64, img_size=32, seed=3)
    unit = (images + 1) / 2
    jm = JaxSmallCNN(JaxClassifierConfig(**{
        k: getattr(model.cfg, k) for k in ("num_classes", "ch", "depth")}))
    want = np.asarray(jm.apply(params, jnp.asarray(unit)))
    with torch.no_grad():
        got = model(torch.from_numpy(unit)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert (got.argmax(-1) == labels).mean() > 0.9


def test_load_classifier_round_trips_a_torch_checkpoint(trained_classifier,
                                                        tmp_path):
    _, model = trained_classifier
    path = str(tmp_path / "clf.pt")
    save_classifier(path, model.state_dict())
    logit_fn, params, cfg = load_classifier(path, device="cpu")
    assert cfg == model.cfg and set(params) == set(model.state_dict())
    feature_fn, logit_fn2, prov = load_classifier_extractors(path,
                                                             device="cpu")
    x = torch.from_numpy((_images(9, (4, 32, 32, 3)) + 1) / 2)
    with torch.no_grad():
        want_l, want_f = model(x, return_features=True)
        assert torch.equal(logit_fn(x), want_l)
        assert torch.equal(logit_fn2(x), want_l)
        assert torch.equal(feature_fn(x), want_f)
    assert prov.startswith(f"classifier:{path} (10-class SmallCNN")


def test_train_classifier_learns_shapes():
    """Behaviour, not parity (the frameworks draw other initial weights):
    the port's trainer reaches high accuracy on the shapes dataset."""
    images, labels = shapes_dataset(n=1024, img_size=16, num_labels=4,
                                    seed=0)
    logit_fn, params, acc = train_classifier(
        images, labels, ClassifierConfig(num_classes=4, ch=16, depth=3),
        epochs=8, batch_size=64, lr=2e-3, device="cpu")
    assert acc > 0.9, acc
    assert set(params) == set(SmallCNN(ClassifierConfig(4, 16, 3))
                              .state_dict())
    v = P.classifier_verifier(logit_fn, torch.full((8,), int(labels[0])))
    right = torch.from_numpy(images[labels == labels[0]][:8])
    wrong = torch.from_numpy(images[labels != labels[0]][:8])
    with torch.no_grad():
        assert float(v(right)) > float(v(wrong))
