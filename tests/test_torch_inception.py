"""The port's Inception-V3 (``itsd_tpu_torch/metrics/inception.py``)
against the JAX package's (``itsd_tpu/metrics/inception.py``) on the CPU.

* The same random weights (JAX's ``init_random_params(PRNGKey(0))``,
  converted with ``inception_params_from_jax``), the same images: features
  and logits to 1e-4 relative (the largest difference over the largest
  value; 94 convolutions and 15 BatchNorm-and-ReLU chains in float32).
* A synthetic torchvision-layout state dict (as
  ``tests/test_inception_golden.py`` builds one; copied, not imported):
  loaded by the port and by JAX's ``convert_torchvision_state_dict``, in
  memory and from a ``.pth`` file, the two give equal outputs.
* ``preprocess`` against JAX's (``jax.image.resize`` bilinear, then
  ImageNet normalisation) growing 32 -> 299 and shrinking 320 -> 299: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.metrics import inception as J
from itsd_tpu_torch.metrics import inception as P
from itsd_tpu_torch.models import inception_params_from_jax

from _torch_port import one_torch_thread  # noqa: F401

REL_TOL = 1e-4
RESIZE_TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def make_torchvision_state_dict(seed: int = 0) -> dict:
    """torchvision's inception_v3 key layout and shapes, seeded values, the
    auxiliary head's keys included (both loaders drop them)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for path, (kh, kw, cin, cout) in J._inception_conv_specs().items():
        sd[f"{path}.conv.weight"] = (
            torch.randn(cout, cin, kh, kw, generator=g) * 0.05)
        sd[f"{path}.bn.weight"] = 1.0 + 0.1 * torch.randn(cout, generator=g)
        sd[f"{path}.bn.bias"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"{path}.bn.running_mean"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"{path}.bn.running_var"] = (
            1.0 + 0.1 * torch.rand(cout, generator=g))
        sd[f"{path}.bn.num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.02
    sd["fc.bias"] = torch.randn(1000, generator=g) * 0.02
    sd["AuxLogits.conv0.conv.weight"] = torch.randn(128, 768, 1, 1,
                                                    generator=g)
    sd["AuxLogits.fc.weight"] = torch.randn(1000, 768, generator=g)
    return sd


def _images(n, size, seed):
    return np.random.default_rng(seed).random(
        (n, size, size, 3)).astype(np.float32)


def _jax_run(params, x):
    feats, logits = jax.jit(lambda p, a: J.inception_v3(p, J.preprocess(a)))(
        params, jnp.asarray(x))
    return np.asarray(feats), np.asarray(logits)


def _port_run(model, x):
    with torch.inference_mode():
        feats, logits = model(torch.from_numpy(x))
    return feats.numpy(), logits.numpy()


def test_random_weights_match_jax():
    params = J.init_random_params(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = P.inception_from_state_dict(inception_params_from_jax(np_params))
    x = _images(2, 299, 1)
    want_f, want_l = _jax_run(params, x)
    got_f, got_l = _port_run(model, x)
    assert got_f.shape == (2, 2048) and got_l.shape == (2, 1000)
    assert _rel(got_f, want_f) < REL_TOL
    assert _rel(got_l, want_l) < REL_TOL


def test_torchvision_state_dict_loads_as_jax_loads_it(tmp_path):
    sd = make_torchvision_state_dict()
    path = tmp_path / "inception_v3.pth"
    torch.save(sd, path)
    x = _images(1, 64, 2)
    want_f, want_l = _jax_run(J.convert_torchvision_state_dict(sd), x)
    for model in (P.inception_from_state_dict(sd),
                  P.load_torchvision_inception(str(path))):
        got_f, got_l = _port_run(model, x)
        assert _rel(got_f, want_f) < REL_TOL
        assert _rel(got_l, want_l) < REL_TOL
    jax_file = J.load_torchvision_inception(str(path))
    np.testing.assert_array_equal(
        np.asarray(jax_file["fc"]["kernel"]), sd["fc.weight"].numpy().T)
    no_fc = P.inception_from_state_dict(sd, include_fc=False)
    feats, logits = no_fc(torch.from_numpy(x))
    assert logits is None and feats.shape == (1, 2048)


def test_random_init_has_jax_shapes_and_scales():
    """The seeded proxy: JAX's shapes, identity BatchNorm, kernels of
    variance 2/fan_in, fc of variance 1e-4."""
    sd = P.init_random_params(torch.Generator().manual_seed(42))
    ref = inception_params_from_jax(jax.tree_util.tree_map(
        np.asarray, J.init_random_params(jax.random.PRNGKey(0))))
    assert list(sd) == list(ref)
    assert all(sd[k].shape == ref[k].shape for k in sd)
    w = sd["Mixed_7c.branch3x3dbl_2.conv.weight"]
    assert abs(float(w.var()) * 9 * 448 / 2 - 1) < 0.02
    assert abs(float(sd["fc.weight"].std()) / 0.01 - 1) < 0.01
    a = P.init_random_params(torch.Generator().manual_seed(42))
    assert all(torch.equal(a[k], sd[k]) for k in sd)


@pytest.mark.parametrize("size", [32, 320, 299])
def test_preprocess_matches_jax(size):
    x = _images(2, size, 3)
    want = np.asarray(J.preprocess(jnp.asarray(x)))
    got = P.preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)
