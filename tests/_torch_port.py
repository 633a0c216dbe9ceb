"""Shared helpers of the port's tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process, so parallel test workers do not
    oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flax_params(model, x, t, seed, labels=None):
    """A Flax parameter tree for ``model`` (structure from ``eval_shape`` of
    its init, with ``labels`` for a conditional model) with seeded numpy
    values: O(1/sqrt(fan_in)) kernels, GroupNorm scales near 1, biases and
    embedding tables O(0.1)."""
    args = (jnp.asarray(x), jnp.asarray(t))
    if labels is not None:
        args += (jnp.asarray(labels),)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
