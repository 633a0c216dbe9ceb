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


def jax_train_draws(jcfg, steps, label_dropout):
    """The (t, noise, label-dropout mask) JAX's train loop draws in its
    first ``steps`` steps (``runner.make_train_key`` split once a step,
    then into the dropout, t and label keys as ``make_train_step`` does),
    on the batches its ``BatchIterator`` gives, as torch tensors for the
    port's train step."""
    from itsd_tpu.cli import runner as jax_runner
    from itsd_tpu.core.process import diffusion_train_terms
    from itsd_tpu.core.schedules import linear_schedule
    from itsd_tpu.data import BatchIterator

    images, labels = jax_runner.load_dataset(jcfg)
    key = jax_runner.make_train_key(jcfg)
    sched = linear_schedule(jcfg.diffusion.beta_1, jcfg.diffusion.beta_T,
                            jcfg.diffusion.T)
    batches = iter(BatchIterator(images, labels, jcfg.train.batch_size,
                                 seed=jcfg.data.seed))
    draws = []
    for _ in range(steps):
        key, skey = jax.random.split(key)
        _, tkey, lkey = jax.random.split(skey, 3)
        b = next(batches)
        t, noise, _ = diffusion_train_terms(sched, tkey,
                                            jnp.asarray(b["image"]))
        drop = jax.random.uniform(lkey, b["label"].shape) < label_dropout
        draws.append((torch.from_numpy(np.array(t)).long(),
                      torch.from_numpy(np.array(noise)),
                      torch.from_numpy(np.array(drop))))
    return draws
