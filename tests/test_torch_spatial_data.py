"""Spatial sharding composed with data parallelism: four gloo ranks on the
CPU as data = 2 by seq = 2 (``parallel.make_seq_mesh``), each holding the
image rows of its seq index of its data index's batch rows, against the
port in one process. tests/test_torch_spatial.py holds two ranks (seq = 2
alone) against JAX; here what only a data axis beside the seq axis
exercises: the groups of the layout, the loss weights (1/W for the mean,
1/D^2 for the sum over b^2, D = W/K the data ranks), a guided batch split
over the data ranks (each row's label from its global row) and the ring's
global view over a registered layout.

Four worker processes (tests/_torch_dist_worker.py, suite "spatial_data")
run every case once (the ``ranks`` fixture). Tolerances (float32) are
those of tests/test_torch_spatial.py: 1e-5, and params rtol 2e-4 / atol
2e-6 but for the tensors whose exact gradient is 0 (2 lr a step).
"""

import numpy as np
import pytest
import torch

from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.kernels import attention
from itsd_tpu_torch.utils import load_config

import _torch_dist_worker as worker
from _torch_port import one_torch_thread  # noqa: F401

WORKER_TIMEOUT = 180  # seconds, each worker
WORLD = 4
TOL = 1e-5
OPT = dict(lr=1e-5, epochs=2, steps_per_epoch=4)
NOISE_MAX = 2 * 2 * OPT["lr"]
UNCOND = dict(ch=16, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
              dropout=0.1)
COND = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0, T=20,
            num_labels=10)
TINY = ["channel=16", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
        "T=10", "img_size=8", "data.dataset=shapes",
        "train.track_metrics=false", "data.use_full_dataset=false",
        "data.train_subset_ratio=0.005", "train.eval_batch_size=4",
        "train.batch_size=4", "train.epoch=1", "train.eval_freq=1",
        "model.dropout=0.1"]
CFG = TINY + ["model.num_labels=10", "w=1.8"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(rng):
    """Train cases (seeded inits and generators: the unconditional UNet at
    dropout 0.1 with the mean loss, the conditional one with the sum over
    b^2 and label dropout), a guided model's weights, attention inputs."""
    raw = torch.from_numpy(np.array([0, 6, 9, 3], np.int32))
    train = {
        "uncond_mean": dict(
            model=("uncond", UNCOND), params=None, opt=OPT, T=100, seed=5,
            draws=None, masks=None, step=dict(ema_decay=0.999),
            batches=[{"image": _t(rng.standard_normal((4, 8, 8, 3)))}
                     for _ in range(2)]),
        "cond_sum_div_b2": dict(
            model=("cond", COND), params=None, opt=OPT, T=COND["T"], seed=6,
            draws=None, masks=None,
            step=dict(conditional=True, loss_reduction="sum_div_b2",
                      label_dropout=0.4, ema_decay=0.999),
            batches=[{"image": _t(rng.standard_normal((4, 8, 8, 3))),
                      "label": raw} for _ in range(2)])}
    cfg = load_config(None, CFG)
    model, _ = runner.build_model(cfg)
    return dict(train=train, overrides=TINY, cfg_overrides=CFG,
                cfg_params=runner.init_params(cfg, model),
                image=_t(rng.standard_normal((4, 8, 8, 3))),
                qkv=[_t(rng.standard_normal((2, 16, 8))) for _ in range(3)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial_data")
    inputs = {"spatial_data": _inputs(np.random.default_rng(29))}
    torch.save(inputs, out / "inputs.pt")
    _, got, logs = worker.run_ranks(out, "spatial_data", WORKER_TIMEOUT,
                                    world=WORLD)
    return dict(got=got, inputs=inputs["spatial_data"], dir=out)


def test_layout_of_four_ranks(ranks):
    """Rank r sits at (r // 2, r % 2); a global batch cut to each rank's
    block and gathered comes back whole on every rank."""
    for r, got in enumerate(ranks["got"]):
        assert got["mesh"] == (2, 2, r // 2, r % 2)
        assert torch.equal(got["gathered"], ranks["inputs"]["image"])


@pytest.mark.parametrize("name", ["uncond_mean", "cond_sum_div_b2"])
def test_train_steps_over_data_and_seq_equal_one_process(ranks, name):
    """Two steps with the batch rows over 2 data ranks and the image rows
    over 2 seq ranks (draws for the global batch and images, the UNet's
    dropout at 0.1 from the generator) against one process on the whole
    batch: the loss weights make the global batch's loss and gradient."""
    ref = worker.train_steps(ranks["inputs"]["train"][name], None,
                             lambda a: a)
    zero = ref["tiny_grads"]
    for got in ranks["got"]:
        g = got["train"][name]
        np.testing.assert_allclose(g["metrics"], ref["metrics"], rtol=1e-5)
        for part in ("params", "ema"):
            for k, w in ref[part].items():
                if k in zero:
                    assert (g[part][k] - w).abs().max().item() <= NOISE_MAX
                else:
                    np.testing.assert_allclose(
                        g[part][k].numpy(), w.numpy(), rtol=2e-4,
                        atol=2e-6, err_msg=k)


def test_guided_evaluate_over_data_and_seq_equals_one_process(ranks,
                                                              tmp_path):
    """The CFG model's evaluate with train.spatial_shard=2 at four ranks:
    its batch of 4 splits over the 2 data ranks (each row guided by its
    global row's label) and its rows over the seq ranks; the images
    gathered equal the one-process run's."""
    inp = ranks["inputs"]
    cfg = load_config(None, inp["cfg_overrides"] + [
        f"sampled_dir={tmp_path}"])
    want = runner.evaluate(cfg, params=inp["cfg_params"],
                           device="cpu")["images"]
    for got in ranks["got"]:
        np.testing.assert_allclose(got["evaluate"], want, atol=TOL,
                                   rtol=TOL)


def test_runner_train_over_data_and_seq_equals_one_process(ranks):
    out = ranks["dir"]
    cfg = load_config(None, TINY + [f"save_weight_dir={out}/one/ckpt",
                                    f"metrics_save_dir={out}/one/metrics",
                                    f"sampled_dir={out}/one/sampled"])
    want = runner.train(cfg, max_steps=2, device="cpu")["losses"]
    for got in ranks["got"]:
        np.testing.assert_allclose(got["runner_train"], want, rtol=TOL)


def test_ring_global_view_over_a_registered_layout(ranks):
    """impl="ring" under a registered (2, 2) layout: each seq group splits
    the tokens of the whole batch; every rank gets one device's output."""
    q, k, v = ranks["inputs"]["qkv"]
    want = attention.attention_plain(q, k, v, 8 ** -0.5)
    for got in ranks["got"]:
        np.testing.assert_allclose(got["ring"].numpy(), want.numpy(),
                                   atol=TOL, rtol=TOL)
