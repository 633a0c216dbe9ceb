"""The port's data axis (``itsd_tpu_torch/parallel``) at two gloo ranks on
the CPU, against the JAX package on a 2-device data mesh of the virtual CPU
devices (tests/conftest.py) and against the port in one process.

Two worker processes (tests/_torch_dist_worker.py) start a process group
on a free localhost port and run every case once (the ``ranks`` fixture,
each worker under its own time limit, killed when it passes it); the tests
read what they wrote. The one-process references run here, through the
same case functions.

Tolerances (float32):
* Train steps against JAX (the settings of tests/test_torch_train.py and
  tests/test_torch_guidance.py: lr 1e-3, weight decay 0.5, the clip acting
  at every step; the UNet's dropout at the configs' 0.1; t, the noise, the
  label-dropout masks and Flax's dropout masks JAX's, injected): loss and
  gradient norm 1e-5 relative; params and EMA all but 5e-4 of the elements
  within 2e-6 and none beyond 5e-4, except the tensors whose exact gradient
  is 0, within 1e-2 (Adam's update is ~lr whatever the gradient's size).
* The same steps at two ranks against one process: the global mean (or
  sum over B^2) sums the two ranks' halves in another order than one
  process does, ~1e-7 relative; the same limits.
* Searches and Picard against one process: the same arithmetic on fewer
  rows, 1e-5 absolute on values O(1); selections equal. Against JAX: the
  limits of tests/test_torch_search.py and tests/test_parallel_sampling.py.
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import stochastic as flax_stochastic

from itsd_tpu import core as JC
from itsd_tpu.core.process import diffusion_train_terms as jax_train_terms
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.parallel import (candidate_sharding, make_mesh, replicated,
                               shard_batch)
from itsd_tpu.search import algorithms as J
from itsd_tpu.train import OptimizerConfig as JaxOptimizerConfig
from itsd_tpu.train import create_train_state as jax_create_train_state
from itsd_tpu.train import make_optimizer as jax_make_optimizer
from itsd_tpu.train import make_train_step as jax_make_train_step
from itsd_tpu_torch import core as PC
from itsd_tpu_torch import parallel
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.models import params_from_jax
from itsd_tpu_torch.utils import load_config

import _torch_dist_worker as worker
from _torch_port import flax_params, one_torch_thread  # noqa: F401

WORKER_TIMEOUT = 180  # seconds, each worker
OPT = dict(lr=1e-3, weight_decay=0.5, grad_clip=1.0, multiplier=2.0,
           epochs=3, steps_per_epoch=1)
PARAM_TOL, PARAM_OUTLIERS, PARAM_MAX, NOISE_MAX = 2e-6, 5e-4, 5e-4, 1e-2
TOL = 1e-5
COND = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.1, T=20,
            num_labels=10)
UNCOND = dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
              dropout=0.1, dtype="float32")
ALGORITHMS = ["random", "zero_order", "path", "pruned", "smc", "gradient"]
SHAPE = (2, 4, 4, 3)
SEARCH_T = 20
TINY = ["channel=16", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
        "T=10", "img_size=8", "data.dataset=shapes",
        "train.track_metrics=false", "data.use_full_dataset=false",
        "data.train_subset_ratio=0.005", "train.eval_batch_size=2",
        "train.batch_size=4", "train.epoch=1", "train.eval_freq=1",
        "model.dropout=0.1"]
COND_TRAIN = ["model.num_labels=10", "w=1.8",
              "train.extract_representation_freq=1"]
SEARCH = ["channel=16", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
          "T=10", "img_size=8", "data.dataset=shapes",
          "train.eval_batch_size=2", "search.algorithm=random",
          "search.n_candidates=4", "search.verifier=self_supervised"]
# the CFG model through run_search at 2 labels a candidate, where a rank
# holds one row of a candidate: random with chunks of 1 (2 rows), pruned
# down to 1 survivor (2 rows), gradient (2 rows)
CFG = ["model.num_labels=10", "w=1.8"]
CFG_SEARCH = {
    "random_chunk_1": CFG + ["search.n_candidates=2",
                             "search.candidate_chunk=1"],
    "pruned": CFG + ["search.algorithm=pruned", "search.n_candidates=4",
                     "search.prune_schedule=[[6,2],[3,1]]"],
    "gradient": CFG + ["search.algorithm=gradient", "search.n_iterations=2",
                       "search.gradient_lr=0.05"]}


def _jax_keys(i):
    key = jax.random.PRNGKey(300 + i)
    return key, jax.random.split(key, 3)


JAX_CASES = {
    "jax_cond": ("cond", COND, COND["T"],
                 dict(conditional=True, loss_reduction="sum_div_b2",
                      label_dropout=0.4, ema_decay=0.999)),
    "jax_uncond": ("uncond", UNCOND, 100,
                   dict(loss_weighting="min_snr", ema_decay=0.999))}


def _jax_dropout_masks(jm, params, steps):
    """For each ``(args, dkey)`` of ``steps``, the keep masks Flax's
    dropout draws in a forward of JAX's train step on ``args`` from its
    dropout key ``dkey``, in call order, NCHW. The masks depend only on the
    key and the shapes, so forwards that return them (jitted: the rest is
    dead code) record the ones the sharded step draws."""
    def masks(params, steps):
        got = []

        def bernoulli(*a, **kw):
            got[-1].append(jax.random.bernoulli(*a, **kw))
            return got[-1][-1]

        with mock.patch.object(flax_stochastic, "random",
                               types.SimpleNamespace(bernoulli=bernoulli)):
            for args, dkey in steps:
                got.append([])
                jm.apply(params, *args, deterministic=False,
                         rngs={"dropout": dkey})
        return got

    return [[torch.from_numpy(np.array(m)).permute(0, 3, 1, 2).contiguous()
             for m in step] for step in jax.jit(masks)(params, steps)]


def _train_inputs():
    """The train-step cases (the workers' inputs): JAX's seeded params,
    batches and draws (t, the noise, the label-dropout mask, the UNet's
    dropout masks) for the JAX cases; a seeded init and a seeded generator
    for "seeded"."""
    rng = np.random.default_rng(21)
    x0 = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    raw = np.array([0, 6, 9, 3], np.int32)
    cases, jax_params = {}, {}
    for name, (kind, kw, T, step_kw) in JAX_CASES.items():
        cond = kind == "cond"
        jm = JaxUNet((jax_cond_config if cond else jax_uncond_config)(**kw))
        params = flax_params(jm, x0, np.zeros(4, np.int32), 10,
                             raw if cond else None)
        jax_params[name] = (jm, params)
        draws, forwards = [], []
        for i in range(2):
            _, (dkey, tkey, lkey) = _jax_keys(i)
            t, noise, x_t = jax_train_terms(JC.linear_schedule(1e-4, 0.02,
                                                               T),
                                            tkey, jnp.asarray(x0))
            drop = (torch.from_numpy(np.array(
                jax.random.uniform(lkey, raw.shape) < 0.4)) if cond
                else None)
            draws.append((torch.from_numpy(np.array(t)).long(),
                          torch.from_numpy(np.array(noise)), drop))
            forwards.append(((x_t, t) + ((jnp.asarray(raw) + 1,) if cond
                                         else ()), dkey))
        batch = {"image": x0, "label": raw} if cond else {"image": x0}
        cases[name] = dict(
            model=(kind, kw), opt=OPT, T=T, step=step_kw, seed=None,
            params=params_from_jax(params, worker.build_unet((kind,
                                                               kw)).cfg),
            draws=draws, masks=_jax_dropout_masks(jm, params, forwards),
            batches=[{k: torch.from_numpy(v) for k, v in batch.items()}] * 2)
    # draws from a seeded generator, the UNet's dropout at 0.1
    cases["seeded"] = dict(
        model=("cond", COND), params=None, opt=OPT,
        T=COND["T"], seed=5, draws=None, masks=None,
        step=dict(conditional=True, label_dropout=0.4, ema_decay=0.999),
        batches=[{"image": torch.from_numpy(
            rng.standard_normal((4, 8, 8, 3)).astype(np.float32)),
                  "label": torch.from_numpy(raw)} for _ in range(2)])
    return cases, jax_params


def _jax_train(cases, jax_params):
    """JAX's two steps of each JAX case on a 2-device data mesh: the
    metrics, the params and the EMA, in the port's layout."""
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    out = {}
    for name, (kind, kw, T, step_kw) in JAX_CASES.items():
        jm, params = jax_params[name]
        tx = jax_make_optimizer(JaxOptimizerConfig(**OPT))
        jstate = jax.device_put(jax_create_train_state(params, tx),
                                replicated(mesh))
        jstep = jax_make_train_step(
            lambda p, *a, **k: jm.apply(p, *a, **k),
            JC.linear_schedule(1e-4, 0.02, T), tx, donate=False, **step_kw)
        batch = {k: v.numpy() for k, v in cases[name]["batches"][0].items()}
        metrics = []
        for i in range(2):
            key, _ = _jax_keys(i)
            jstate, m = jstep(jstate, shard_batch(batch, mesh), key)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        tcfg = worker.build_unet((kind, kw)).cfg
        out[name] = dict(
            metrics=metrics,
            params=params_from_jax(jax.device_get(jstate.params), tcfg),
            ema=params_from_jax(jax.device_get(jstate.ema_params), tcfg))
    return out


def _search_inputs():
    rng = np.random.default_rng(31)
    key, n = jax.random.PRNGKey(4), 4
    kn, kd = jax.random.split(key)
    noises = jax.random.normal(kn, (n,) + SHAPE)
    chain = []
    for _ in range(SEARCH_T):
        kd, nkey = jax.random.split(kd)
        chain.append(torch.from_numpy(np.array(jax.random.normal(
            nkey, (n * SHAPE[0],) + SHAPE[1:]))))
    return dict(
        T=SEARCH_T, shape=SHAPE, pruned_shape=(1,) + SHAPE[1:],
        algorithms=ALGORITHMS,
        pattern=torch.from_numpy(rng.uniform(-0.6, 0.6, SHAPE[1:]).astype(
            np.float32)),
        pivot=torch.from_numpy(rng.standard_normal(SHAPE).astype(
            np.float32)),
        jax_draws={("candidates",): torch.from_numpy(np.array(noises)),
                   ("denoise", 0): chain},
        jax_key=key)


def _picard_inputs():
    x_T = jax.random.normal(jax.random.PRNGKey(0), (1, 4, 4, 3))
    return dict(T=200, n=8, x_T=torch.from_numpy(np.array(x_T)))


def _cfg_picard_inputs():
    """3 grid points of 2 images: each rank's 3 rows split a point's."""
    x_T = np.random.default_rng(41).standard_normal((2, 8, 8, 3))
    return dict(model=("cond", COND), T=COND["T"], n=3,
                labels=torch.tensor([3, 8]),
                x_T=torch.from_numpy(x_T.astype(np.float32)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, the inputs and JAX's train results."""
    out = tmp_path_factory.mktemp("ranks")
    cases, jax_params = _train_inputs()
    search = _search_inputs()
    inputs = dict(train=cases, search={k: v for k, v in search.items()
                                       if k != "jax_key"},
                  picard=_picard_inputs(), cfg_picard=_cfg_picard_inputs(),
                  runner=dict(overrides=TINY, search=SEARCH,
                              cond=COND_TRAIN, cfg_search=CFG_SEARCH))
    torch.save(inputs, out / "inputs.pt")
    # JAX's steps compile while the workers run
    jax_out, got, logs = worker.run_ranks(
        out, "data", WORKER_TIMEOUT, lambda: _jax_train(cases, jax_params))
    return dict(got=got, inputs=inputs, jax_train=jax_out, dir=out,
                search_key=search["jax_key"], logs=logs)


def _check_params(got, want, grads_zero):
    diff = {k: (got[k].detach() - w).abs().flatten() for k, w in want.items()}
    real = torch.cat([d for k, d in diff.items() if k not in grads_zero])
    assert (real > PARAM_TOL).float().mean().item() <= PARAM_OUTLIERS
    assert real.max().item() <= PARAM_MAX
    assert max((diff[k].max().item() for k in grads_zero),
               default=0.0) <= NOISE_MAX


def _one_process(ranks, name):
    """The case run in this process on the global batch."""
    return worker.train_steps(ranks["inputs"]["train"][name], None,
                              lambda a: a)


# ---------------------------------------------------------------------------
# the process group and the row helpers


def test_mesh_helpers_at_two_gloo_ranks(ranks):
    """The group starts (and a second call finds it up: False); rows split
    and gather back in rank order; a world size that does not divide the
    rows raises; replicate broadcasts rank 0's weights."""
    for r, got in enumerate(ranks["got"]):
        m = got["mesh"]
        assert m["started"] is True and m["again"] is False
        assert (m["world_size"], m["rank"], m["is_main"]) == (2, r, r == 0)
        assert torch.equal(m["gathered"], torch.arange(8.0).reshape(4, 2))
        assert "2 ranks do not divide the 3 rows" in m["odd_rows"]
        assert torch.equal(m["replicated"], torch.zeros(2, 3))


def test_without_a_launcher_nothing_starts(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "ITSD_MULTIHOST"):
        monkeypatch.delenv(v, raising=False)
    assert parallel.maybe_initialize_distributed(device="cpu") is False
    assert (parallel.world_size(), parallel.rank(), parallel.is_main()) == (
        1, 0, True)
    assert parallel.data_group() is None
    x = torch.arange(6.0)
    assert torch.equal(parallel.local_rows(x), x)
    assert torch.equal(parallel.gather_rows(x), x)


def test_initialize_distributed_raises_on_genuine_failure(monkeypatch,
                                                          capsys):
    """A failed start raises (and says so on stderr); only a group that is
    already up returns False, as JAX's hook."""
    def boom(*a, **kw):
        raise RuntimeError("connection to the store timed out")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="timed out"):
        parallel.maybe_initialize_distributed(
            device="cpu", init_method="tcp://localhost:1", world_size=2,
            rank=0)
    assert "init_process_group FAILED" in capsys.readouterr().err
    monkeypatch.setenv("ITSD_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="timed out"):
        parallel.maybe_initialize_distributed(device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    assert parallel.maybe_initialize_distributed(
        device="cpu", init_method="tcp://localhost:1", world_size=2,
        rank=0) is False


def test_a_bad_rendezvous_raises():
    """A real failure, no stub: an init method with no handler."""
    with pytest.raises(RuntimeError, match="No rendezvous handler"):
        parallel.maybe_initialize_distributed(
            device="cpu", init_method="nosuch://x", world_size=2, rank=0)


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("name", ["jax_cond", "jax_uncond"])
def test_dp_train_steps_match_jax_on_a_two_device_mesh(ranks, name):
    """Two steps at two ranks against JAX's step on a 2-device data mesh:
    conditional with the sum / B^2 loss and JAX's label-dropout masks, and
    unconditional with min-SNR weighting, both with the UNet's dropout at
    0.1 on Flax's masks. Both ranks hold the same weights."""
    want = ranks["jax_train"][name]
    zero = _one_process(ranks, name)["tiny_grads"]
    for got in ranks["got"]:
        g = got["train"][name]
        for (gl, gn), (wl, wn) in zip(g["metrics"], want["metrics"]):
            np.testing.assert_allclose(gl, wl, rtol=1e-5)
            np.testing.assert_allclose(gn, wn, rtol=1e-5)
        _check_params(g["params"], want["params"], zero)
        _check_params(g["ema"], want["ema"], zero)
    for k, v in ranks["got"][0]["train"][name]["params"].items():
        assert torch.equal(v, ranks["got"][1]["train"][name]["params"][k]), k


@pytest.mark.parametrize("name", ["jax_cond", "jax_uncond", "seeded"])
def test_dp_train_steps_equal_one_process(ranks, name):
    """The same steps at two ranks and in one process on the global batch:
    "seeded" draws t, the noise, the label-dropout uniforms and the UNet's
    dropout masks (rate 0.1) from one seeded generator, for the global
    batch, on every rank."""
    ref = _one_process(ranks, name)
    zero = ref["tiny_grads"]
    for got in ranks["got"]:
        g = got["train"][name]
        for (gl, gn), (wl, wn) in zip(g["metrics"], ref["metrics"]):
            np.testing.assert_allclose(gl, wl, rtol=1e-5)
            np.testing.assert_allclose(gn, wn, rtol=1e-5)
        _check_params(g["params"], ref["params"], zero)
        _check_params(g["ema"], ref["ema"], zero)


def test_dp_train_steps_with_ring_from_the_environment(ranks):
    """ITSD_ATTN_IMPL=ring at two data ranks, each on its own batch rows:
    the step runs under its layout (seq groups of one), so the ring is
    each rank's local attention and the steps equal one process's."""
    ref = _one_process(ranks, "jax_uncond")
    zero = ref["tiny_grads"]
    for got in ranks["got"]:
        g = got["train_ring_env"]
        for (gl, gn), (wl, wn) in zip(g["metrics"], ref["metrics"]):
            np.testing.assert_allclose(gl, wl, rtol=1e-5)
            np.testing.assert_allclose(gn, wn, rtol=1e-5)
        _check_params(g["params"], ref["params"], zero)
        _check_params(g["ema"], ref["ema"], zero)


def test_runner_train_writes_on_rank_0_only(ranks):
    """runner.train at two ranks: checkpoints, train_metrics.jsonl and the
    grid under rank 0's directories, nothing under rank 1's; both ranks
    return the same losses, the one-process run's on the same config."""
    out = ranks["dir"]
    r0, r1 = out / "r0", out / "r1"
    assert (r0 / "ckpt" / "ckpt_0").is_file()
    assert (r0 / "metrics" / "train_metrics.jsonl").is_file()
    assert (r0 / "sampled" / "epoch_0_sampled.png").is_file()
    assert not (r1 / "ckpt").exists()
    assert not (r1 / "metrics" / "train_metrics.jsonl").exists()
    assert not (r1 / "sampled").exists()
    got = [g["runner_train"]["losses"] for g in ranks["got"]]
    assert got[0] == got[1] and len(got[0]) == 2
    cfg = load_config(None, TINY + [f"save_weight_dir={out}/one/ckpt",
                                    f"metrics_save_dir={out}/one/metrics",
                                    f"sampled_dir={out}/one/sampled"])
    want = runner.train(cfg, max_steps=2, device="cpu")["losses"]
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


def test_runner_train_gathers_representations_on_rank_0(ranks):
    """The conditional model's representations, one forward a batch:
    rank 0's .npz holds the global batch's rows, as the one-process run's
    (the same weights up to the global mean's summation order); rank 1
    writes none."""
    out = ranks["dir"]
    got = np.load(out / "r0" / "cond_ckpt" / "representations" /
                  "epoch_0.npz")
    assert not (out / "r1" / "cond_ckpt").exists()
    cfg = load_config(None, TINY + COND_TRAIN + [
        f"save_weight_dir={out}/one/cond_ckpt",
        f"metrics_save_dir={out}/one/cond_metrics",
        f"sampled_dir={out}/one/cond_sampled"])
    runner.train(cfg, max_steps=2, device="cpu")
    want = np.load(out / "one" / "cond_ckpt" / "representations" /
                   "epoch_0.npz")
    assert got["representations"].shape == (8, 16)  # 2 batches of 4, C
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["representations"],
                               want["representations"], atol=TOL)


def test_a_batch_the_world_size_does_not_divide_raises(ranks):
    for got in ranks["got"]:
        msg = got["runner_train"]["odd_batch"]
        assert "train.batch_size=3" in msg and "world size 2" in msg


# ---------------------------------------------------------------------------
# search and Picard


@pytest.mark.parametrize("name", ALGORITHMS)
def test_sharded_search_equals_unsharded(ranks, name):
    """Each algorithm at two ranks against one process on the same seeded
    draws: the same best score and images, the same score history."""
    inp = dict(ranks["inputs"]["search"])
    inp["jax_draws"] = worker.Draws(inp["jax_draws"])
    want = worker.searches({"search": dict(inp, algorithms=[name])},
                           None)[name]
    assert set(want["history"]) == set(ranks["got"][0]["search"][name][
        "history"])
    for got in ranks["got"]:
        g = got["search"][name]
        np.testing.assert_allclose(float(g["best_score"]),
                                   float(want["best_score"]), atol=TOL)
        np.testing.assert_allclose(g["best_images"].numpy(),
                                   want["best_images"].numpy(), atol=TOL)
        for k, w in want["history"].items():
            gk = g["history"][k]
            if isinstance(w, list):
                for a, b in zip(gk, w):
                    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                               atol=TOL)
            elif w.dtype == torch.bool:
                assert torch.equal(gk, w), k
            else:
                np.testing.assert_allclose(gk.numpy(), w.numpy(), atol=TOL)


def test_sharded_random_search_matches_jax_on_a_two_device_mesh(ranks):
    """Random search at two ranks on JAX's draws against JAX's
    random_search with its candidates sharded over a 2-device mesh."""
    sched = JC.linear_schedule(1e-4, 0.02, SEARCH_T)
    pattern = jnp.asarray(ranks["inputs"]["search"]["pattern"].numpy())

    def eps_fn(x, t):
        ab = sched.alphas_bar[t].reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.sqrt(1.0 - ab) * x / (ab * 0.25 + (1.0 - ab))

    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])

    @jax.jit
    def run(k):
        r = J.random_search(k, SHAPE, lambda x, kk: JC.sample(
            sched, eps_fn, x, kk), lambda im: -jnp.mean((im - pattern) ** 2),
            n_candidates=4, sharding=candidate_sharding(mesh))
        return r.best_score, r.best_images, r.history["scores"]

    ws, wi, wsc = run(ranks["search_key"])
    for got in ranks["got"]:
        g = got["search"]["random_jax_draws"]
        np.testing.assert_allclose(g["scores"].numpy(), np.asarray(wsc),
                                   atol=TOL)
        np.testing.assert_allclose(float(g["best_score"]), float(ws),
                                   atol=TOL)
        np.testing.assert_allclose(g["best_images"].numpy(), np.asarray(wi),
                                   atol=TOL)


def test_sharded_run_search_equals_one_process(ranks, capsys):
    """runner.run_search under the group splits its 8 candidate rows over
    the two ranks (JAX's condition) and finds the one-process winner."""
    cfg = load_config(None, SEARCH + [f"sampled_dir={ranks['dir']}/one"])
    model, _ = runner.build_model(cfg)
    want = runner.run_search(cfg, params=runner.init_params(cfg, model),
                             device="cpu")
    assert "sharding" not in capsys.readouterr().out
    assert "[search] sharding 8 candidate rows over 2 devices" in \
        ranks["logs"][0]
    assert "[search] sharding" not in ranks["logs"][1]
    for got in ranks["got"]:
        g = got["run_search"]
        np.testing.assert_allclose(g["scores"], want["result"].history[
            "scores"], atol=TOL)
        np.testing.assert_allclose(g["best_score"], want["best_score"],
                                   atol=TOL)
        np.testing.assert_allclose(g["best_images"].numpy(),
                                   want["result"].best_images.numpy(),
                                   atol=TOL)
    assert (ranks["dir"] / "r0" / "sampled" /
            "search_random_best.png").is_file()
    assert not (ranks["dir"] / "r1" / "sampled").exists()


@pytest.mark.parametrize("name", list(CFG_SEARCH))
def test_sharded_cfg_run_search_equals_one_process(ranks, name):
    """The CFG model's guided search with fewer rows on a rank than labels
    in a candidate: each row keeps the label of its global row (the labels
    tiled over the global fold, as JAX's), so the result is the
    one-process run's."""
    want = worker.run_search(SEARCH + CFG_SEARCH[name] + [
        f"sampled_dir={ranks['dir']}/one_cfg_{name}"])
    rows = {"random_chunk_1": 2, "pruned": 8, "gradient": 2}[name]
    assert f"[search] sharding {rows} candidate rows over 2 devices" in \
        ranks["logs"][0]
    for got in ranks["got"]:
        g = got["cfg_search"][name]
        np.testing.assert_allclose(np.asarray(g["scores"]),
                                   np.asarray(want["scores"]), atol=TOL)
        np.testing.assert_allclose(g["best_score"], want["best_score"],
                                   atol=TOL)
        np.testing.assert_allclose(g["best_images"].numpy(),
                                   want["best_images"].numpy(), atol=TOL)


def test_sharded_cfg_picard_equals_one_process(ranks):
    """Picard on the guided eps_fn, 6 grid rows of 2 labels split 3 and 3:
    each rank's rows keep their global rows' labels."""
    want = worker.cfg_picard(ranks["inputs"]["cfg_picard"], None)
    for got in ranks["got"]:
        g = got["cfg_picard"]
        assert g["sweeps"] == want["sweeps"]
        np.testing.assert_allclose(g["x"].numpy(), want["x"].numpy(),
                                   atol=TOL)


def test_sharded_picard_equals_one_process_and_jax(ranks):
    """Each sweep's 8 grid rows split over the two ranks: the one-process
    run's sweeps and output, and JAX's with its grid sharded over a
    2-device mesh (tests/test_parallel_sampling.py's harness)."""
    p = ranks["inputs"]["picard"]
    sched = PC.linear_schedule(1e-4, 0.02, p["T"], device="cpu")
    want, sweeps = PC.parallel_picard_sample(
        sched, worker.analytic_eps(sched, 0.5), p["x_T"], num_steps=p["n"],
        tol=1e-5, clip_output=False)
    jsched = JC.linear_schedule(1e-4, 0.02, p["T"])

    def jeps(x, t):
        ab = jsched.alphas_bar[t].reshape(-1, 1, 1, 1)
        return jnp.sqrt(1.0 - ab) * x / (ab * 0.25 + (1.0 - ab))

    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    jx, jit_ = jax.jit(lambda x, k: JC.parallel_picard_sample(
        jsched, jeps, x, k, num_steps=p["n"], tol=1e-5, clip_output=False,
        sharding=candidate_sharding(mesh)))(jnp.asarray(p["x_T"].numpy()),
                                            jax.random.PRNGKey(0))
    for got in ranks["got"]:
        g = got["picard"]
        assert g["sweeps"] == sweeps == int(jit_)
        np.testing.assert_allclose(g["x"].numpy(), want.numpy(), atol=TOL)
        np.testing.assert_allclose(g["x"].numpy(), np.asarray(jx),
                                   atol=TOL)
