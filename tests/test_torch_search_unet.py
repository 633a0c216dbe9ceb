"""Search through the port's entry points on small UNets, and on the trained
artifacts against the JAX package's ``run_search``.

* ``python -m itsd_tpu_torch.cli.main search`` on the CPU with a tiny
  unconditional UNet and a tiny conditional one guided by CFG (w=1.8), for
  every algorithm and every ported verifier (oracle, self_supervised,
  aesthetic, classifier on a seeded SmallCNN checkpoint): exit 0, a finite
  best score, the NFE of JAX's accounting (``itsd_tpu.search.algorithms``'
  ``*_nfes`` functions and its runner's formulas), the winner's grid.
* ``Trainer.search``; exit 2 for the clip and ensemble verifiers (not yet
  ported); the runner's ValueErrors, as JAX raises them.
* ``search.candidate_chunk``: the same injected candidates, chunked or
  not, give the same scores and winner; a NaN-scoring chunk never wins.
* ``artifacts/shapes32_uncond`` scored by ``artifacts/classifier_shapes32``
  (both restored in memory, the classifier written as a torch checkpoint
  under the test's tmp dir): random search, N=4 over DDIM 10 at eta 0, on
  JAX's candidate noises, against JAX's ``run_search``. Tolerance 2e-3
  absolute on the scores (mean log-probabilities, |score| up to ~55):
  each UNet eps differs by ~1e-6 (test_torch_artifacts.py), DDIM's first
  x0 divides it by sqrt(abar_999) = 6.4e-3 and the classifier's logits
  carry it on; measured 1.9e-5. The winner must be JAX's (its margin over
  the second is 4.0 here).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.cli import runner as jax_runner
from itsd_tpu.core.sampling import segment_cost as jax_segment_cost
from itsd_tpu.search import algorithms as JA
from itsd_tpu.train.checkpoint import restore_params as jax_restore_params
from itsd_tpu.utils import load_config as jax_load_config
from itsd_tpu_torch.cli import main as cli_main
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.models import (ClassifierConfig, SmallCNN,
                                   classifier_params_from_jax,
                                   params_from_jax, save_classifier,
                                   uncond_unet_config)
from itsd_tpu_torch.train.trainer import Trainer
from itsd_tpu_torch.utils import load_config

from _torch_port import one_torch_thread  # noqa: F401

ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "artifacts")
T = 10
TINY = ["channel=16", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
        f"T={T}", "img_size=8", "train.eval_batch_size=2",
        "data.dataset=shapes"]
MODELS = {"uncond": [], "cfg": ["model.num_labels=10", "w=1.8"]}
ALGOS = {
    "random": ["search.n_candidates=4"],
    "random_chunked": ["search.n_candidates=4", "search.candidate_chunk=2"],
    "zero_order": ["search.algorithm=zero_order", "search.n_neighbors=2",
                   "search.n_iterations=2", "search.neighbor_mode=shell"],
    "path": ["search.algorithm=path", "search.n_paths=4",
             "search.n_active=2", "search.injection_steps=[6,3]",
             "search.delta_f=2"],
    "path_ddim": ["search.algorithm=path", "search.n_paths=2",
                  "search.n_active=1", "search.injection_steps=[5]",
                  "search.delta_f=2", "diffusion.sampler=ddim",
                  "diffusion.ddim_steps=5"],
    "pruned": ["search.algorithm=pruned", "search.n_candidates=4",
               "search.prune_schedule=[[6,3],[3,2]]"],
    "pruned_dpm": ["search.algorithm=pruned", "search.n_candidates=3",
                   "search.prune_schedule=[[5,1]]", "diffusion.sampler=dpm",
                   "diffusion.ddim_steps=4"],
    "smc": ["search.algorithm=smc", "search.n_candidates=4",
            "search.smc_resample_steps=[7,3]", "search.smc_lambda=50"],
    "smc_spread": ["search.algorithm=smc", "search.n_candidates=3",
                   "search.smc_resample_steps=[5]",
                   "search.smc_lambda_scale=spread",
                   "diffusion.sampler=ddim", "diffusion.ddim_steps=5"],
    "gradient": ["search.algorithm=gradient", "search.n_iterations=2",
                 "search.gradient_lr=0.05"],
    "gradient_dpm": ["search.algorithm=gradient", "search.n_iterations=2",
                     "diffusion.sampler=dpm", "diffusion.ddim_steps=4"],
}
VERIFIERS = ["oracle", "self_supervised", "aesthetic", "classifier"]
# every algorithm on both models, the verifiers rotating so that each model
# meets each verifier
CASES = [(m, a, VERIFIERS[(i + j) % len(VERIFIERS)])
         for j, m in enumerate(MODELS) for i, a in enumerate(ALGOS)]


def _expected_nfes(cfg):
    """NFE by JAX's accounting for ``cfg.search``."""
    s, d = cfg.search, cfg.diffusion
    cost = (jax_segment_cost(T, d.sampler, min(d.ddim_steps, T))
            if d.sampler in ("ddim", "dpm") else None)
    if s.algorithm == "random":
        return s.n_candidates
    if s.algorithm == "zero_order":
        return s.n_iterations * s.n_neighbors + 1
    if s.algorithm == "gradient":
        return s.n_iterations + 1
    if s.algorithm == "path":
        return JA.path_search_nfes(T, s.n_paths, s.injection_steps,
                                   s.delta_f, cost)
    if s.algorithm == "pruned":
        return JA.pruned_search_nfes(T, s.n_candidates, s.prune_schedule,
                                     cost)
    return JA.smc_search_nfes(T, s.n_candidates, s.smc_resample_steps, cost)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A directory with seeded weights of both tiny UNets and a seeded
    SmallCNN checkpoint."""
    d = tmp_path_factory.mktemp("weights")
    for name, extra in MODELS.items():
        cfg = load_config(None, TINY + extra)
        model, _ = runner.build_model(cfg)
        torch.save(runner.init_params(cfg, model), d / f"{name}.pt")
    clf = SmallCNN(ClassifierConfig(num_classes=10, ch=8, depth=2))
    clf.init_weights(torch.Generator().manual_seed(0))
    save_classifier(str(d / "clf.pt"), clf.state_dict())
    return d


def _args(weights, tmp_path, model, *extra):
    return ["--device", "cpu", *TINY, *MODELS[model],
            f"save_weight_dir={weights}", f"test_load_weight={model}.pt",
            "search.classifier_ckpt=clf.pt", "search.target_label=3",
            f"sampled_dir={tmp_path}", *extra]


@pytest.mark.parametrize("model,algo,verifier", CASES)
def test_cli_search_runs_every_algorithm_and_verifier(weights, tmp_path,
                                                      capsys, model, algo,
                                                      verifier):
    args = _args(weights, tmp_path, model, *ALGOS[algo],
                 f"search.verifier={verifier}")
    assert cli_main.main(["search", *args]) == 0
    out = capsys.readouterr().out
    m = re.search(r"best score: (\S+) \(NFE=(\d+)\)", out)
    assert m, out[-2000:]
    cfg = load_config(None, args[2:])
    assert np.isfinite(float(m.group(1)))
    assert int(m.group(2)) == _expected_nfes(cfg)
    name = cfg.search.algorithm
    assert (tmp_path / f"search_{name}_best.png").is_file()


def test_trainer_search_and_the_guard(weights, tmp_path):
    cfg = load_config(None, _args(weights, tmp_path, "cfg")[2:] + [
        "search.algorithm=pruned", "search.n_candidates=3",
        "search.prune_schedule=[[5,2]]", "search.guard_proxy=true",
        "search.guard_num_real=64", "search.guard_baseline_draws=2",
        "data.use_full_dataset=false", "data.train_subset_ratio=0.05"])
    tr = Trainer(cfg, device="cpu")
    tr.load("cfg.pt")
    calls = []

    def verifier(images):
        calls.append(images.shape)
        return -images.square().mean()

    out = tr.search(verifier_fn=verifier)
    assert calls and all(s == (2, 8, 8, 3) for s in calls)
    g = out["guard"]
    assert len(g["baseline_fid_proxy_draws"]) == 2
    assert g["flagged"] == (g["winner_fid_proxy"]
                            > 1.5 * g["baseline_fid_proxy"])
    assert np.isfinite(g["winner_fid_proxy"])
    assert out["nfes"] == JA.pruned_search_nfes(T, 3, [[5, 2]]) == 3
    assert out["best_score"] == float(out["result"].best_score)


@pytest.mark.parametrize("verifier", ["clip", "ensemble"])
def test_cli_clip_and_ensemble_verifiers_are_not_ported(weights, tmp_path,
                                                        capsys, verifier,
                                                        monkeypatch):
    """Both are ported: clip with a tiny CLIP in HuggingFace's layout
    (``$ITSD_CLIP_WEIGHTS``), ensemble with the seeded random-weight
    Inception-V3 against 8 real images."""
    from test_torch_clip import hf_state_dict

    torch.save(hf_state_dict(), tmp_path / "clip.pt")
    monkeypatch.setenv("ITSD_CLIP_WEIGHTS", str(tmp_path / "clip.pt"))
    rc = cli_main.main(["search", *_args(
        weights, tmp_path, "uncond", "search.n_candidates=2",
        "search.ensemble_num_real=8", f"search.verifier={verifier}")])
    assert rc == 0
    out = capsys.readouterr().out
    m = re.search(r"best score: (\S+) \(NFE=2\)", out)
    assert m and np.isfinite(float(m.group(1))), out[-2000:]
    assert (verifier == "ensemble") == ("ensemble verifier: -FID" in out)


@pytest.mark.parametrize("extra,match", [
    (["search.candidate_chunk=3"], "must divide"),
    (["search.algorithm=path", "diffusion.launch_segments=2"],
     "launch_segments applies to eval and random"),
    (["diffusion.launch_segments=2", "diffusion.sampler=ddim"],
     "launch_segments splits"),
    (["search.algorithm=beam"], "unknown search algorithm"),
    (["search.verifier=psnr"], "unknown search.verifier"),
    (["search.verifier=classifier", "search.classifier_ckpt=none"],
     "needs search.classifier_ckpt"),
    (["search.verifier=classifier", "search.target_label=none"],
     "needs search.target_label"),
    (["search.verifier=classifier", "search.target_label=10"],
     "exceed classifier classes"),
    (["search.algorithm=pruned", "search.prune_schedule=[[5,2],[5,1]]"],
     "duplicate timesteps")])
def test_run_search_raises_as_jax_does(weights, tmp_path, extra, match):
    cfg = load_config(None, _args(weights, tmp_path, "uncond", *extra)[2:])
    with pytest.raises(ValueError, match=match):
        runner.run_search(cfg, device="cpu")


def test_run_search_refuses_spatial_shards(weights, tmp_path, capsys):
    """train.spatial_shard does not apply to search, whose candidates are
    the sharded axis: as JAX's, it prints a note and runs each candidate
    whole, with the result of the run without it."""
    args = _args(weights, tmp_path, "uncond")[2:]
    want = runner.run_search(load_config(None, args), device="cpu")
    capsys.readouterr()
    got = runner.run_search(load_config(None, args + [
        "train.spatial_shard=2"]), device="cpu")
    assert "search runs unsharded per candidate" in capsys.readouterr().out
    assert got["best_score"] == want["best_score"]
    assert torch.equal(got["result"].best_images, want["result"].best_images)


def _candidates(n, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np.float32))


@pytest.mark.parametrize("nan_chunk", [None, 0])
def test_candidate_chunks_keep_the_unchunked_winner(weights, tmp_path,
                                                    nan_chunk):
    """Four injected candidates over DDIM at eta 0 (nothing else drawn):
    in one chunk or two, the same scores; the host's running argmax picks
    the same winner. A chunk whose scores are NaN never wins."""
    base = _args(weights, tmp_path, "uncond", "search.n_candidates=4",
                 "diffusion.sampler=ddim", "diffusion.ddim_steps=4")[2:]
    noises = _candidates(4, (2, 8, 8, 3), 5)
    seen = []

    def verifier(images):
        seen.append(images)
        v = -(images - 0.2).square().mean()
        if nan_chunk is not None and len(seen) <= 2:
            return v * float("nan")
        return v

    def run(chunk):
        seen.clear()
        cfg = load_config(None, base + [f"search.candidate_chunk={chunk}"])

        def noise_fn(site, i, t):
            assert site[0] == "candidates"
            c = site[1]
            return noises[c * chunk:(c + 1) * chunk]

        return runner.run_search(cfg, device="cpu", verifier_fn=verifier,
                                 noise_fn=noise_fn)

    one, two = run(4), run(2)
    s1, s2 = one["result"].history["scores"], two["result"].history["scores"]
    if nan_chunk is None:
        np.testing.assert_allclose(s2, s1, atol=1e-6, rtol=0)
        assert one["best_score"] == pytest.approx(two["best_score"],
                                                  abs=1e-6)
        assert np.argmax(s1) == np.argmax(s2)
    else:
        assert np.isnan(s2[:2]).all() and np.isfinite(s2[2:]).all()
        assert two["best_score"] == pytest.approx(np.max(s2[2:]), abs=1e-6)
    assert one["nfes"] == two["nfes"] == 4


@pytest.fixture(scope="module")
def artifact_pair(tmp_path_factory):
    """(the JAX UNet's f32 params, the port's state dict, arch, the
    classifier as a torch checkpoint) for artifacts/shapes32_uncond and
    artifacts/classifier_shapes32."""
    with open(os.path.join(ARTIFACTS, "shapes32_uncond.json")) as f:
        a = json.load(f)["arch"]
    params = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if getattr(x, "dtype", None) == jnp.bfloat16 else jnp.asarray(x),
        jax_restore_params(os.path.join(ARTIFACTS, "shapes32_uncond")))
    arch = dict(ch=a["ch"], ch_mult=tuple(a["ch_mult"]),
                attn=tuple(a["attn"]), num_res_blocks=a["num_res_blocks"],
                dropout=a["dropout"])
    state = params_from_jax(params, uncond_unet_config(**arch))
    cparams = jax_restore_params(os.path.join(ARTIFACTS,
                                              "classifier_shapes32"),
                                 template=None)
    ccfg = ClassifierConfig(num_classes=10, ch=32, depth=3)
    path = str(tmp_path_factory.mktemp("clf") / "classifier_shapes32.pt")
    save_classifier(path, classifier_params_from_jax(cparams, ccfg))
    return params, state, arch, path


def test_trained_random_search_picks_jax_winner(artifact_pair, tmp_path):
    params, state, arch, clf_path = artifact_pair
    n, B = 4, 3
    keys = [f"channel={arch['ch']}",
            f"channel_mult={list(arch['ch_mult'])}".replace(" ", ""),
            f"attn={list(arch['attn'])}", f"num_res_blocks="
            f"{arch['num_res_blocks']}", "dropout=0.0", "T=1000",
            "img_size=32", f"train.eval_batch_size={B}",
            "diffusion.sampler=ddim", "diffusion.ddim_steps=10",
            "diffusion.ddim_eta=0.0", f"search.n_candidates={n}",
            "search.verifier=classifier", "search.target_label=2",
            f"sampled_dir={tmp_path}", "seed=4"]
    jcfg = jax_load_config(None, keys + [
        "search.classifier_ckpt=" + os.path.join(ARTIFACTS,
                                                 "classifier_shapes32")])
    want = jax_runner.run_search(jcfg, params=params)
    # JAX's draws: the candidates of chunk 0 from split(PRNGKey(seed))[0]
    knoise, _ = jax.random.split(jax.random.PRNGKey(4))
    noises = torch.from_numpy(np.array(
        jax.random.normal(knoise, (n, B, 32, 32, 3)), np.float32))
    cfg = load_config(None, keys + [f"search.classifier_ckpt={clf_path}"])
    got = runner.run_search(cfg, params=state, device="cpu",
                            noise_fn=lambda site, i, t: noises)
    ws = np.asarray(want["result"].history["scores"])
    gs = got["result"].history["scores"]
    margin = np.sort(ws)[-1] - np.sort(ws)[-2]
    np.testing.assert_allclose(gs, ws, atol=2e-3, rtol=0)
    assert np.argmax(gs) == np.argmax(ws), (ws, gs, margin)
    assert got["best_score"] == pytest.approx(want["best_score"], abs=2e-3)
    np.testing.assert_allclose(got["result"].best_images.numpy(),
                               np.asarray(want["result"].best_images),
                               atol=2e-3, rtol=0)
    assert got["nfes"] == want["nfes"] == n
