"""The port's search algorithms against the JAX package's.

PR 11's analytic-Gaussian harness (tests/test_torch_fast_samplers.py):
for data ~ N(0, s^2 I) the exact eps-predictor is a closed form of x and
abar_t, so whole chains run in milliseconds. The verifier scores an image
batch by minus its mean squared distance to a fixed pattern (smooth,
differentiable, and it separates candidates). Every random quantity is
JAX's: the test replays the JAX function's key chain (split, fold_in) and
feeds each draw to the port through ``noise_fn(site, i, t)``
(``itsd_tpu_torch/search/algorithms.py``).

Tolerances (float32): chains and scores 1e-5 absolute on values O(1), as
the fast-sampler parity tests (the frameworks may fuse a multiply and an
add into one rounding); DDIM segments divide by sqrt(abar) at the chain's
head, 1e-4. Selections (winners, top-k survivors, resample flags and
indices) must be equal. Gradient search: scores 1e-5, gradient norms and
noises 1e-4 relative (the gradient flows back through every step of the
chain and Adam divides by its root mean square).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu import core as JC
from itsd_tpu.search import algorithms as J
from itsd_tpu_torch import core as PC
from itsd_tpu_torch.core.sampling import segment_cost
from itsd_tpu_torch.search import algorithms as P

from _torch_port import one_torch_thread  # noqa: F401

S = 0.5
T = 30
SHAPE = (2, 4, 4, 3)
TOL = 1e-5
DDIM_TOL = 1e-4
PATTERN = np.random.default_rng(99).uniform(-0.6, 0.6, SHAPE[1:]).astype(
    np.float32)


def _scheds(T=T):
    return (JC.linear_schedule(1e-4, 0.02, T),
            PC.linear_schedule(1e-4, 0.02, T, device="cpu"))


def _jax_eps(sched):
    def eps_fn(x, t):
        ab = sched.alphas_bar[t].reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.sqrt(1.0 - ab) * x / (ab * S ** 2 + (1.0 - ab))
    return eps_fn


def _torch_eps(sched):
    def eps_fn(x, t):
        ab = sched.alphas_bar[t].reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.sqrt(1.0 - ab) * x / (ab * S ** 2 + (1.0 - ab))
    return eps_fn


def jax_verifier(im):
    return -jnp.mean((im - PATTERN) ** 2)


def torch_verifier(im):
    return -torch.mean((im - torch.from_numpy(PATTERN)) ** 2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _chain(key, n, shape):
    """The draws of ``n`` steps that split their key as JAX's scans do."""
    out = []
    for _ in range(n):
        key, nkey = jax.random.split(key)
        out.append(_t(jax.random.normal(nkey, shape)))
    return out


def _jit(search, key, *args, **kw):
    """A JAX search under one jit (as the JAX runner runs it: eager
    dispatch of its scans takes seconds)."""
    def run(k):
        r = search(k, *args, **kw)
        return r.best_noise, r.best_score, r.best_images, r.history, r.nfes
    bn, bs, bi, hist, nfes = jax.jit(run)(key)
    return J.SearchResult(bn, bs, bi, hist, int(nfes))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


class Draws:
    """noise_fn of the port's search: site -> draw(s), recording the sites
    asked for."""

    def __init__(self):
        self.sites, self.seen = {}, []

    def __call__(self, site, i, t):
        self.seen.append(site)
        d = self.sites[site]
        return d[i] if isinstance(d, list) else d


def _denoisers(jsched, tsched):
    """(JAX denoise_fn, port denoise_fn): the ancestral chain."""
    jeps, teps = _jax_eps(jsched), _torch_eps(tsched)
    return (lambda x, k: JC.sample(jsched, jeps, x, k),
            lambda x, g, nf: PC.sample(tsched, teps, x, generator=g,
                                       noise_fn=nf))


# ---------------------------------------------------------------------------
# selection helpers


def test_nan_to_neg_inf_argmax_and_top_k_follow_jax():
    """NaN never wins; ties go to the lower index, in lax.top_k's order."""
    cases = [[0.5, np.nan, 0.5, 0.2, 0.5, np.nan], [1.0, 1.0, 1.0, 1.0],
             [np.nan, np.nan, np.nan], [-np.inf, 3.0, np.nan, 3.0, -1.0]]
    for c in cases:
        s = np.asarray(c, np.float32)
        js = J._nan_to_neg_inf(jnp.asarray(s))
        ps = P._nan_to_neg_inf(torch.from_numpy(s))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        assert int(P._argmax(torch.from_numpy(s))) == int(jnp.argmax(js))
        for k in range(1, len(s) + 1):
            _, want = jax.lax.top_k(js, k)
            got = P._top_k(torch.from_numpy(s), k)
            assert got.tolist() == np.asarray(want).tolist(), (c, k)


# ---------------------------------------------------------------------------
# random search


@pytest.mark.parametrize("nan_at", [None, 2])
def test_random_search_matches_jax(nan_at):
    """With ``nan_at``, that candidate scores NaN (the verifier keys on its
    first pixel, read off a plain run): it must not win."""
    js, ts = _scheds()
    jden, tden = _denoisers(js, ts)
    key, n = jax.random.PRNGKey(0), 4
    kn, kd = jax.random.split(key)
    noises = jax.random.normal(kn, (n,) + SHAPE)
    draws = Draws()
    draws.sites[("candidates",)] = _t(noises)
    draws.sites[("denoise", 0)] = _chain(kd, T, (n * SHAPE[0],) + SHAPE[1:])
    jver, tver = jax_verifier, torch_verifier
    if nan_at is not None:
        marker = float(np.asarray(jden(noises.reshape((-1,) + SHAPE[1:]),
                                       kd))[nan_at * SHAPE[0], 0, 0, 0])

        def jver(im):
            return jnp.where(jnp.abs(im[0, 0, 0, 0] - marker) < 1e-4,
                             jnp.nan, jax_verifier(im))

        def tver(im):
            return torch.where((im[0, 0, 0, 0] - marker).abs() < 1e-4,
                               torch.tensor(float("nan")),
                               torch_verifier(im))
    want = _jit(J.random_search, key, SHAPE, jden, jver, n_candidates=n)
    got = P.random_search(SHAPE, tden, tver, n_candidates=n, noise_fn=draws)
    assert draws.seen[0] == ("candidates",)
    assert set(draws.seen[1:]) == {("denoise", 0)}
    ws = np.asarray(want.history["scores"])
    if nan_at is not None:
        assert np.isnan(ws[nan_at]) and got.history["scores"][nan_at].isnan()
    _close(got.history["scores"], ws)
    _close(got.best_score, want.best_score)
    _close(got.best_noise, want.best_noise)
    _close(got.best_images, want.best_images)
    assert got.nfes == want.nfes == n


def test_random_search_draws_from_the_generator():
    _, tden = _denoisers(*_scheds())
    run = [P.random_search(SHAPE, tden, torch_verifier, 3,
                           generator=torch.Generator().manual_seed(s))
           for s in (1, 1, 2)]
    assert torch.equal(run[0].best_images, run[1].best_images)
    assert not torch.equal(run[0].best_images, run[2].best_images)
    with pytest.raises(ValueError, match="generator"):
        P.random_search(SHAPE, tden, torch_verifier, 3)


# ---------------------------------------------------------------------------
# zero-order search


def _zero_order_draws(key, n_it, n_nb, pivot_shape, with_images):
    draws = Draws()
    rows = (n_nb * pivot_shape[0],) + pivot_shape[1:]
    for it, k in enumerate(jax.random.split(key, n_it)):
        nk, dk = jax.random.split(k)
        draws.sites[("neighbors", it)] = _t(
            jax.random.normal(nk, (n_nb,) + pivot_shape))
        draws.sites[("denoise", it)] = _chain(dk, T, rows)
    if with_images:
        draws.sites[("denoise", n_it)] = _chain(jax.random.fold_in(key, 1),
                                                T, pivot_shape)
    return draws


@pytest.mark.parametrize("mode,lam", [("additive", 0.95), ("shell", 0.8)])
def test_zero_order_search_matches_jax(mode, lam):
    js, ts = _scheds()
    jden, tden = _denoisers(js, ts)
    key = jax.random.PRNGKey(3)
    init = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    want = _jit(J.zero_order_search, key, jnp.asarray(init), jden,
                jax_verifier,
                n_neighbors=3, lambda_radius=lam,
                n_iterations=3, neighbor_mode=mode,
                return_images=True)
    draws = _zero_order_draws(key, 3, 3, SHAPE, True)
    got = P.zero_order_search(torch.from_numpy(init), tden, torch_verifier,
                              n_neighbors=3, lambda_radius=lam,
                              n_iterations=3, neighbor_mode=mode,
                              return_images=True, noise_fn=draws)
    _close(got.history["scores"], want.history["scores"])
    _close(got.best_score, want.best_score)
    _close(got.best_noise, want.best_noise)
    _close(got.best_images, want.best_images)
    assert got.nfes == want.nfes == 10
    assert got.history["candidates_per_iter"] == 3


def test_zero_order_keeps_the_initial_noise_when_every_score_is_nan():
    """The unmasked score is stored and compared with ">", so NaN never
    improves: the best stays -inf and the pivot where it started."""
    js, ts = _scheds()
    jden, tden = _denoisers(js, ts)
    key = jax.random.PRNGKey(5)
    init = np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32)
    want = _jit(J.zero_order_search, key, jnp.asarray(init), jden,
                lambda im: jnp.nan * jnp.sum(im), n_neighbors=2,
                n_iterations=2)
    got = P.zero_order_search(torch.from_numpy(init), tden,
                              lambda im: float("nan") * im.sum(),
                              n_neighbors=2, n_iterations=2,
                              noise_fn=_zero_order_draws(key, 2, 2, SHAPE,
                                                         False))
    assert float(want.best_score) == float(got.best_score) == -np.inf
    np.testing.assert_array_equal(got.best_noise.numpy(), init)
    np.testing.assert_array_equal(np.asarray(want.best_noise), init)
    with pytest.raises(ValueError, match="unknown neighbor mode"):
        P._sample_neighbors(torch.zeros(SHAPE), 2, 0.5, "cube",
                            generator=torch.Generator())


# ---------------------------------------------------------------------------
# the forking searches: path, pruned, SMC


def _forking(sampler, jsched, tsched, num_steps=20, eta=0.5):
    """(JAX segment, port segment, draw count of one segment)."""
    if sampler == "ddpm":
        return None, None, lambda hi, lo: hi - lo
    jseg = JC.make_segment_denoiser(jsched, _jax_eps(jsched), sampler,
                                    num_steps=num_steps, eta=eta)
    tseg = PC.make_segment_denoiser(tsched, _torch_eps(tsched), sampler,
                                    num_steps=num_steps, eta=eta)
    return jseg, tseg, tseg[1]


@pytest.mark.parametrize("sampler,steps,n_active", [
    ("ddpm", (20, 8), 2), ("ddim", (20,), 1)])
def test_path_search_matches_jax(sampler, steps, n_active):
    js, ts = _scheds()
    jseg, tseg, draws_of = _forking(sampler, js, ts)
    key, n, delta = jax.random.PRNGKey(7), 4, 5
    want = _jit(J.path_search, key, js, _jax_eps(js), jax_verifier, SHAPE,
                n_paths=n, n_active=n_active, injection_steps=steps,
                delta_f=delta, segment=jseg)
    rows = (n * SHAPE[0],) + SHAPE[1:]
    draws = Draws()
    k0, key = jax.random.split(key)
    draws.sites[("candidates",)] = _t(jax.random.normal(k0, (n,) + SHAPE))
    t_prev = T
    for k, t_inj in enumerate(sorted(steps, reverse=True)):
        kd, ks, key = jax.random.split(key, 3)
        draws.sites[("segment", k)] = _chain(kd, draws_of(t_prev, t_inj),
                                             rows)
        draws.sites[("renoise", k)] = [_t(jax.random.normal(ks, rows))]
        t_prev = min(t_inj + delta, T)
    kf, _ = jax.random.split(key)
    draws.sites[("segment", len(steps))] = _chain(kf, draws_of(t_prev, 0),
                                                  rows)
    got = P.path_search(ts, _torch_eps(ts), torch_verifier, SHAPE,
                        n_paths=n, n_active=n_active, injection_steps=steps,
                        delta_f=delta, segment=tseg, noise_fn=draws)
    tol = TOL if sampler == "ddpm" else DDIM_TOL
    _close(got.history["scores"], want.history["scores"], tol)
    _close(got.history["final_scores"], want.history["final_scores"], tol)
    _close(got.best_noise, want.best_noise, tol)
    assert got.history["injection_points"] == sorted(steps, reverse=True)
    assert got.nfes == want.nfes == J.path_search_nfes(
        T, n, steps, delta, None if jseg is None else jseg[1])


def test_path_search_ties_expand_the_lower_indices_in_order():
    """A constant verifier ties every path: lax.top_k keeps paths 0 and 1,
    and jnp.repeat expands them as 0, 0, 1, 1 (not 0, 1, 0, 1); the
    renoise draws then land on the same rows."""
    js, ts = _scheds()
    key, n = jax.random.PRNGKey(8), 4
    want = _jit(J.path_search, key, js, _jax_eps(js),
                lambda im: jnp.float32(0),
                SHAPE, n_paths=n, n_active=2,
                injection_steps=(20,), delta_f=4)
    rows = (n * SHAPE[0],) + SHAPE[1:]
    draws = Draws()
    k0, key = jax.random.split(key)
    draws.sites[("candidates",)] = _t(jax.random.normal(k0, (n,) + SHAPE))
    kd, ks, key = jax.random.split(key, 3)
    draws.sites[("segment", 0)] = _chain(kd, T - 20, rows)
    draws.sites[("renoise", 0)] = [_t(jax.random.normal(ks, rows))]
    kf, _ = jax.random.split(key)
    draws.sites[("segment", 1)] = _chain(kf, 20 + 4, rows)
    got = P.path_search(ts, _torch_eps(ts), lambda im: im.sum() * 0, SHAPE,
                        n_paths=n, n_active=2, injection_steps=(20,),
                        delta_f=4, noise_fn=draws)
    assert int(jnp.argmax(want.history["final_scores"])) == 0
    _close(got.best_noise, want.best_noise)


@pytest.mark.parametrize("sampler,schedule", [
    ("ddpm", ((20, 3), (10, 2))), ("ddim", ((15, 2),))])
def test_pruned_search_matches_jax(sampler, schedule):
    js, ts = _scheds()
    jseg, tseg, draws_of = _forking(sampler, js, ts)
    key, n = jax.random.PRNGKey(9), 5
    want = _jit(J.pruned_search, key, js, _jax_eps(js), jax_verifier, SHAPE,
                n_candidates=n, prune_schedule=schedule,
                segment=jseg)
    draws = Draws()
    k0, key = jax.random.split(key)
    draws.sites[("candidates",)] = _t(jax.random.normal(k0, (n,) + SHAPE))
    t_prev, n_now = T, n
    for k, (t_p, keep) in enumerate(schedule):
        kd, key = jax.random.split(key)
        draws.sites[("segment", k)] = _chain(
            kd, draws_of(t_prev, t_p), (n_now * SHAPE[0],) + SHAPE[1:])
        t_prev, n_now = t_p, keep
    kf, _ = jax.random.split(key)
    draws.sites[("segment", len(schedule))] = _chain(
        kf, draws_of(t_prev, 0), (n_now * SHAPE[0],) + SHAPE[1:])
    got = P.pruned_search(ts, _torch_eps(ts), torch_verifier, SHAPE,
                          n_candidates=n, prune_schedule=schedule,
                          segment=tseg, noise_fn=draws)
    tol = TOL if sampler == "ddpm" else DDIM_TOL
    for g, w in zip(got.history["prune_scores"],
                    want.history["prune_scores"]):
        _close(g, w, tol)
    _close(got.history["final_scores"], want.history["final_scores"], tol)
    _close(got.best_noise, want.best_noise, tol)
    _close(got.best_score, want.best_score, tol)
    assert got.history["prune_schedule"] == sorted(schedule, reverse=True)
    cost = None if jseg is None else jseg[1]
    assert got.nfes == want.nfes == J.pruned_search_nfes(T, n, schedule,
                                                         cost)
    assert P.pruned_search_nfes(T, n, schedule, cost) == want.nfes


def test_pruned_search_rejects_duplicate_timesteps():
    js, ts = _scheds()
    sched = ((20, 3), (20, 2))
    with pytest.raises(ValueError, match="duplicate timesteps"):
        J.pruned_search(jax.random.PRNGKey(0), js, _jax_eps(js),
                        jax_verifier, SHAPE, n_candidates=4,
                        prune_schedule=sched)
    with pytest.raises(ValueError, match="duplicate timesteps"):
        P.pruned_search(ts, _torch_eps(ts), torch_verifier, SHAPE,
                        n_candidates=4, prune_schedule=sched,
                        generator=torch.Generator())
    with pytest.raises(ValueError, match="keep=5"):
        P.pruned_search(ts, _torch_eps(ts), torch_verifier, SHAPE,
                        n_candidates=4, prune_schedule=((20, 5),),
                        generator=torch.Generator())


@pytest.mark.parametrize("T_,n,paths_or_sched,delta,sampler,num_steps", [
    (1000, 16, (500,), 50, "ddpm", 50), (1000, 4, (400, 200), 50, "ddim",
                                         50),
    (3000, 8, (700, 150), 100, "dpm", 20), (100, 6, (30,), 80, "ddim", 10)])
def test_nfe_accounting_matches_jax(T_, n, paths_or_sched, delta, sampler,
                                    num_steps):
    from itsd_tpu.core.sampling import segment_cost as jax_segment_cost
    jc = jax_segment_cost(T_, sampler, num_steps)
    pc = segment_cost(T_, sampler, num_steps)
    for cost_j, cost_p in ((None, None), (jc, pc)):
        assert P.path_search_nfes(T_, n, paths_or_sched, delta, cost_p) == \
            J.path_search_nfes(T_, n, paths_or_sched, delta, cost_j)
        assert P.smc_search_nfes(T_, n, paths_or_sched, cost_p) == \
            J.smc_search_nfes(T_, n, paths_or_sched, cost_j)
        sched = [(t, max(1, n // (i + 2))) for i, t in
                 enumerate(paths_or_sched)]
        assert P.pruned_search_nfes(T_, n, sched, cost_p) == \
            J.pruned_search_nfes(T_, n, sched, cost_j)


def _smc_draws(key, steps, n, draws_of):
    rows = (n * SHAPE[0],) + SHAPE[1:]
    draws = Draws()
    k0, key = jax.random.split(key)
    draws.sites[("candidates",)] = _t(jax.random.normal(k0, (n,) + SHAPE))
    t_prev = T
    for k, t_r in enumerate(steps):
        kd, kr, key = jax.random.split(key, 3)
        draws.sites[("segment", k)] = _chain(kd, draws_of(t_prev, t_r), rows)
        draws.sites[("uniform", k)] = _t(jax.random.uniform(kr, ()))
        t_prev = t_r
    kf, _ = jax.random.split(key)
    draws.sites[("segment", len(steps))] = _chain(kf, draws_of(t_prev, 0),
                                                  rows)
    return draws


@pytest.mark.parametrize("scale,lam,sampler", [
    ("absolute", 400.0, "ddpm"), ("spread", 3.0, "ddpm"),
    ("absolute", 0.0, "ddim")])
def test_smc_search_matches_jax(scale, lam, sampler):
    """Scores, ESS, resample flags and the steered population (which
    equals JAX's only if every resample picked the same particles)."""
    js, ts = _scheds()
    jseg, tseg, draws_of = _forking(sampler, js, ts)
    key, n, steps = jax.random.PRNGKey(10), 6, (24, 14, 6)
    want = _jit(J.smc_search, key, js, _jax_eps(js), jax_verifier, SHAPE,
                n_particles=n, resample_steps=steps, lambda_temp=lam,
                ess_threshold=0.9, segment=jseg,
                return_population=True, lambda_scale=scale)
    draws = _smc_draws(key, steps, n, draws_of)
    got = P.smc_search(ts, _torch_eps(ts), torch_verifier, SHAPE,
                       n_particles=n, resample_steps=steps, lambda_temp=lam,
                       ess_threshold=0.9, segment=tseg,
                       return_population=True, lambda_scale=scale,
                       noise_fn=draws)
    tol = TOL if sampler == "ddpm" else DDIM_TOL
    resampled = np.asarray(want.history["resampled"])
    assert got.history["resampled"].numpy().tolist() == resampled.tolist()
    if lam:
        assert resampled.any()
    np.testing.assert_allclose(got.history["ess"].numpy(),
                               np.asarray(want.history["ess"]), rtol=1e-4)
    for g, w in zip(got.history["resample_scores"],
                    want.history["resample_scores"]):
        _close(g, w, tol)
    _close(got.history["finals"], want.history["finals"], tol)
    _close(got.best_score, want.best_score, tol)
    assert got.nfes == want.nfes


def test_smc_search_validates_its_arguments():
    _, ts = _scheds()
    for kw, match in ((dict(lambda_scale="log"), "lambda_scale"),
                      (dict(resample_steps=()), "resample step")):
        with pytest.raises(ValueError, match=match):
            P.smc_search(ts, _torch_eps(ts), torch_verifier, SHAPE, **kw)


def test_systematic_resample_matches_jax_up_to_a_boundary_ulp():
    """The rule: an index may differ from JAX's only where its position
    lies within an ulp of a cumulative weight. torch's CPU cumsum adds
    float32 in a float64 accumulator, XLA in float32, so the cumulative
    weights differ in their last bit, and a position on a boundary may
    fall on either side."""
    rng = np.random.default_rng(11)
    differ = 0
    resample = jax.jit(J._systematic_resample)
    for trial in range(120):
        n = (5, 16, 32)[trial % 3]
        log_w = (rng.standard_normal(n) * rng.uniform(0.1, 5)).astype(
            np.float32)
        key = jax.random.PRNGKey(trial)
        want = np.asarray(resample(key, jnp.asarray(log_w)))
        u = jax.random.uniform(key, ())
        got = P._systematic_resample(_t(u), torch.from_numpy(log_w)).numpy()
        for j in np.flatnonzero(got != want):
            differ += 1
            pos = np.float32((np.float32(u) + np.float32(j)) / np.float32(n))
            c = np.cumsum(np.asarray(jax.nn.softmax(jnp.asarray(log_w))),
                          dtype=np.float32)
            gap = np.abs(c - pos).min()
            assert gap <= 2 * np.spacing(np.float32(max(pos, 1e-30))), (
                trial, j, gap)
        assert (np.diff(got) >= 0).all() and got.max() < n
    assert differ <= 5


# ---------------------------------------------------------------------------
# gradient search


@pytest.mark.parametrize("solver_steps", [None, 8])
def test_gradient_search_matches_jax(solver_steps):
    """3 iterations of Adam through the recomputed ancestral chain (JAX's
    draws fed in) or through DPM-Solver++: the scores, the gradient norms,
    the best noise and the final images."""
    js, ts = _scheds()
    key = jax.random.PRNGKey(12)
    init = np.random.default_rng(13).standard_normal(SHAPE).astype(np.float32)
    want = _jit(J.gradient_search, key, jnp.asarray(init), js, _jax_eps(js),
                jax_verifier, n_iterations=3, lr=0.05,
                return_images=True, solver_steps=solver_steps)
    draws = Draws()
    if solver_steps is None:
        for it, k in enumerate(jax.random.split(key, 3)):
            draws.sites[("denoise", it)] = _chain(k, T, SHAPE)
        draws.sites[("denoise", 3)] = _chain(jax.random.fold_in(key, 3), T,
                                             SHAPE)
    got = P.gradient_search(torch.from_numpy(init), ts, _torch_eps(ts),
                            torch_verifier, n_iterations=3, lr=0.05,
                            return_images=True, solver_steps=solver_steps,
                            noise_fn=draws)
    _close(got.history["scores"], want.history["scores"])
    np.testing.assert_allclose(got.history["grad_norms"].numpy(),
                               np.asarray(want.history["grad_norms"]),
                               rtol=1e-4)
    assert float(np.asarray(want.history["grad_norms"]).min()) > 0
    np.testing.assert_allclose(got.best_noise.numpy(),
                               np.asarray(want.best_noise), rtol=1e-4,
                               atol=1e-4)
    _close(got.best_score, want.best_score)
    _close(got.best_images, want.best_images, 1e-4)
    assert got.nfes == want.nfes == 4
    assert not got.best_noise.requires_grad


def test_remat_gradient_equals_the_plain_gradient_on_the_same_draws():
    """torch.utils.checkpoint restores only the global generators, so the
    sampler draws each step's noise before the checkpointed call: the
    recompute sees the same noise, and the gradient equals the one without
    remat. The generator advances once a step either way."""
    _, ts = _scheds()
    eps = _torch_eps(ts)
    x0 = torch.from_numpy(np.random.default_rng(14).standard_normal(
        SHAPE).astype(np.float32))
    grads, states = [], []
    for remat in (False, True):
        g = torch.Generator().manual_seed(15)
        x = x0.clone().requires_grad_(True)
        out = PC.sample(ts, eps, x, generator=g, remat=remat)
        grads.append(torch.autograd.grad(torch_verifier(out), x)[0])
        states.append(g.get_state())
    assert torch.equal(states[0], states[1])
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=0,
                               atol=1e-7 * grads[0].abs().max().item())
    assert grads[0].abs().max() > 0


def test_gradient_search_all_nan_keeps_the_initial_noise():
    _, ts = _scheds(10)
    init = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    got = P.gradient_search(init, ts, _torch_eps(ts),
                            lambda im: float("nan") * im.sum(),
                            n_iterations=2, solver_steps=4)
    assert float(got.best_score) == -np.inf
    assert torch.equal(got.best_noise, init)
