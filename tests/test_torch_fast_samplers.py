"""The port's fast and composite samplers against the JAX package's.

The cases mirror the JAX package's tests/test_ddim.py, test_dpm_solver.py,
test_segment_samplers.py, test_restart_sampling.py and
test_parallel_sampling.py, on their analytic-Gaussian harness: for data
~ N(0, s^2 I) the exact eps-predictor is a closed form of x and abar_t,
written once for JAX and once for torch, so whole T=1000 chains run in
milliseconds. Both sides start from one seeded numpy x_T; where a sampler
draws noise, JAX's draws (its key chain, split or folded as the JAX
function does) are fed to the port through ``noise_fn``.

Tolerances: both sides compute the same float32 arithmetic (the
coefficients from the same float32 table; the grids equal), but XLA may
contract a multiply and an add into one rounding, so a step can differ by
an ulp. DDIM's x0 = (x - sqrt(1-abar) eps) / sqrt(abar) divides by
sqrt(abar_T) ~ 6e-3 at the first step of a T=1000 chain, which turns an
ulp of x (~1e-7) into ~2e-5 of x0; the next state multiplies it back by
sqrt(abar_next). Measured: DDIM and Picard <= 6e-7. Limit: 1e-5
absolute on values O(1), restart 2e-5 (three traversals of its interval).
DPM-Solver's x0 step keeps that division: x - sqrt(1-abar) eps cancels to
~abar_T |x| in the harness, so an ulp of |x| < 4 (2^-21) over
sqrt(abar_T) = 6.4e-3 (T=1000) reaches the output of a short solve whole:
7.5e-5 (measured 1.8e-5 at 2 steps, 2.4e-6 at 5); limit 1e-4.
``renoise`` and the snapshots are the same elementwise arithmetic: 1e-6.
Picard must stop at the same sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu import core as J
from itsd_tpu.core.sampling import segment_cost as jax_segment_cost
from itsd_tpu_torch import core as P
from itsd_tpu_torch.core.sampling import ddim_timesteps, segment_cost

from _torch_port import one_torch_thread  # noqa: F401

S = 0.5  # data std of the analytic harness
TOL = 1e-5
DPM_TOL = 1e-4


def _scheds(T):
    return (J.linear_schedule(1e-4, 0.02, T),
            P.linear_schedule(1e-4, 0.02, T, device="cpu"))


def _jax_eps(sched):
    def eps_fn(x, t):
        ab = sched.alphas_bar[t].reshape((-1,) + (1,) * (x.ndim - 1))
        v = ab * S ** 2 + (1.0 - ab)
        return jnp.sqrt(1.0 - ab) * x / v
    return eps_fn


def _torch_eps(sched):
    def eps_fn(x, t):
        ab = sched.alphas_bar[t].reshape((-1,) + (1,) * (x.dim() - 1))
        v = ab * S ** 2 + (1.0 - ab)
        return torch.sqrt(1.0 - ab) * x / v
    return eps_fn


def _x(seed, shape=(4, 4, 4, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _split_chain(key, n, shape):
    """The noise of ``n`` steps that split their key as JAX's scans do."""
    out = []
    for _ in range(n):
        key, nkey = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(nkey, shape, jnp.float32))))
    return out


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# DDIM and DPM-Solver++ over the whole chain


@pytest.mark.parametrize("T,n,eta", [(1000, 10, 0.0), (1000, 50, 0.0),
                                     (1000, 50, 1.0), (50, 15, 0.0),
                                     (100, 100, 1.0)])
def test_ddim_sample_matches_jax(T, n, eta):
    """Eta 0 and eta > 0 (JAX's noise fed in); T=50, n=15 has a .5 tie in
    its float32 grid, (100, 100) takes every timestep."""
    js, ts = _scheds(T)
    x, key = _x(1), jax.random.PRNGKey(2)
    want = J.ddim_sample(js, _jax_eps(js), jnp.asarray(x), key, num_steps=n,
                         eta=eta, clip_output=False)
    noise = _split_chain(key, n, x.shape)
    seen = []

    def noise_fn(i, t):
        seen.append((i, t))
        return noise[i]

    got = P.ddim_sample(ts, _torch_eps(ts), torch.from_numpy(x),
                        num_steps=n, eta=eta, clip_output=False,
                        noise_fn=noise_fn)
    _close(got, want)
    grid = ddim_timesteps(T, n)
    assert seen == ([(i, int(t)) for i, t in enumerate(grid[:-1])]
                    if eta else [])


def test_ddim_eta0_is_deterministic_and_clips():
    _, ts = _scheds(100)
    x = torch.from_numpy(_x(3, (2, 4, 4, 3))) * 3
    eps = lambda x, t: 0.1 * x  # noqa: E731
    a = P.ddim_sample(ts, eps, x, num_steps=10,
                      generator=torch.Generator().manual_seed(0))
    b = P.ddim_sample(ts, eps, x, num_steps=10,
                      generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and a.abs().max() <= 1.0


def test_ddim_eta1_draws_from_the_generator():
    _, ts = _scheds(100)
    x = torch.from_numpy(_x(3, (2, 4, 4, 3)))
    eps = _torch_eps(ts)
    run = [P.ddim_sample(ts, eps, x, num_steps=10, eta=1.0,
                         generator=torch.Generator().manual_seed(s))
           for s in (4, 4, 5)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])


@pytest.mark.parametrize("n", [2, 5, 10, 20])
def test_dpm_solver_sample_matches_jax(n):
    js, ts = _scheds(1000)
    x = _x(4)
    want = J.dpm_solver_sample(js, _jax_eps(js), jnp.asarray(x),
                               jax.random.PRNGKey(0), num_steps=n,
                               clip_output=False)
    got = P.dpm_solver_sample(ts, _torch_eps(ts), torch.from_numpy(x),
                              num_steps=n, clip_output=False)
    _close(got, want, DPM_TOL)


def test_dpm_beats_ddim_at_equal_nfe():
    """The port's solver keeps its order: at 10 steps it lands several
    times closer to the analytic flow than DDIM."""
    _, ts = _scheds(1000)
    x = torch.from_numpy(_x(5, (8, 4, 4, 3)))
    ab_T = ts.alphas_bar_host[-1]
    exact = x * S / np.sqrt(ab_T * S ** 2 + (1.0 - ab_T))
    eps = _torch_eps(ts)
    dpm = P.dpm_solver_sample(ts, eps, x, num_steps=10, clip_output=False)
    ddim = P.ddim_sample(ts, eps, x, num_steps=10, clip_output=False)
    e_dpm = (dpm - exact).abs().max().item()
    e_ddim = (ddim - exact).abs().max().item()
    assert e_dpm < 0.5 * e_ddim and e_dpm < 0.1, (e_dpm, e_ddim)


@pytest.mark.parametrize("fn,kw", [
    ("ddim_sample", dict(num_steps=0)), ("ddim_sample", dict(num_steps=11)),
    ("dpm_solver_sample", dict(num_steps=1)),
    ("parallel_picard_sample", dict(num_steps=1))])
def test_fast_samplers_check_num_steps(fn, kw):
    _, ts = _scheds(10)
    with pytest.raises(ValueError, match="num_steps"):
        getattr(P, fn)(ts, lambda x, t: x, torch.zeros(1, 2, 2, 3), **kw)


# ---------------------------------------------------------------------------
# segments, renoise and the segment denoiser


@pytest.mark.parametrize("t_from,t_to,n,eta,clip", [
    (1000, 0, 50, 0.0, False), (1000, 300, 35, 0.0, False),
    (400, 0, 20, 0.0, False), (1000, 0, 30, 1.0, False),
    (700, 100, 12, 0.5, True)])
def test_ddim_segment_matches_jax(t_from, t_to, n, eta, clip):
    js, ts = _scheds(1000)
    x, key = _x(6), jax.random.PRNGKey(7)
    want = J.ddim_segment(js, _jax_eps(js), jnp.asarray(x), key, t_from,
                          t_to, num_steps=n, eta=eta, clip_denoised=clip)
    noise = _split_chain(key, n, x.shape)
    got = P.ddim_segment(ts, _torch_eps(ts), torch.from_numpy(x), t_from,
                         t_to, num_steps=n, eta=eta, clip_denoised=clip,
                         noise_fn=lambda i, t: noise[i])
    _close(got, want)


@pytest.mark.parametrize("T,t_from,t_to,n", [
    (1000, 1000, 0, 10), (1000, 1000, 300, 8), (1000, 300, 0, 6),
    (50, 50, 30, 4), (50, 50, 30, 20), (50, 30, 0, 6), (50, 2, 1, 1),
    (50, 50, 49, 1)])
def test_dpm_segment_matches_jax(T, t_from, t_to, n):
    """The segments of test_segment_samplers.py, the short coarse T=50
    grids whose uniform-lambda targets snap onto t_to among them."""
    js, ts = _scheds(T)
    x = _x(8)
    for clip in (False, True):
        want = J.dpm_segment(js, _jax_eps(js), jnp.asarray(x),
                             jax.random.PRNGKey(0), t_from, t_to,
                             num_steps=n, clip_denoised=clip)
        got = P.dpm_segment(ts, _torch_eps(ts), torch.from_numpy(x), t_from,
                            t_to, num_steps=n, clip_denoised=clip)
        assert torch.isfinite(got).all()
        _close(got, want, DPM_TOL)


@pytest.mark.parametrize("t_now,t_target", [(0, 1000), (200, 600),
                                            (999, 1000)])
def test_renoise_matches_jax(t_now, t_target):
    js, ts = _scheds(1000)
    x, key = _x(9), jax.random.PRNGKey(10)
    want = J.renoise(js, jnp.asarray(x), t_now, t_target, key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
    seen = []
    got = P.renoise(ts, torch.from_numpy(x), t_now, t_target,
                    noise_fn=lambda i, t: seen.append((i, t)) or eps)
    assert seen == [(0, t_target)]
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="t_now < t_target"):
        P.renoise(ts, torch.from_numpy(x), t_target, t_now)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm"])
def test_segment_denoiser_matches_jax(sampler):
    T = 200
    js, ts = _scheds(T)
    x, key = _x(11), jax.random.PRNGKey(12)
    jfn, jcost = J.make_segment_denoiser(js, _jax_eps(js), sampler,
                                         num_steps=40, clip_denoised=True,
                                         eta=0.5)
    fn, cost = P.make_segment_denoiser(ts, _torch_eps(ts), sampler,
                                       num_steps=40, clip_denoised=True,
                                       eta=0.5)
    for hi, lo in ((200, 120), (120, 0), (10, 8)):
        assert cost(hi, lo) == jcost(hi, lo)
        want = jfn(jnp.asarray(x), key, hi, lo, clip_output=True)
        noise = _split_chain(key, hi - lo, x.shape)
        got = fn(torch.from_numpy(x), hi, lo, clip_output=True,
                 noise_fn=lambda i, t: noise[i])
        _close(got, want)


def test_segment_denoiser_rejects_picard():
    _, ts = _scheds(10)
    with pytest.raises(ValueError, match="no segment form"):
        P.make_segment_denoiser(ts, lambda x, t: x, "picard")


@pytest.mark.parametrize("T,sampler,num_steps", [
    (1000, "ddpm", 50), (1000, "ddim", 50), (1000, "dpm", 20),
    (100, "ddim", 10), (50, "dpm", 7)])
def test_segment_cost_matches_jax(T, sampler, num_steps):
    want = jax_segment_cost(T, sampler, num_steps)
    got = segment_cost(T, sampler, num_steps)
    for hi in range(1, T + 1, max(1, T // 37)):
        for lo in range(0, hi, max(1, hi // 5)):
            assert got(hi, lo) == want(hi, lo), (hi, lo)
    _, cost = P.make_segment_denoiser(_scheds(T)[1], lambda x, t: x,
                                      sampler, num_steps=num_steps)
    assert cost(T, 0) == want(T, 0)


# ---------------------------------------------------------------------------
# restart sampling


@pytest.mark.parametrize("restarts,match", [
    (((120, 50, 1),), "out of range"), (((50, 50, 1),), "out of range"),
    (((80, 40, 1), (60, 20, 1)), "overlaps"), (((80, 40, 0),), "k=0")])
def test_restart_spec_validation_matches_jax(restarts, match):
    for nfes in (J.restart_nfes, P.restart_nfes):
        with pytest.raises(ValueError, match=match):
            nfes(100, restarts)


@pytest.mark.parametrize("T,restarts,sampler,num_steps", [
    (10, (), "ddpm", 50), (10, ((8, 4, 2),), "ddpm", 50),
    (100, ((80, 40, 1), (40, 10, 1)), "ddpm", 50),
    (100, ((80, 40, 1), (30, 10, 3)), "ddpm", 50),
    (100, ((80, 40, 2),), "ddim", 10), (1000, ((600, 200, 2),), "dpm", 20)])
def test_restart_nfes_matches_jax(T, restarts, sampler, num_steps):
    want = J.restart_nfes(T, restarts,
                          jax_segment_cost(T, sampler, num_steps))
    assert P.restart_nfes(T, restarts,
                          segment_cost(T, sampler, num_steps)) == want
    if sampler == "ddpm":
        assert P.restart_nfes(T, restarts) == want


def _restart_noise(key, restarts, T, cost, shape):
    """JAX's draws of restart_sample, by call: segment calls split their
    fold_in key a step; renoise calls draw from it directly."""
    calls, cur = [], T
    for t_max, t_min, k in restarts:
        if cur > t_max:
            calls.append(("seg", cost(cur, t_max)))
        calls += [("seg", cost(t_max, t_min))] + [
            ("renoise", 1), ("seg", cost(t_max, t_min))] * k
        cur = t_min
    if cur > 0:
        calls.append(("seg", cost(cur, 0)))
    out = {}
    for c, (kind, n) in enumerate(calls, start=1):
        ck = jax.random.fold_in(key, c)
        out[c] = ([torch.from_numpy(np.array(jax.random.normal(ck, shape)))]
                  if kind == "renoise" else _split_chain(ck, n, shape))
    return out


@pytest.mark.parametrize("T,sampler,restarts,eta", [
    (40, "ddpm", ((30, 10, 2),), 0.0), (1000, "ddim", ((600, 200, 2),), 0.5),
    (1000, "dpm", ((800, 500, 1), (500, 100, 2)), 0.0),
    (40, "ddpm", (), 0.0)])
def test_restart_sample_matches_jax(T, sampler, restarts, eta):
    js, ts = _scheds(T)
    x, key = _x(13), jax.random.PRNGKey(14)
    want = J.restart_sample(js, _jax_eps(js), jnp.asarray(x), key,
                            restarts=restarts, sampler=sampler,
                            num_steps=40, eta=eta, clip_output=False,
                            clip_denoised=True)
    noise = _restart_noise(key, restarts, T,
                           segment_cost(T, sampler, 40), x.shape)
    got = P.restart_sample(ts, _torch_eps(ts), torch.from_numpy(x),
                           restarts=restarts, sampler=sampler, num_steps=40,
                           eta=eta, clip_output=False, clip_denoised=True,
                           noise_fn=lambda c, i, t: noise[c][i])
    _close(got, want, DPM_TOL if sampler == "dpm" else 2 * TOL)


def test_restart_preserves_the_clean_marginal():
    """With the exact model, restart cycles keep x_0 ~ N(0, s^2)."""
    _, ts = _scheds(1000)
    x = torch.from_numpy(_x(15, (512, 2, 2, 1)))
    out = P.restart_sample(ts, _torch_eps(ts), x, restarts=((600, 200, 2),),
                           sampler="ddim", num_steps=40, clip_output=False,
                           generator=torch.Generator().manual_seed(5))
    assert abs(out.mean().item()) < 0.05
    assert abs(out.std().item() - S) < 0.15 * S


# ---------------------------------------------------------------------------
# Picard iteration


@pytest.mark.parametrize("T,n,max_iters,tol", [
    (200, 32, None, 1e-4), (200, 8, None, 1e-3), (1000, 50, None, 1e-3),
    (200, 8, 3, 1e-3), (1000, 20, None, 1e-2)])
def test_picard_matches_jax_and_stops_at_the_same_sweep(T, n, max_iters,
                                                        tol):
    js, ts = _scheds(T)
    x = _x(16)
    want, w_sweeps = J.parallel_picard_sample(
        js, _jax_eps(js), jnp.asarray(x), jax.random.PRNGKey(0),
        num_steps=n, max_iters=max_iters, tol=tol, clip_output=False)
    got, sweeps = P.parallel_picard_sample(
        ts, _torch_eps(ts), torch.from_numpy(x), num_steps=n,
        max_iters=max_iters, tol=tol, clip_output=False)
    assert sweeps == int(w_sweeps)
    _close(got, want)


def test_picard_full_iters_equals_sequential_ddim():
    """After n sweeps the whole grid is exact: sequential DDIM, where the
    float64 Picard grid and DDIM's float32 grid agree (here they do).
    tol=0 runs until a sweep changes no bit, so the sweep count hangs on
    the last bit of every element. Fed one Picard state, the two sweeps
    differ by an ulp in three operations: XLA computes the harness's
    ``sqrt(1-abar) * x / v`` as a product with ``1 / v``; it rounds
    ``g = (c-1) X + d eps`` once, as a fused multiply-add over the
    rounded ``d eps`` (the port rounds both products); and torch's CPU
    cumsum adds float32 in a float64 accumulator, where XLA adds in
    float32. On this input JAX stops after 10 sweeps and the port after
    11, so this case is held to its values and to a sweep count within
    one of JAX's; the cases above, with tol > 0, stop at the same
    sweep."""
    js, ts = _scheds(200)
    n = 16
    assert np.array_equal(ddim_timesteps(200, n),
                          np.linspace(199, 0, n).round())
    x = _x(16)
    want, w_sweeps = J.parallel_picard_sample(
        js, _jax_eps(js), jnp.asarray(x), jax.random.PRNGKey(0),
        num_steps=n, max_iters=n, tol=0.0, clip_output=False)
    seq = P.ddim_sample(ts, _torch_eps(ts), torch.from_numpy(x), num_steps=n,
                        clip_output=False)
    par, sweeps = P.parallel_picard_sample(
        ts, _torch_eps(ts), torch.from_numpy(x), num_steps=n, max_iters=n,
        tol=0.0, clip_output=False)
    assert 1 <= sweeps <= n and abs(sweeps - int(w_sweeps)) <= 1
    _close(par, want)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), atol=2e-4,
                               rtol=1e-4)


def test_picard_folds_the_grid_timestep_major_and_clips():
    _, ts = _scheds(50)
    calls = []

    def eps_fn(x, t):
        calls.append(t.clone())
        return 0.1 * x

    x = torch.from_numpy(_x(18, (2, 4, 4, 3))) * 3
    out, sweeps = P.parallel_picard_sample(ts, eps_fn, x, num_steps=4)
    grid = np.linspace(49, 0, 4).round()
    assert len(calls) == sweeps
    assert calls[0].tolist() == np.repeat(grid, 2).tolist()
    assert out.abs().max() <= 1.0


# ---------------------------------------------------------------------------
# snapshots


@pytest.mark.parametrize("T,interval", [(10, 4), (12, 3), (5, 5)])
def test_sample_with_snapshots_matches_jax(T, interval):
    js, ts = _scheds(T)
    x, key = _x(19), jax.random.PRNGKey(20)
    x0, snap_ts, snaps = J.sample_with_snapshots(
        js, _jax_eps(js), jnp.asarray(x), key, interval, clip_denoised=True)
    noise = _split_chain(key, T, x.shape)
    seen = []

    def noise_fn(i, t):
        seen.append((i, t))
        return noise[i]

    g0, g_ts, g_snaps = P.sample_with_snapshots(
        ts, _torch_eps(ts), torch.from_numpy(x), interval,
        clip_denoised=True, noise_fn=noise_fn)
    assert seen == list(enumerate(range(T - 1, -1, -1)))
    assert g_ts.tolist() == np.asarray(snap_ts).tolist()
    _close(g_snaps, snaps, 1e-6)
    _close(g0, x0, 1e-6)
    one = P.sample(ts, _torch_eps(ts), torch.from_numpy(x),
                   clip_denoised=True, noise_fn=lambda i, t: noise[i])
    assert torch.equal(one, g0)
