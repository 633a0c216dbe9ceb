"""``ddim_sample``'s timestep grid against the JAX package's.

JAX builds it as ``jnp.linspace(T - 1, 0, n).round()`` in float32 on the
device (``itsd_tpu/core/sampling.py:462``); XLA compiles the linspace to
``(T-1) * (1 - i * f32(1/(n-1)))``. The port evaluates that expression in
float32 numpy (``ddim_timesteps``), rounding half to even as ``round``
does. A grid point that lands on a .5 tie rounds by the last bit of its
float32 value, so any other arithmetic (float64, or float32 with a
division) evaluates other timesteps at some (T, n).

The table holds every 2 <= n <= min(T, 400) for T in {50, 100, 250, 1000,
2000, 3000}: 1,594 pairs. The port's grid equals JAX's at all of them but
the 15 of ``DIFFER``. There XLA's CPU backend fuses ``1 - i * r`` into one
fused multiply-add (one rounding) in its vector loop, which it emits for
grids of 352 intervals and more, so JAX's own grid depends on the backend
that compiles it; the port keeps the two-rounding arithmetic of the
compiled expression. The list is pinned here and stands in ROADMAP.md
Queue 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from itsd_tpu_torch.core.sampling import ddim_timesteps

TS = (50, 100, 250, 1000, 2000, 3000)
MAX_N = 400
DIFFER = {1000: (355, 363, 367, 371, 373, 379, 381, 391, 397),
          2000: (363, 381, 391), 3000: (363, 381, 391)}


@pytest.mark.parametrize("T", TS)
def test_ddim_grid_matches_jax_but_at_the_pinned_pairs(T):
    differ = []
    for n in range(2, min(T, MAX_N) + 1):
        # round half to even in numpy, as jnp.round does, on JAX's float32
        # linspace (one compile per n, shared by every T)
        want = np.rint(np.asarray(jnp.linspace(T - 1, 0, n)))
        got = ddim_timesteps(T, n)
        assert got.shape == (n,) and got[0] == T - 1 and got[-1] == 0
        assert (np.diff(got) <= 0).all()
        if not np.array_equal(got, want):
            differ.append(n)
            # one grid point off by one: a .5 tie rounded the other way
            assert np.abs(got - want).max() == 1
    assert tuple(differ) == DIFFER.get(T, ())
