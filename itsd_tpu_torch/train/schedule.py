"""Learning-rate schedule: gradual warmup chaining into cosine annealing.

Counterpart of ``itsd_tpu/train/schedule.py``, as a plain function of the
step: warmup is epoch-granular (linear from base_lr to multiplier*base_lr
over ``warm_epochs`` epochs), then cosine from multiplier*base_lr to 0 over
``total_epochs``. The lr is constant within an epoch.
"""

from __future__ import annotations

import math


def warmup_cosine_epochs(base_lr: float, multiplier: float, total_epochs: int,
                         warm_epochs: int, steps_per_epoch: int):
    """Returns ``schedule(step) -> lr`` (a Python float).

      e <= warm:  lr = base * ((multiplier - 1) * e / warm + 1)
      e >  warm:  lr = base * multiplier * (1 + cos(pi * (e - warm) / total)) / 2
    with e = step // steps_per_epoch and warm = max(warm_epochs, 1).
    """
    warm = max(warm_epochs, 1)

    def schedule(step: int) -> float:
        e = step // steps_per_epoch
        if e <= warm:
            return base_lr * ((multiplier - 1.0) * e / warm + 1.0)
        return (base_lr * multiplier
                * 0.5 * (1.0 + math.cos(math.pi * (e - warm) / total_epochs)))

    return schedule
