from .frechet import (frechet_distance, frechet_distance_torch,
                      gaussian_stats)
from .is_score import is_score

__all__ = ["frechet_distance", "frechet_distance_torch", "gaussian_stats",
           "is_score"]
