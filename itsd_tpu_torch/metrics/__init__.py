from .frechet import (compute_fid, frechet_distance, frechet_distance_torch,
                      gaussian_stats)
from .is_score import inception_score, inception_score_from_probs, is_score
from .evaluator import FID, IS, CLIPScore, load_images
from .features import (default_extractors, make_clip_feature_fn,
                       make_inception_extractors, pixel_feature_fn)

__all__ = ["compute_fid", "frechet_distance", "frechet_distance_torch",
           "gaussian_stats", "inception_score", "inception_score_from_probs",
           "is_score", "FID", "IS", "CLIPScore", "load_images",
           "default_extractors", "make_clip_feature_fn",
           "make_inception_extractors", "pixel_feature_fn"]
