from .algorithms import (SearchResult, gradient_search, path_search,
                         pruned_search, random_search, smc_search,
                         smc_search_nfes, zero_order_search)
from .verifiers import (adaptive_avg_pool, aesthetic_score,
                        ensemble_fid_is_verifier,
                        batch_pixel_variance_score, classifier_verifier,
                        clip_score_verifier, integrated_verifier,
                        oracle_verifier, reference_integrated_weights,
                        self_supervised_verifier, supervised_verifier,
                        to_unit_range)

__all__ = [
    "SearchResult", "gradient_search", "path_search", "pruned_search",
    "random_search", "smc_search", "smc_search_nfes",
    "zero_order_search", "adaptive_avg_pool", "aesthetic_score",
    "batch_pixel_variance_score", "classifier_verifier",
    "clip_score_verifier", "ensemble_fid_is_verifier",
    "integrated_verifier", "oracle_verifier",
    "reference_integrated_weights", "self_supervised_verifier",
    "supervised_verifier", "to_unit_range",
]
