from .process import (cfg_combine, cfg_nfes, diffusion_train_terms, extract,
                      loss_reduce, make_autoguidance_eps_fn, make_cfg_eps_fn,
                      min_snr_weight, mse_elementwise, p_mean_variance,
                      p_sample_step, predict_prev_mean_from_eps,
                      predict_x0_from_eps, q_sample, snr)
from .sampling import (ddim_sample, ddim_segment, denoise_segment,
                       dpm_segment, dpm_solver_sample, make_segment_denoiser,
                       parallel_picard_sample, renoise, restart_nfes,
                       restart_sample, sample, sample_with_snapshots)
from .schedules import DiffusionSchedule, linear_schedule, make_schedule

__all__ = [
    "DiffusionSchedule", "linear_schedule", "make_schedule",
    "extract", "q_sample", "diffusion_train_terms", "mse_elementwise",
    "snr", "min_snr_weight", "loss_reduce", "predict_prev_mean_from_eps",
    "p_mean_variance", "p_sample_step", "predict_x0_from_eps",
    "cfg_combine", "cfg_nfes", "make_autoguidance_eps_fn", "make_cfg_eps_fn",
    "sample", "ddim_sample", "dpm_solver_sample", "parallel_picard_sample",
    "denoise_segment", "renoise", "sample_with_snapshots",
    "ddim_segment", "dpm_segment", "make_segment_denoiser",
    "restart_sample", "restart_nfes",
]
