from .process import (diffusion_train_terms, extract, loss_reduce,
                      min_snr_weight, mse_elementwise, p_mean_variance,
                      p_sample_step, predict_prev_mean_from_eps,
                      predict_x0_from_eps, q_sample, snr)
from .sampling import denoise_segment, sample
from .schedules import DiffusionSchedule, linear_schedule, make_schedule

__all__ = ["DiffusionSchedule", "linear_schedule", "make_schedule", "extract",
           "q_sample", "diffusion_train_terms", "mse_elementwise", "snr",
           "min_snr_weight", "loss_reduce", "predict_prev_mean_from_eps",
           "p_mean_variance", "p_sample_step", "predict_x0_from_eps",
           "sample", "denoise_segment"]
