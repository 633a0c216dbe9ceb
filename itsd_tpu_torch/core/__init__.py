from .process import (extract, p_mean_variance, p_sample_step,
                      predict_prev_mean_from_eps, predict_x0_from_eps,
                      q_sample)
from .sampling import denoise_segment, sample
from .schedules import DiffusionSchedule, linear_schedule, make_schedule

__all__ = ["DiffusionSchedule", "linear_schedule", "make_schedule", "extract",
           "q_sample", "predict_prev_mean_from_eps", "p_mean_variance",
           "p_sample_step", "predict_x0_from_eps", "sample",
           "denoise_segment"]
