from .classifier import (ClassifierConfig, SmallCNN, load_classifier,
                         load_classifier_extractors, save_classifier,
                         train_classifier)
from .convert import (classifier_params_from_jax, clip_params_from_jax,
                      inception_params_from_jax, params_from_jax)
from .embeddings import (ConditionalEmbedding, FunctionalTimeEmbedding,
                         TableTimeEmbedding, sinusoidal_features)
from .unet import UNet, UNetConfig, cond_unet_config, uncond_unet_config

__all__ = ["UNet", "UNetConfig", "uncond_unet_config", "cond_unet_config",
           "FunctionalTimeEmbedding", "TableTimeEmbedding",
           "ConditionalEmbedding", "sinusoidal_features",
           "params_from_jax", "classifier_params_from_jax",
           "inception_params_from_jax", "clip_params_from_jax",
           "ClassifierConfig", "SmallCNN", "train_classifier",
           "save_classifier", "load_classifier",
           "load_classifier_extractors"]
