from .config import (Config, DataCfg, DiffusionCfg, ModelCfg, SearchCfg,
                     TrainCfg, apply_overrides, coerce, load_config, to_dict)
from .images import make_grid, save_image_grid

__all__ = ["Config", "DataCfg", "DiffusionCfg", "ModelCfg", "SearchCfg",
           "TrainCfg", "apply_overrides", "coerce", "load_config", "to_dict",
           "make_grid", "save_image_grid"]
