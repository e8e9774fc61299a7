from .convnets import (Checkpoint, DarkNetLike, LeNet, TrainedModel,
                       load_checkpoint, params_from_jax, trained_model)
from .encdec import EncDec, EncDecConfig
from .spec import (ParamSpec, abstract_params, axes_tree, init_params,
                   is_spec, param_bytes, param_count)
from .transformer import LM, LMConfig, lm_params_from_jax

__all__ = ["LeNet", "DarkNetLike", "params_from_jax", "load_checkpoint",
           "Checkpoint", "TrainedModel", "trained_model", "ParamSpec",
           "init_params", "abstract_params", "axes_tree", "is_spec",
           "param_count", "param_bytes", "LM", "LMConfig", "EncDec",
           "EncDecConfig", "lm_params_from_jax"]
