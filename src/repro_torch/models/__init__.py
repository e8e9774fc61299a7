from .convnets import (Checkpoint, DarkNetLike, LeNet, TrainedModel,
                       load_checkpoint, params_from_jax, trained_model)
from .spec import (ParamSpec, abstract_params, axes_tree, init_params,
                   is_spec, param_bytes, param_count)

__all__ = ["LeNet", "DarkNetLike", "params_from_jax", "load_checkpoint",
           "Checkpoint", "TrainedModel", "trained_model", "ParamSpec",
           "init_params", "abstract_params", "axes_tree", "is_spec",
           "param_count", "param_bytes"]
