from .convnets import Checkpoint, LeNet, load_checkpoint, params_from_jax

__all__ = ["LeNet", "params_from_jax", "load_checkpoint", "Checkpoint"]
