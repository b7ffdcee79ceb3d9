from paddlescience_torch.utils import expression, initializer, jax_params, save_load

__all__ = ["expression", "initializer", "jax_params", "save_load"]
