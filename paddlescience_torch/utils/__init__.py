from paddlescience_torch.utils import expression, initializer, jax_params

__all__ = ["expression", "initializer", "jax_params"]
