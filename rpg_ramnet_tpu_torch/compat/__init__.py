from .from_jax import load_reference_checkpoint, params_from_jax

__all__ = ["load_reference_checkpoint", "params_from_jax"]
