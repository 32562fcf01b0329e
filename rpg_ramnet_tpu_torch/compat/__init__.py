from .from_jax import (load_reference_checkpoint, params_from_jax,
                       params_to_state_dict)

__all__ = ["load_reference_checkpoint", "params_from_jax",
           "params_to_state_dict"]
