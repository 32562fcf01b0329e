from .from_jax import (import_reference_optimizer_state,
                       load_reference_checkpoint, ordered_param_names,
                       params_from_jax, params_to_state_dict)

__all__ = ["import_reference_optimizer_state", "load_reference_checkpoint",
           "ordered_param_names", "params_from_jax", "params_to_state_dict"]
