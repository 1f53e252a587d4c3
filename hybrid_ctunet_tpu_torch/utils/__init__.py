from .params import (
    ctunet_state_dict_from_jax, cunet_state_dict_from_jax, load_numpy_state_dict,
    random_init_, tunet_state_dict_from_jax,
)

__all__ = ["ctunet_state_dict_from_jax", "cunet_state_dict_from_jax", "load_numpy_state_dict",
           "random_init_", "tunet_state_dict_from_jax"]
