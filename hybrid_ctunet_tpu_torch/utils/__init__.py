from .params import load_numpy_state_dict, random_init_, tunet_state_dict_from_jax

__all__ = ["load_numpy_state_dict", "random_init_", "tunet_state_dict_from_jax"]
