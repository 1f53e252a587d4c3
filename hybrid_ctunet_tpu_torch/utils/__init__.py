from .params import (
    ctunet_state_dict_from_jax, cunet_state_dict_from_jax, load_numpy_state_dict,
    random_init_, tunet_state_dict_from_jax,
)
from .profiling import StepTimer, enable_nan_checks, trace

__all__ = ["StepTimer", "ctunet_state_dict_from_jax", "cunet_state_dict_from_jax",
           "enable_nan_checks", "load_numpy_state_dict", "random_init_", "trace",
           "tunet_state_dict_from_jax"]
