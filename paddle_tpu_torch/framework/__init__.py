"""Framework utilities of the port."""
from paddle_tpu_torch.framework.io import (load_numpy_state_dict,
                                           numpy_grads, numpy_state_dict)
from paddle_tpu_torch.framework.state import (get_rng_state, next_key,
                                              register_state_tensor,
                                              registry_version, seed,
                                              set_rng_state, state_tensors)

__all__ = ["get_rng_state", "load_numpy_state_dict", "next_key",
           "numpy_grads", "numpy_state_dict", "register_state_tensor",
           "registry_version", "seed", "set_rng_state", "state_tensors"]
