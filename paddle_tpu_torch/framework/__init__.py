"""Framework utilities of the port."""
from paddle_tpu_torch.framework.io import (load_numpy_state_dict,
                                           numpy_grads, numpy_state_dict)
from paddle_tpu_torch.framework.state import (register_state_tensor,
                                              registry_version, state_tensors)

__all__ = ["load_numpy_state_dict", "numpy_grads", "numpy_state_dict",
           "register_state_tensor", "registry_version", "state_tensors"]
