"""Framework utilities of the port."""
from paddle_tpu_torch.framework.io import (load_numpy_state_dict,
                                           numpy_grads, numpy_state_dict)

__all__ = ["load_numpy_state_dict", "numpy_grads", "numpy_state_dict"]
