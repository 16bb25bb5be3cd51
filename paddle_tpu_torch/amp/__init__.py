"""Mixed precision of the port: autocast and the activation-residency
policy (counterpart of ``paddle_tpu/amp``)."""
from paddle_tpu_torch.amp.auto_cast import (amp_guard, auto_cast,
                                             downcast_inputs)
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.amp.grad_scaler import GradScaler
from paddle_tpu_torch.amp.policy import (ActivationPolicy,
                                         activation_residency,
                                         current_policy, remat_active)

__all__ = ["ActivationPolicy", "GradScaler", "activation_residency",
           "amp_guard", "auto_cast", "current_policy", "debugging",
           "downcast_inputs", "remat_active"]
