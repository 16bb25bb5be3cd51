"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu."""
