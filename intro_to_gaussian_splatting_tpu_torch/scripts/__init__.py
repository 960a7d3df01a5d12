"""Scripts run as modules:
``python -m intro_to_gaussian_splatting_tpu_torch.scripts.<name>``."""
