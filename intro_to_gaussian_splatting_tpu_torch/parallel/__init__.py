"""Training over a device mesh: one torch.distributed rank per device."""
