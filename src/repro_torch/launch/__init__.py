"""Launch layer: the logzip CLI (``python -m repro_torch.launch.compress``)."""
