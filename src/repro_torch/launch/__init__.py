"""Launch layer: the logzip CLI (``python -m repro_torch.launch.compress``)
and the LM serving launcher (``python -m repro_torch.launch.serve``)."""
