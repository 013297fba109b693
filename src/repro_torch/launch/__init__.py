"""Launch layer: the logzip CLI (``python -m repro_torch.launch.compress``),
the LM serving launcher (``python -m repro_torch.launch.serve``) and the
LM training launcher (``python -m repro_torch.launch.train``)."""
