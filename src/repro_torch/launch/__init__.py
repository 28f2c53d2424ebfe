"""Launchers of the LM substrate: ``python -m repro_torch.launch.serve``."""
