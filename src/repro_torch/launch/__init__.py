"""Entry points: ``python -m repro_torch.launch.train`` (SFT + GRPO + evaluation)
and ``python -m repro_torch.launch.serve`` (the routing service)."""
