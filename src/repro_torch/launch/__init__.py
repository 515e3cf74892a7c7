"""Launchers of the port: ``python -m repro_torch.launch.serve`` (the
resilient asyncio front door, the LM decode path) and ``python -m
repro_torch.launch.train`` (the trainer); ``mesh`` builds device meshes,
``inputs`` the models' input stand-ins."""
