"""Launchers of the port: ``python -m repro_torch.launch.serve`` (the
resilient asyncio front door, the LM decode path), ``python -m
repro_torch.launch.train`` (the trainer) and ``python -m
repro_torch.launch.dryrun`` (every arch x shape cell counted on ``meta``
tensors); ``mesh`` builds device meshes, ``shardspec`` the sharding policy
over them, ``inputs`` the models' input stand-ins."""
