"""The benchmark of the PyTorch/CUDA port: ``run.py`` runs one cell of
``BENCHMARK.json`` once; ``harness.py`` says where each configuration,
traffic mix and metric is found."""
