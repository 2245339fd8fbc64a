"""The benchmark of the PyTorch port (``minigrid_dynamicprogramming_tpu_torch``)
on NVIDIA cards: ``run.py`` runs one cell of ``BENCHMARK.json``."""
