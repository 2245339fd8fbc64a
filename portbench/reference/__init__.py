"""Part of the benchmark of the PyTorch port (see ``portbench/harness.py``)."""
