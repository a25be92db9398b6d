"""The benchmark of the PyTorch / CUDA port (``repro_torch``): one command,
``python3 bench/run.py``, and data files that describe its cells."""
