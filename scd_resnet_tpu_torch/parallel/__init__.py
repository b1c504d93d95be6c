"""The parallel layer: the device mesh (``mesh.py``: data and model axes
across ``torchrun`` ranks) and the GPipe hourglass pipeline
(``pipeline.py``: the pipe axis over a rank's devices)."""
