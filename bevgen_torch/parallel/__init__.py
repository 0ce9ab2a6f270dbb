"""Data parallelism on `torch.distributed`: process start-up and rank-0
helpers (`distributed.py`), the mesh, ZeRO slices of the optimizer state
and each rank's batch rows (`sharding.py`)."""
