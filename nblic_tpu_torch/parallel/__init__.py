"""Multi-device SPMD: the data x tiles mesh on torch.distributed (``mesh.py``)."""
