"""Hand-written Hopper kernels (``csrc/``), their launches, their plain
PyTorch versions (``ref.py``) and the validating wrappers (``ops.py``)."""
