"""Build of the hand-written CUDA kernels (``build.py``)."""
