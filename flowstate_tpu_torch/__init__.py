"""PyTorch/CUDA port of ``flowstate_tpu``.

Each module mirrors its JAX counterpart under ``flowstate_tpu/`` (same
subpackage, same file name) and names it in its docstring.  The port runs
on an NVIDIA Hopper card; its hand-written kernels, the Metropolis move
loop (``csrc/metropolis_moves.cu``) and the total pair energy
(``csrc/pair_energy.cu``), are built with ``nvcc`` at first use
(``kernels/build.py``).  Every function takes tensors with a leading chains
axis and an explicit ``device``; nothing here imports JAX.
"""
