"""The plain reference of the benchmark's cells, in float64 PyTorch and
NumPy: the Lennard-Jones double-well energy (``system``), the circular
rational-quadratic-spline coupling flow with its residual and transformer
conditioners (``flow``), and the move kernel's random stream with the
Metropolis verdicts (``metropolis``).

It imports neither JAX, nor the JAX package, nor anything of
``flowstate_tpu_torch``, and takes nothing the program made: it is given
the benchmark's own inputs (the weights, the seed) and the program's
outputs, which it only judges.
"""
