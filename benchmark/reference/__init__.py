"""Plain references that decide a run's ``correct``.

Plain PyTorch and NumPy only: nothing here imports the program under test,
JAX or the JAX package.  Each function takes tensors and numbers and works
out again, from them, whatever the program derived (prior factors, weights,
variances, segments).
"""
