"""The plain reference of the benchmark: NumPy and PyTorch only.

It imports neither JAX nor either seigen package, and works out the mesh,
the operators, the source, the sponge and the receivers again from the
run's inputs.
"""
