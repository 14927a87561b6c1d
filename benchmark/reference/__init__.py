"""Plain f32 PyTorch reference of the benchmarked networks and train step.

Imports neither JAX nor anything of the program: the comparison that decides
``correct`` holds the program against it."""
