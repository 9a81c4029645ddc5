"""The PyTorch and CUDA port's benchmark (``python gpu_bench/run.py``).

Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.  See README.md."""
