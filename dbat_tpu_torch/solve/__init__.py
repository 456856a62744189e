"""Normal equations, kernels and damped solvers (counterpart of
dbat_tpu/solve)."""
