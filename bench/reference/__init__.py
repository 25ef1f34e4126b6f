"""Plain reference jobs of AccurateML (arXiv:1708.01341, Algorithm 1) in
PyTorch, which the benchmark holds the program's jobs against.

They import nothing of the program and take nothing it made: the data and
the LSH draws come from the harness, which hands the same to both sides.
Every product goes through ``common.mm`` in the run's precision:
``"float64"`` judges the program, ``"tf32"`` is the control (float32 with
TF32 products, the step below the float32 the configurations state).
"""
