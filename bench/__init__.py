"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One process runs one cell: ``python3 bench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.  Everything that measures, generates or
judges lives here, frozen against later changes of the program: the data
and LSH draws (``data``), the window statistics (``stats``), the reduction
of a profiler trace (``trace``), the operation and byte counts and the
card's peaks (``work``), the plain reference jobs (``reference``) and the
comparison that decides ``correct`` (``judge``).  From the program it
takes only the entry a configuration's driver calls, the kernel names and
the ``ops`` probe hook.  It imports neither JAX nor the JAX package.
"""
