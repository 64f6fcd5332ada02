"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

Everything that measures lives here and is kept apart from the program
under test: traffic generation (``traffic``), the driver that offers it
to the engine on the host's monotonic clock (``driver``), weights made on
the device from the seed (``weights``), the plain float32 reference and
the comparison that decides ``correct`` (``reference``, ``correct``), the
profiler's reduction (``trace``), the frozen operation and byte counts
and the data sheet's peaks (``counts``), and the cell runner that ties
them to ``BENCHMARK.json`` (``cell``).  Nothing here imports JAX or the
JAX package; only ``cell`` and ``driver`` import ``repro_torch``.
"""
