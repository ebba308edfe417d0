"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package each:
``ref.py`` holds the plain PyTorch version, ``ops.py`` the wrapper that
dispatches on the tensor's device (CUDA -> kernel, CPU -> plain version),
and ``<name>.cu`` the kernel with a plain C launcher.  ``_build`` compiles
the sources with ``nvcc`` at first use and loads them with ``ctypes``."""
