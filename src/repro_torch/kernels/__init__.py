"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Layout per kernel: ``csrc/<name>.cu`` holds the CUDA source, ``<name>.py``
its ``ctypes`` binding and plain PyTorch version, ``ops.py`` the public
wrappers (checks, device routing, launch counts), ``ref.py`` the oracles,
``build.py`` the ``nvcc`` build, and ``roofline.py`` the bytes model that
gives each kernel's bound.
"""
