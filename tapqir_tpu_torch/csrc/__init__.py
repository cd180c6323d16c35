"""Native sources of the port and the one module that builds them.

``native.py`` builds, loads, launches and counts every compiled library:
the CUDA kernels (``offset_gamma.cu``, ``sparse_adam.cu`` and
``spot_render.cu``, declared with their launchers by the modules of the
same names under ``ops/``) and the host Glimpse decoder (``glimpse_io.cpp``,
declared by ``glimpse_native.py``)."""
