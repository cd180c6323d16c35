"""Native sources of the port: the CUDA kernels (``offset_gamma.cu``,
``sparse_adam.cu`` and ``spot_render.cu``, built by the modules of the same
names under ``ops/``) and the host Glimpse decoder (``glimpse_io.cpp``,
built by ``glimpse_native.py``)."""
