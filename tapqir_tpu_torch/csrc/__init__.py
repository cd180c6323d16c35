"""Native sources of the port: the CUDA kernels (``offset_gamma.cu``, built
by ``ops/offset_gamma.py``) and the host Glimpse decoder
(``glimpse_io.cpp``, built by ``glimpse_native.py``)."""
