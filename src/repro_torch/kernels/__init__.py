"""Hand-written Hopper kernels of the port, one package each, built from
their `csrc/` sources at first use (`_build.py`)."""
