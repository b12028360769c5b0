"""Hand-written Hopper kernels for the port's hot spots.

Each kernel ships as a triple, as in the reference's ``repro.kernels``:
``kernel.py`` (build of the CUDA source under ``csrc/`` and its ctypes
binding), ``ops.py`` (public wrapper: checks, padding, dispatch by device,
launch counter), ``ref.py`` (plain-torch oracle, the path a CPU tensor
takes).

  forest/    dense-forest inference (the paper's prediction-latency hot
             spot, §7.1); replaces the reference's Pallas ``_forest_kernel``
  mamba/     chunked SSD scan (Mamba2 prefill in the LM framework);
             replaces the reference's Pallas ``_ssd_kernel``

``_build.py`` compiles each ``csrc/*.cu`` with ``nvcc`` and loads it.
"""
from . import forest, mamba  # noqa: F401
