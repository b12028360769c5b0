"""Hand-written Hopper kernels for the port's hot spots.

Each kernel ships as a triple, as in the reference's ``repro.kernels``:
``kernel.py`` (build of the CUDA source under ``csrc/`` and its ctypes
binding), ``ops.py`` (public wrapper: checks, dispatch by device, launch
counter, and for the LM kernels a ``torch.autograd.Function``), ``ref.py``
(plain-torch oracle, the path a CPU tensor takes).

  forest/     dense-forest inference (the paper's prediction-latency hot
              spot, §7.1); replaces the reference's Pallas ``_forest_kernel``
  mamba/      chunked SSD scan (Mamba2 in the LM framework); replaces the
              reference's Pallas ``_ssd_kernel``
  attention/  flash attention forward (the LM framework's training
              attention); replaces the reference's Pallas ``_flash_kernel``

``_build.py`` compiles each ``csrc/*.cu`` with ``nvcc`` and loads it;
``watch.py`` shows each wrapper call of the LM kernels to a watcher.
"""
from . import attention, forest, mamba  # noqa: F401
