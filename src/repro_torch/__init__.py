"""repro_torch — the PyTorch/CUDA port of ``repro``.

The paper's predictor (Braun et al., 2020) served on an NVIDIA H100: the
numpy core is copied from ``repro``, the inference paths are torch, and the
forest-inference kernel is hand-written CUDA for Hopper. The LM framework's
zamba2 serving path (``configs``, ``models``, ``launch.serve``) runs its
Mamba2 prefill through a hand-written CUDA chunked-SSD kernel. The
pipeline's front end is torch too: the workload suite
(``workloads.suite``) and the feature walker over ``torch.export`` graphs
(``core.features``). The package imports
torch and numpy, never JAX and never ``repro``. Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``. See
``README.md`` in this directory.
"""
