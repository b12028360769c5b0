"""repro_torch.workloads — the compute-kernel workload suite in torch
(``suite``, the port of ``repro.workloads.suite``), its ground truth
(``collect``) and the streaming collector (``stream``)."""
