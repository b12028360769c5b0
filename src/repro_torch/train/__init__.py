"""Training (the port of ``repro.train``): ``optimizer`` (AdamW), ``step``
(loss, gradients, microbatch accumulation, update) and ``loop``
(``run_training`` on one device). The gradient compression and pipeline
stages of the reference's ``grad.py`` and ``pipeline.py`` are multi-device
and come with ROADMAP item 11.7."""
