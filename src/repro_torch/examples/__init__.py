"""The examples over the port, run as ``python -m
repro_torch.examples.<name>``: ``quickstart`` (one ``cfa.compile`` of the
paper's running example, its burst table against the baselines, the
oracle check and the backends rebound), ``stencil_pipeline`` (a gaussian
blur through the ``cuda`` kernel backend), ``serve_decode`` (batched
prefill and decode through ``python -m repro_torch.launch.serve``),
``train_lm`` (a ~114M-parameter dense LM trained with checkpoints and a
resume) and ``pipeline_parallel`` (a 4-stage GPipe over 4 gloo ranks).
Each takes the reference example's arguments plus ``--device`` (``cuda`` by
default; ``cpu`` is asked for explicitly) and ends its output with ``OK``."""
