"""Command-line tools over the port's CFA front door, run as
``python -m repro_torch.tools.<name>``: ``cfa_lint`` (the static verifier
over the program x storage x backend matrix), ``cfa_trace`` (one traced run
as a Chrome trace) and ``dump_pipeline`` (a compile's pass trace).  Each
takes the reference tool's arguments and gives its output and exit codes,
plus ``--device`` (``cuda`` by default; ``cpu`` is asked for explicitly)."""
