"""Canonical Facet Allocation (CFA) — the PyTorch port of ``repro.core.cfa``.

Module for module the reference package's layout, so a reader finds each
counterpart by name.  The numpy-only modules are copies (``spaces``,
``facets``, ``plans``, ``bandwidth`` without the TPU preset, ``multiport``,
``autotune``, ``passes``, ``obs``), or the parts of one that the main path
needs (``compress``, ``irredundant``, ``analysis``); ``programs``,
``transform``, ``executors`` and ``api`` work on tensors.  The stencil tile
executor is a hand-written CUDA kernel (``repro_torch.kernels.stencil``).

Public API (the subset of the reference's that this slice of the port
runs; ``repro_torch.cfa`` is the curated front door):

* ``IterSpace`` / ``Deps`` / ``Tiling`` / ``facet_widths`` — iteration
  spaces, dependences, tilings (§IV-A..F).
* ``FacetSpec`` / ``build_facet_specs`` / ``extension_dir`` /
  ``CONTIGUITY_LEVELS`` — the facet layout (§IV-F..I).
* ``TransferPlan`` / ``cfa_plan`` / ``interior_tile`` / the baseline
  plans — exact per-tile burst statistics (§V-C).
* ``BurstModel`` / ``PortedPlan`` / ``BandwidthReport`` / ``AXI_ZC706`` /
  ``overlap_speedup`` — the bandwidth model.
* ``assign_ports`` / ``repartition`` / ``best_repartition`` — the §VII
  repartition arithmetic (no multi-port backend yet).
* ``StencilProgram`` / ``PROGRAMS`` / ``get_program`` — the Table I suite.
* ``CFAPipeline`` — the read->execute->write tile pipeline of §V.
* ``autotune`` / ``LayoutCandidate`` / ``ScoredLayout`` /
  ``LayoutDecision`` — the layout search (modeled score).
* ``TraceRecorder`` / ``Span`` / ``Counters`` / ``chrome_trace`` —
  runtime telemetry.
* ``CompileState`` / ``PassPipeline`` / ``default_pipeline`` — the staged
  lowering; ``compile`` / ``CompiledStencil`` / ``Target`` — the front end;
  ``EXECUTORS`` / ``select_backend`` / ``BackendError`` — the backend
  registry (``reference``, ``sweep``, ``wavefront``, ``cuda``).
"""
from .spaces import (
    IterSpace,
    Deps,
    Tiling,
    facet_widths,
    flow_in_points,
    flow_out_points,
    facet_points,
    neighbor_offsets,
)
from .facets import (
    FacetSpec,
    build_facet_specs,
    extension_dir,
    CONTIGUITY_LEVELS,
)
from .compress import BlockCodec, CODECS, get_codec
from .irredundant import STORAGE_MODES, StorageMap, build_storage_map, owner_of
from .plans import (
    TransferPlan,
    count_runs,
    cfa_plan,
    cfa_piece_census,
    original_layout_plan,
    bounding_box_plan,
    data_tiling_plan,
    interior_tile,
)
from .bandwidth import (
    BurstModel,
    PortedPlan,
    BandwidthReport,
    AXI_ZC706,
    overlap_speedup,
)
from .multiport import (
    PortAssignment,
    PORT_STRATEGIES,
    assign_ports,
    repartition,
    best_repartition,
    port_speedup,
)
from .programs import StencilProgram, PROGRAMS, get_program
from .autotune import (
    LayoutCandidate,
    ScoredLayout,
    LayoutDecision,
    CacheSchemaError,
    SCORE_MODES,
    autotune,
    candidate_tilings,
    hand_coded_baselines,
)
from .obs import (
    Span,
    Counters,
    TraceRecorder,
    RuntimeReport,
    runtime_report,
    chrome_trace,
    validate_chrome_trace,
)
from .transform import CFAPipeline
from .passes import (
    CompileState,
    Pass,
    PassPipeline,
    PassTrace,
    PipelineError,
    DEFAULT_PASSES,
    default_pipeline,
    default_pass_fingerprint,
    estimate_facet_bytes,
)
from .executors import (
    BackendError,
    Executor,
    ExecutorCaps,
    EXECUTORS,
    register_executor,
    get_executor,
    available_backends,
    ineligible_reason,
    select_backend,
)
from .api import (
    Target,
    TARGETS,
    register_target,
    get_target,
    compile,
    CompiledStencil,
)

__all__ = [
    "IterSpace", "Deps", "Tiling", "facet_widths",
    "flow_in_points", "flow_out_points", "facet_points", "neighbor_offsets",
    "FacetSpec", "build_facet_specs", "extension_dir", "CONTIGUITY_LEVELS",
    "STORAGE_MODES", "StorageMap", "build_storage_map", "owner_of",
    "BlockCodec", "CODECS", "get_codec",
    "TransferPlan", "count_runs", "cfa_plan", "cfa_piece_census", "original_layout_plan",
    "bounding_box_plan", "data_tiling_plan", "interior_tile",
    "BurstModel", "PortedPlan", "BandwidthReport", "AXI_ZC706",
    "overlap_speedup",
    "PortAssignment", "PORT_STRATEGIES", "assign_ports",
    "repartition", "best_repartition", "port_speedup",
    "StencilProgram", "PROGRAMS", "get_program",
    "LayoutCandidate", "ScoredLayout", "LayoutDecision", "CacheSchemaError",
    "SCORE_MODES", "autotune", "candidate_tilings", "hand_coded_baselines",
    "Span", "Counters", "TraceRecorder", "RuntimeReport", "runtime_report",
    "chrome_trace", "validate_chrome_trace",
    "CFAPipeline",
    "CompileState", "Pass", "PassPipeline", "PassTrace", "PipelineError",
    "DEFAULT_PASSES", "default_pipeline", "default_pass_fingerprint",
    "estimate_facet_bytes",
    "BackendError", "Executor", "ExecutorCaps", "EXECUTORS",
    "register_executor", "get_executor", "available_backends",
    "ineligible_reason", "select_backend",
    "Target", "TARGETS", "register_target", "get_target",
    "compile", "CompiledStencil",
]
