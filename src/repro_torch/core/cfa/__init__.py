"""Canonical Facet Allocation (CFA) — the PyTorch port of ``repro.core.cfa``.

Module for module the reference package's layout, so a reader finds each
counterpart by name.  The numpy-only modules are copies (``spaces``,
``facets``, ``plans``, ``bandwidth`` with the H100 preset in place of the
TPU one, ``multiport``, ``autotune``, ``passes``, ``obs``, ``analysis``);
``programs``, ``transform``, ``compress``, ``irredundant``, ``allocation``,
``executors``, ``calibrate`` and ``api`` work on tensors.  The stencil tile
executor is a hand-written CUDA kernel (``repro_torch.kernels.stencil``).

Public API (the reference's, with ``H100_HBM3`` in place of
``TPU_V5E_HBM``; ``repro_torch.cfa`` is the curated front door):

* ``IterSpace`` / ``Deps`` / ``Tiling`` / ``facet_widths`` — iteration
  spaces, dependences, tilings (§IV-A..F).
* ``FacetSpec`` / ``build_facet_specs`` / ``extension_dir`` /
  ``CONTIGUITY_LEVELS`` — the facet layout (§IV-F..I).
* ``pack_facet`` / ``pack_all`` / ``unpack_into`` — canonical volume <->
  facet arrays (dedup-aware with a storage map).
* ``STORAGE_MODES`` / ``StorageMap`` / ``build_storage_map`` /
  ``owner_of`` / ``dedup_facets`` / ``rehydrate_facets`` /
  ``IrredundantPipeline`` / ``CompressedPipeline`` / ``BlockCodec`` /
  ``CODECS`` / ``get_codec`` — irredundant and compressed facet storage
  (Ferry 2024).
* ``TransferPlan`` / ``cfa_plan`` / ``interior_tile`` / the baseline
  plans — exact per-tile burst statistics (§V-C).
* ``BurstModel`` / ``PortedPlan`` / ``BandwidthReport`` / ``AXI_ZC706`` /
  ``H100_HBM3`` / ``overlap_speedup`` — the bandwidth model.
* ``assign_ports`` / ``repartition`` / ``best_repartition`` — the §VII
  repartition arithmetic, executed by the ``sharded`` backend.
* ``StencilProgram`` / ``PROGRAMS`` / ``get_program`` — the Table I suite.
* ``CFAPipeline`` — the read->execute->write tile pipeline of §V.
* ``autotune`` / ``LayoutCandidate`` / ``ScoredLayout`` /
  ``LayoutDecision`` — the layout search (modeled or measured score).
* ``measure_runs`` / ``measure_plan`` / ``fit_burst_model`` /
  ``calibrate`` / ``CalibratedModel`` / ``Calibration`` — measured-vs-
  modeled calibration on a device.
* ``verify`` / ``Diagnostic`` / ``AnalysisReport`` / ``lint_plan`` /
  ``DEFAULT_ANALYSES`` — the static verifier and burst lint.
* ``TraceRecorder`` / ``Span`` / ``Counters`` / ``chrome_trace`` —
  runtime telemetry.
* ``CompileState`` / ``PassPipeline`` / ``default_pipeline`` — the staged
  lowering; ``compile`` / ``CompiledStencil`` / ``Target`` — the front end;
  ``EXECUTORS`` / ``select_backend`` / ``BackendError`` — the backend
  registry (``reference``, ``sweep``, ``wavefront``, ``cuda``,
  ``sharded``, ``dataflow``).
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
from .allocation import pack_facet, pack_all, unpack_into
from .compress import BlockCodec, CODECS, get_codec
from .irredundant import (
    STORAGE_MODES,
    StorageMap,
    build_storage_map,
    owner_of,
    dedup_facets,
    rehydrate_facets,
    IrredundantPipeline,
    CompressedPipeline,
)
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
    H100_HBM3,
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
from .calibrate import (
    TransferSample,
    CalibratedModel,
    Calibration,
    CalibrationError,
    measure_runs,
    measure_plan,
    fit_burst_model,
    calibrate,
    measurement_noise,
    timing_unusable_reason,
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
from .analysis import (
    Diagnostic,
    AnalysisReport,
    VerificationError,
    AnalysisPass,
    analysis_pass,
    DEFAULT_ANALYSES,
    check_facet_family,
    plan_accounting,
    check_overlap_schedule,
    lint_plan,
    run_analyses,
    verify,
    verify_pipeline,
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
    "pack_facet", "pack_all", "unpack_into",
    "STORAGE_MODES", "StorageMap", "build_storage_map", "owner_of",
    "dedup_facets", "rehydrate_facets",
    "IrredundantPipeline", "CompressedPipeline",
    "BlockCodec", "CODECS", "get_codec",
    "TransferPlan", "count_runs", "cfa_plan", "cfa_piece_census", "original_layout_plan",
    "bounding_box_plan", "data_tiling_plan", "interior_tile",
    "BurstModel", "PortedPlan", "BandwidthReport", "AXI_ZC706", "H100_HBM3",
    "overlap_speedup",
    "PortAssignment", "PORT_STRATEGIES", "assign_ports",
    "repartition", "best_repartition", "port_speedup",
    "StencilProgram", "PROGRAMS", "get_program",
    "LayoutCandidate", "ScoredLayout", "LayoutDecision", "CacheSchemaError",
    "SCORE_MODES", "autotune", "candidate_tilings", "hand_coded_baselines",
    "TransferSample", "CalibratedModel", "Calibration", "CalibrationError",
    "measure_runs", "measure_plan", "fit_burst_model", "calibrate",
    "measurement_noise", "timing_unusable_reason",
    "Span", "Counters", "TraceRecorder", "RuntimeReport", "runtime_report",
    "chrome_trace", "validate_chrome_trace",
    "CFAPipeline",
    "CompileState", "Pass", "PassPipeline", "PassTrace", "PipelineError",
    "DEFAULT_PASSES", "default_pipeline", "default_pass_fingerprint",
    "estimate_facet_bytes",
    "BackendError", "Executor", "ExecutorCaps", "EXECUTORS",
    "register_executor", "get_executor", "available_backends",
    "ineligible_reason", "select_backend",
    "Diagnostic", "AnalysisReport", "VerificationError",
    "AnalysisPass", "analysis_pass", "DEFAULT_ANALYSES",
    "check_facet_family", "plan_accounting", "check_overlap_schedule",
    "lint_plan", "run_analyses", "verify", "verify_pipeline",
    "Target", "TARGETS", "register_target", "get_target",
    "compile", "CompiledStencil",
]
