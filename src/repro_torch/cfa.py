"""``repro_torch.cfa`` — the public front door to the port's CFA stack.

The PyTorch counterpart of ``repro.cfa``:

    from repro_torch import cfa

    compiled = cfa.compile("jacobi2d5p", (16, 32, 32))   # autotuned, on CUDA
    facets   = compiled(inputs)                          # run it
    print(compiled.report())                             # bandwidth stats
    on_cpu   = cfa.compile("jacobi2d5p", (16, 32, 32), device="cpu")

Everything here re-exports from :mod:`repro_torch.core.cfa`; the names are
the subset of ``repro.cfa.__all__`` this slice of the port runs.
"""
from repro_torch.core.cfa import (
    # the front door
    compile,
    CompiledStencil,
    # platform registry
    Target,
    TARGETS,
    register_target,
    get_target,
    AXI_ZC706,
    # execution backends + the capability gate
    Executor,
    ExecutorCaps,
    EXECUTORS,
    register_executor,
    get_executor,
    available_backends,
    select_backend,
    BackendError,
    # layout machinery a compile() caller sees
    IterSpace,
    Deps,
    Tiling,
    StencilProgram,
    PROGRAMS,
    get_program,
    LayoutCandidate,
    ScoredLayout,
    LayoutDecision,
    autotune,
    CacheSchemaError,
    SCORE_MODES,
    # plans / bandwidth carried on CompiledStencil
    TransferPlan,
    BurstModel,
    PortedPlan,
    BandwidthReport,
    overlap_speedup,
    # facet storage metadata
    STORAGE_MODES,
    StorageMap,
    build_storage_map,
    BlockCodec,
    CODECS,
    get_codec,
    # the underlying pipeline (CompiledStencil.pipeline)
    CFAPipeline,
    # runtime telemetry (compile(trace=True), CompiledStencil.last_trace())
    TraceRecorder,
    Span,
    Counters,
    RuntimeReport,
    runtime_report,
    chrome_trace,
    validate_chrome_trace,
    # the staged lowering behind compile
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

__all__ = [
    "compile", "CompiledStencil",
    "Target", "TARGETS", "register_target", "get_target", "AXI_ZC706",
    "Executor", "ExecutorCaps", "EXECUTORS", "register_executor",
    "get_executor", "available_backends", "select_backend", "BackendError",
    "IterSpace", "Deps", "Tiling", "StencilProgram", "PROGRAMS", "get_program",
    "LayoutCandidate", "ScoredLayout", "LayoutDecision", "autotune",
    "CacheSchemaError", "SCORE_MODES",
    "TransferPlan", "BurstModel", "PortedPlan", "BandwidthReport",
    "overlap_speedup",
    "STORAGE_MODES", "StorageMap", "build_storage_map",
    "BlockCodec", "CODECS", "get_codec",
    "CFAPipeline",
    "TraceRecorder", "Span", "Counters", "RuntimeReport", "runtime_report",
    "chrome_trace", "validate_chrome_trace",
    "CompileState", "Pass", "PassPipeline", "PassTrace", "PipelineError",
    "DEFAULT_PASSES", "default_pipeline", "default_pass_fingerprint",
    "estimate_facet_bytes",
]
