"""The serving tier of the port: LM decode, hybrid RAG retrieval, the
dynamic batch scheduler, effort bucketing, and the resilience layer
(admission control, deadlines, graceful degradation, seeded fault
injection)."""
from .decode import build_serve_step, generate, prefill
from .faults import (CRASH_SITES, FaultInjector, FaultSpec,
                     InjectedCrashError, InjectedKernelError)
from .rag import RAG_SQL, HybridRetriever
from .resilience import (AdmissionConfig, AdmissionController,
                         BackpressureError, DeadlineExceededError,
                         DegradePolicy, DeltaFullError, DuplicateIdError,
                         InvalidVectorError, LoadController, MutationError,
                         PoisonedBindError, ServingError, UnknownIdError,
                         validate_binds, validate_delete, validate_insert)
from .scheduler import (BatchScheduler, ResilientScheduler, SchedulerConfig,
                        SimRecord, latency_stats, run_effort_bucketed)

__all__ = ["build_serve_step", "generate", "prefill", "RAG_SQL",
           "HybridRetriever", "BatchScheduler", "ResilientScheduler", "SchedulerConfig",
           "SimRecord", "latency_stats", "run_effort_bucketed",
           "CRASH_SITES", "FaultInjector", "FaultSpec", "InjectedCrashError",
           "InjectedKernelError", "AdmissionConfig", "AdmissionController",
           "BackpressureError", "DeadlineExceededError", "DegradePolicy",
           "LoadController", "PoisonedBindError", "ServingError",
           "validate_binds", "MutationError", "UnknownIdError",
           "DuplicateIdError", "InvalidVectorError", "DeltaFullError",
           "validate_insert", "validate_delete"]
