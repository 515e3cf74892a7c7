"""executor.self_host_ms: per request, the self host milliseconds of the
program's span ``repro_torch.executor`` (``BucketedExecutor.run_padded``, or
a single dict's plan): padding, the valid lane, the uploads and the plan's
glue, less the predicate, kernel-launch and stage-2 spans inside it."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.host_ms(ctx, "repro_torch.executor", "self_s")
