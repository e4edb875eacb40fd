"""backend.host_us_per_op: host time inside the backend's submit_*, flush,
program_entries and the tickets' result() (the outermost call of each
nest), per op, over the ops before the profiler starts."""


def read(run):
    if run.backend_s is None or not run.span_ops:
        return None
    return run.backend_s / run.span_ops * 1e6
