"""frontend.host_us_per_op: host time of the window outside the backend's
calls (the replay core and the harness's loop), per op, over the ops
before the profiler starts."""


def read(run):
    if run.host_layer != "frontend" or run.backend_s is None \
            or not run.span_ops:
        return None
    return (run.span_s - run.backend_s) / run.span_ops * 1e6
