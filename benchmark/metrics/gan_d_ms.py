"""Device ms a step under the span around the trainer's ``d_step``."""
from wtvbench.readers import span_ms_per


def read(view):
    return span_ms_per(view, "d_step", view["counters"]["steps"])
