"""Device ms a step under the span around the trainer's ``forward``."""
from wtvbench.readers import span_ms_per


def read(view):
    return span_ms_per(view, "forward", view["counters"]["steps"])
