"""Device ms a step under the span around the trainer's ``backward``."""
from wtvbench.readers import span_ms_per


def read(view):
    return span_ms_per(view, "backward", view["counters"]["steps"])
