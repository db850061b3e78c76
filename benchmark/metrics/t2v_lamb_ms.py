"""Device ms a step under the span around the trainer's ``apply_gradients``."""
from wtvbench.readers import span_ms_per


def read(view):
    return span_ms_per(view, "apply_gradients", view["counters"]["steps"])
