"""Device ms a batch under the span around ``Synthesizer.text_to_latents``."""
from wtvbench.readers import span_ms_per


def read(view):
    return span_ms_per(view, "text_to_latents", view["spans"].get("text_to_latents", {}).get("calls", 0))
