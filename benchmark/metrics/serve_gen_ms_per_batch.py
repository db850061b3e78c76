"""Device ms a batch under the span around ``Synthesizer.latents_to_wav``."""
from wtvbench.readers import span_ms_per


def read(view):
    return span_ms_per(view, "latents_to_wav", view["spans"].get("latents_to_wav", {}).get("calls", 0))
