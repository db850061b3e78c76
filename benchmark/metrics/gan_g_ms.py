"""Device ms a step under the spans around ``GANTrainer.generate`` and
``GANTrainer.g_step``."""
from wtvbench.readers import span_ms_per


def read(view):
    parts = [span_ms_per(view, s, view["counters"]["steps"]) for s in ("generate", "g_step")]
    return None if None in parts else sum(parts)
