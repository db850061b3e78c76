"""Share of the traced window with no operation running on the device."""
from wtvbench.readers import idle_pct


def read(view):
    return idle_pct(view)
