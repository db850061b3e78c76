"""Device ms a step in the library's convolution kernels (cuDNN), by name."""
from wtvbench.readers import conv_seconds


def read(view):
    return 1e3 * conv_seconds(view) / view["counters"]["steps"]
