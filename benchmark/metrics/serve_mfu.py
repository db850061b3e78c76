"""The traced window's operations (the reference's count for each batch's
Text2Vec inference and Generator at its batch and text bucket, padded to
the frame cap) over the window, as a share of the f32 peak."""
from wtvbench.readers import mfu_pct


def read(view):
    return mfu_pct(view, view["counters"]["flops"])
