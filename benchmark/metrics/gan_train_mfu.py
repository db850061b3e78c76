"""The traced steps' operations (the reference's count of one GAN step at
the padded shapes) over the window, as a share of the configuration's peak."""
from wtvbench import flops
from wtvbench.readers import mfu_pct


def read(view):
    m = view["traffic"]
    step = flops.gan_step(view["config"]["vec2wav"], m["batch"], m["frame_pad"])
    return mfu_pct(view, step * view["counters"]["steps"])
