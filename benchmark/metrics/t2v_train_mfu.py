"""The traced steps' operations (the reference's count of one training
step at the padded shapes, forward and backward) over the window, as a
share of the configuration's peak (f32 67, bf16 989 TFLOP/s)."""
from wtvbench import flops
from wtvbench.readers import mfu_pct


def read(view):
    m = view["traffic"]
    step = flops.t2v_step(view["config"]["text2vec"], m["batch"], m["text_pad"], m["frame_pad"])
    return mfu_pct(view, step * view["counters"]["steps"])
