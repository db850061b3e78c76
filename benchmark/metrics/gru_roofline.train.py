"""The f32 BiGRU forward and backward-loop kernels' share of their roofline
(operations at 67 TFLOP/s, or bytes) over their device time."""
from wtvbench import roofline
from wtvbench.readers import GRU, kernel_seconds, share


def read(view):
    m = view["traffic"]
    H = view["config"]["text2vec"]["n_feat_dim"]
    bound = view["counters"]["steps"] * roofline.gru_step_bound_s(m["batch"], m["frame_pad"], H)
    return share(bound, kernel_seconds(view, GRU))
