"""The flash kernels' share of their roofline over their device time: each
step's forward, dK/dV and dQ calls of both FFT stacks."""
from wtvbench import roofline
from wtvbench.readers import FLASH, kernel_seconds, share


def read(view):
    t, m = view["config"]["text2vec"], view["traffic"]
    if not t.get("flash_attention"):
        return None
    H = t["encoder_head"]
    D = (t["encoder_dim"] + t["n_speaker_dim"]) // H
    per_step = roofline.flash_step_bound_s(
        m["batch"], H, D, [(m["text_pad"], t["encoder_n_layer"]),
                           (m["frame_pad"], t["decoder_n_layer"])],
        t.get("compute_dtype") == "bfloat16")
    return share(view["counters"]["steps"] * per_step, kernel_seconds(view, FLASH))
