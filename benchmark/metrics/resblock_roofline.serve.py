"""The fused ResBlock2 unit kernel's share of its roofline over the traced
batches: each batch's 30 units at its batch size and the padded frames,
at 3xTF32 on the tensor cores, over the kernel's device time."""
from wtvbench import roofline
from wtvbench.readers import FUSED, kernel_seconds, share


def read(view):
    v = view["config"]["vec2wav"]
    frames = view["shapes"]["max_frames"]
    bound = sum(roofline.fused_forward_bound_s(
        B, frames, v["upsample_initial_channel"], v["upsample_rates"],
        v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])
        for B in view["counters"]["batch_sizes"])
    return share(bound, kernel_seconds(view, FUSED))
