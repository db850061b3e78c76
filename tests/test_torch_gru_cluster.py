"""The BiGRU backward kernel's pairs (``ops/gru.py``): the persistent route
runs in thread-block clusters of two, each block multiplying half of
dgh_{t+1}'s columns for both blocks' units.  Here: the plan's routes and
cluster size at an H100's limits, the pairing rule, and the wrapper refusing
a grid whose pairs the card cannot hold at once, with nothing falling back
to the plain loop or the steps route.  The f32 forward keeps its
cooperative, unclustered launch.

No kernel runs here: the kernel itself is held to its plain version on the
card by ``chip_smoke.py`` phase 10.
"""

import pytest
import torch

from wavthruvec_pytorch_tpu_torch.ops import gru, kernel_build

H100_SMS, H100_SMEM = 132, 232448
# clusters of C blocks an H100 80GB HBM3 holds at once at one block an SM
# (cudaOccupancyMaxActiveClusters, as chip_smoke.py phase 10 prints them)
H100_CLUSTERS = {4: 30, 2: 66}


# --- the plans at an H100's limits -------------------------------------------

@pytest.mark.parametrize("B", [1, 2, 16, 40, 64])
def test_bwd_plan_in_pairs_at_h100(B):
    """At D = 2, H = 1024 on an H100 the backward runs persistent in pairs
    at every batch its route took before (up to four passes of 16 rows, B =
    64): 16 units a block, 128 blocks, 64 pairs."""
    plan = gru.gru_bwd_plan(2, B, 1024, H100_SMS, H100_SMEM, H100_CLUSTERS)
    assert plan == gru.GRUPlan("persistent", 128, 16, gru.persistent_bwd_smem(16, 1024), 2)


@pytest.mark.parametrize("B", [1, 2, 16, 40, 64])
def test_f32_forward_plan_unclustered(B):
    """The f32 forward keeps its one cooperative launch without clusters
    where it is persistent (to B = 40 at H = 1024), and the steps route past
    it, whatever the card's cluster occupancy."""
    plan = gru.gru_fwd_plan(2, B, 1024, H100_SMS, H100_SMEM, "f32")
    assert plan.cluster == 1
    assert plan.route == ("persistent" if B <= 40 else "steps")


@pytest.mark.parametrize("clusters, want", [
    ({4: 30, 2: 66}, 2),
    ({4: 32, 2: 64}, 2),   # exactly 64 pairs: enough
    ({4: 32, 2: 63}, 0),   # one pair short: the wrapper refuses
    ({}, 0),
    (None, 0),             # not asked
])
def test_pairs_must_all_be_resident(clusters, want):
    """The plan takes pairs where the card holds all 64 of them at once
    (clusters[2] * 2 >= 128 blocks), else cluster 0."""
    assert gru.cluster_size(128, clusters) == want
    assert gru.gru_bwd_plan(2, 16, 1024, H100_SMS, H100_SMEM, clusters).cluster == want


@pytest.mark.parametrize("H, U, per_direction", [
    (1024, 16, 64), (40, 8, 6), (48, 8, 6), (8, 8, 2), (24, 8, 4)])
def test_direction_blocks_round_up_to_pairs(H, U, per_direction):
    """A pair never spans two directions: a direction's ceil(H / U) blocks
    are rounded up to whole pairs (H = 40 at U = 8: five blocks of units and
    a sixth past H; H = 8, the orbax fixtures' BiGRU, a block and its
    partner), and the plan takes that grid in pairs."""
    assert gru.pair_blocks(U, H) == per_direction
    plan = gru.gru_bwd_plan(2, 4, H, H100_SMS, H100_SMEM, {2: 100, 4: 100})
    assert (plan.route, plan.units, plan.blocks, plan.cluster) == \
        ("persistent", U, 2 * per_direction, 2)


def test_bwd_steps_route_unclustered():
    """The backward's steps route (B = 65: five passes) launches without
    clusters."""
    assert gru.gru_bwd_plan(2, 65, 1024, H100_SMS, H100_SMEM, H100_CLUSTERS) == \
        gru.GRUPlan("steps", 256, 8, 0, 1)


# --- pairs not resident: the wrapper raises -----------------------------------

def _card(monkeypatch, clusters):
    """Meta tensors stand in for CUDA ones past the device check; the card's
    limits and its cluster occupancy are patched; loading a library, the
    plain loop and the steps route fail the test if reached."""
    def never(name):
        def fail(*a, **k):
            raise AssertionError(f"{name} was reached")
        return fail

    asked = []

    def occupancy(D, B, H, plan, device):
        asked.append((D, B, H, plan.units, plan.smem))
        return clusters

    monkeypatch.setattr(gru, "_checked_bwd_shape", lambda dys, *a: tuple(dys.shape))
    monkeypatch.setattr(gru, "device_limits", lambda device: (H100_SMS, H100_SMEM))
    monkeypatch.setattr(gru, "max_clusters", occupancy)
    monkeypatch.setattr(kernel_build, "load", never("a kernel library"))
    for name in ("gru_bwd_loop_plain", "gru_bwd_steps"):
        monkeypatch.setattr(gru, name, never(name))
    return asked


def _args():
    shapes = ((2, 16, 8, 1024), (2, 16, 8, 3072), (2, 16, 8, 3072), (2, 16, 8, 1024),
              (2, 1024, 3072))
    return tuple(torch.empty(s, device="meta") for s in shapes)


def _counters():
    return (gru.gru_bwd_loop.launches, gru.gru_bwd_loop.step_launches,
            gru.gru_bwd_loop.time_steps)


@pytest.mark.parametrize("clusters", [{4: 30, 2: 63}, {4: 0, 2: 0}])
def test_backward_refuses_unresident_pairs(monkeypatch, clusters):
    """gru_bwd_loop, and gru_bwd (the autograd backward's) through it, raise
    before loading the library on a card that cannot hold all 64 pairs at
    once: no plain loop, no steps route, no launch counted."""
    asked = _card(monkeypatch, clusters)
    args = _args()
    before = _counters()
    with pytest.raises(RuntimeError, match="cannot hold all 128 blocks"):
        gru.gru_bwd_loop(*args)
    with pytest.raises(RuntimeError, match="cannot hold all 128 blocks"):
        gru.gru_bwd(args[0], args[1], args[3], args[4], torch.empty(2, 3072, device="meta"))
    assert asked == [(2, 16, 1024, 16, gru.persistent_bwd_smem(16, 1024))] * 2
    assert _counters() == before


def test_resident_pairs_reach_the_launch(monkeypatch):
    """With the pairs resident the same call gets past the check and goes on
    to load the kernel library (which fails here): the refusal is the
    pairs', not the shape's."""
    _card(monkeypatch, H100_CLUSTERS)
    with pytest.raises(AssertionError, match="a kernel library was reached"):
        gru.gru_bwd_loop(*_args())
