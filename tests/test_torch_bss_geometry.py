"""The launch geometry of ``bss_advance`` (``bss_cuda.launch_geometry``),
held on the CPU for every node count the kernel takes and every point
count up to ``BSS_MAX_POINTS``: one warp per (point, replica) row, node
``i`` on lane ``i % 32``, slot ``i // 32``, the slots in registers up to
``BSS_REG_SLOTS``, each row's slice of shared memory and the opt-in past
48 KB.  ``bss_advance_launch`` refuses a launch whose geometry differs
from its own, so these are the shapes the card runs."""

import numpy as np
import pytest

from tpudes_torch.parallel.bss_cuda import (
    BSS_MAX_N,
    BSS_MAX_POINTS,
    BSS_PROF_SLOTS,
    BSS_REG_SLOTS,
    BSS_ROWS_PER_BLOCK,
    SHARED_DEFAULT_MAX,
    SHARED_OPTIN_MAX,
    launch_geometry,
    node_lane_slot,
    row_point_replica,
)


@pytest.mark.parametrize("mobile", [False, True])
def test_slots_and_shared_memory_for_every_node_count(mobile):
    for n in range(1, BSS_MAX_N + 1):
        g = launch_geometry(n, 1, 4, mobile)
        assert 32 * (g["slots"] - 1) < n <= 32 * g["slots"] <= BSS_MAX_N
        assert g["template_slots"] == (g["slots"] if g["slots"]
                                       <= BSS_REG_SLOTS else 0)
        floats = (5 if mobile else 2) * n
        assert g["row_bytes"] % 16 == 0
        assert 4 * floats + n <= g["row_bytes"] < 4 * floats + n + 16
        assert g["shared"] == BSS_ROWS_PER_BLOCK * g["row_bytes"]
        assert g["shared"] <= SHARED_OPTIN_MAX
        assert g["optin"] == (g["shared"] > SHARED_DEFAULT_MAX)
        assert g["threads"] == 32 * BSS_ROWS_PER_BLOCK
    # the static arms never need the opt-in; a mobile row of many nodes
    # does
    assert launch_geometry(BSS_MAX_N, 1, 1, mobile)["optin"] == mobile
    # the bench (N = 65) is the probe's slot count
    assert launch_geometry(65, 1, 512, mobile)["slots"] == BSS_PROF_SLOTS


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 64, 65, 97, 128, 129,
                               500, 1023, 1024])
def test_every_node_maps_to_one_lane_and_slot(n):
    lane, slot = node_lane_slot(n)
    g = launch_geometry(n, 1, 1, False)
    assert lane.min() >= 0 and lane.max() < 32
    assert slot.min() >= 0 and slot.max() < g["slots"]
    pairs = set(zip(lane.tolist(), slot.tolist()))
    assert len(pairs) == n
    # slot s holds nodes 32 s .. 32 s + 31: the ballot word s, bit lane
    assert np.array_equal(32 * slot + lane, np.arange(n))


@pytest.mark.parametrize("replicas", [1, 3, 4, 5, 512])
def test_rows_cover_every_point_and_replica_once(replicas):
    for points in range(1, BSS_MAX_POINTS + 1):
        g = launch_geometry(65, points, replicas, False)
        assert g["rows"] == points * replicas
        assert (g["blocks"] - 1) * BSS_ROWS_PER_BLOCK < g["rows"]
        assert g["rows"] <= g["blocks"] * BSS_ROWS_PER_BLOCK
        if points * replicas > 4096:
            continue
        seen = set()
        for b in range(g["blocks"]):
            for w in range(BSS_ROWS_PER_BLOCK):
                if b * BSS_ROWS_PER_BLOCK + w >= g["rows"]:
                    continue            # a ragged last block's idle warp
                p, r = row_point_replica(b, w, replicas)
                assert 0 <= p < points and 0 <= r < replicas
                seen.add((p, r))
        assert len(seen) == points * replicas


def test_ragged_last_block():
    g = launch_geometry(65, 3, 5, False)      # 15 rows
    assert g["blocks"] == 4
    assert g["rows"] % BSS_ROWS_PER_BLOCK != 0
