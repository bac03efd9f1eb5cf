"""Kernel B2J's launch plan (ops/transit_tangent_kernels.py `launch_plan`),
on the CPU: the plan and the shared memory it asks for are plain Python
(the kernel itself runs only on the card; tests/test_torch_gpu.py holds it
to its plain version there). No JAX."""

import heapq

import pytest

from bcm3_tpu_torch.ops import transit_tangent_kernels as b2j

SMS = 132  # an H100's SMs

# blocks an SM for a range of register and shared-memory budgets
RESIDENT = (1, 2, 3, 5, 10)
WIDTHS = (1, 7, 8, 31, 33, 100, 1000, 1024, 1056, 2112, 2113, 4000, 4224, 4225, 32768,
          524288)


def _hand_out(plan, L, trips):
    """The kernel's lanes by producer thread: blocks x lanes_per_warp
    threads start together, and a thread whose lane ends (after that
    lane's trips) takes the next from the counter, as the kernel's
    atomicAdd does; ties go to the lower thread. Returns each thread's
    lanes."""
    threads = plan["blocks"] * plan["lanes_per_warp"]
    lanes = [[] for _ in range(threads)]
    free = [(0, i) for i in range(threads)]  # (time the thread is free, thread)
    for lane in range(L):
        when, i = heapq.heappop(free)
        lanes[i].append(lane)
        heapq.heappush(free, (when + trips(lane), i))
    return lanes


@pytest.mark.parametrize("n", [2, 3])
def test_every_lane_once_and_blocks_resident(n):
    for per_sm in RESIDENT:
        for L in WIDTHS:
            plan = b2j.launch_plan(L, n, SMS, per_sm)
            assert plan["lanes_per_warp"] in b2j.LANES_PER_WARP
            assert 1 <= plan["blocks"] <= per_sm * SMS
            assert plan["consumer_warps"] == (5 if n == 2 else 7)  # a warp a direction
            assert plan["threads"] == 32 * (1 + plan["consumer_warps"])
            assert 1 <= plan["slots"] <= 7
            if L <= 20_000:
                # trips 98-768, as at prior draws
                lanes = _hand_out(plan, L, lambda lane: 98 + (lane * 7919) % 671)
                got = sorted(x for thread in lanes for x in thread)
                assert got == list(range(L))


@pytest.mark.parametrize("n", [2, 3])
def test_small_widths_spread_over_the_card(n):
    """At L <= 1,024 (the HMC and VI widths) the plan takes at least
    min(SMs, ceil(L / 8)) blocks, where the first design took L / 128."""
    for per_sm in RESIDENT:
        for L in (1, 8, 9, 64, 500, 1000, 1024):
            plan = b2j.launch_plan(L, n, SMS, per_sm)
            assert plan["blocks"] >= min(SMS, -(-L // 8))
    # the widths of the check and the NUTS width on one H100
    assert b2j.launch_plan(1024, n, SMS, 3)["lanes_per_warp"] == 8
    assert b2j.launch_plan(1024, n, SMS, 3)["blocks"] == 128
    assert b2j.launch_plan(4000, n, SMS, 3)["lanes_per_warp"] == 16
    assert b2j.launch_plan(32768, n, SMS, 3)["lanes_per_warp"] == 32
    assert b2j.launch_plan(32768, n, SMS, 3)["blocks"] == 3 * SMS


def _largest(fits):
    """The largest k >= 1 with fits(k), fits being monotone."""
    lo, hi = 1, 1
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [2, 3])
def test_shared_memory_fits(n, itemsize):
    """The stop tables and the ring within the 227 KB a block may use, at
    bench.py's 16 patients x 38 stops and at the largest tables the
    wrapper accepts (its check is shared_bytes <= SHARED_LIMIT), however
    they are shaped; the ring leaves room for thousands of stops."""
    assert b2j.SHARED_LIMIT == 232_448
    assert b2j.shared_bytes(n, itemsize, 16, 38) <= 64 * 1024

    def accepted(P, S):
        return b2j.shared_bytes(n, itemsize, P, S) <= b2j.SHARED_LIMIT

    for P, S in ((16, _largest(lambda S: accepted(16, S))), (_largest(lambda P: accepted(P, 1)), 1),
                 (1, _largest(lambda S: accepted(1, S)))):
        assert accepted(P, S) and P * S >= 6000
        assert not accepted(P, S + 1)
    # a slot is 32 lanes of whole fields (the kernel's Record<N>)
    assert b2j.record_bytes(n, itemsize) % (32 * 4) == 0


def test_the_bound_counts_the_algorithm():
    """The bound's operations are the algorithm's, whatever runs them."""
    assert b2j.OPS_PER_TRIP == {2: 2430, 3: 4446}
    assert b2j.OPS_LANE_SETUP == 25
