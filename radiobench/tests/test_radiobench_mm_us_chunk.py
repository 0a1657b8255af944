"""mm_us_chunk reads the M&M kernel's events of a traced window, and
nothing where the program has no such kernel."""

from radiobench.metrics import mm_us_chunk

MIX = {"request_samples": 17280, "chunk": 4320}


class Trace:
    def __init__(self, device, requests=2):
        self.device, self.requests = device, requests


def ctx(device, launches):
    return {"trace": Trace(device), "launches": launches, "mix": MIX}


EVENTS = [(0, 40_000, "void (anonymous namespace)::mm_kernel<1>(float const*, long long)"),
          (0, 1_000, "void fir_decim_mma_kernel<2, float, 8, 0>(float const*)"),
          (5, 44_005, "mm_kernel<2>")]


def test_reads_the_kernels_events_a_chunk():
    # 2 requests of 4 chunks, 2 launches: (40 + 44) us over 8 chunks
    assert mm_us_chunk.read(ctx(EVENTS, {"mm_fwd": 2})) == 84.0 / 8


def test_a_lost_event_reads_the_others_mean():
    assert mm_us_chunk.read(ctx(EVENTS, {"mm_fwd": 3})) == 42.0 * 3 / 8


def test_none_without_the_kernel():
    assert mm_us_chunk.read(ctx(EVENTS, {"iir1_fwd": 4})) is None
    assert mm_us_chunk.read(ctx(EVENTS[1:2], {"mm_fwd": 2})) is None
    assert mm_us_chunk.read({"trace": None, "launches": {"mm_fwd": 2},
                             "mix": MIX}) is None
