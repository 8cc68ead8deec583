"""The reduction of a ``torch.profiler`` trace (``pmgbench/trace.py``) on
synthetic events: per-card busy unions, the mean over the cell's cards,
the least busy card's idle gaps, and, on one card, the numbers that the
one-card reduction gave before it took several cards."""

import pytest

from pmgbench import trace


class Event:
    """The part of a profiler event that ``summarize`` reads."""

    def __init__(self, name, start, end, card=None, corr=0, linked=0,
                 thread=1):
        self._name, self._start, self._dur = name, start, end - start
        self._card, self._corr, self._linked = card, corr, linked
        self._thread = thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType.CPU" if self._card is None else "DeviceType.CUDA"

    def device_index(self):
        return -1 if self._card is None else self._card

    def activity_type(self):
        return "kernel" if self._card is not None else "cpu_op"

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._thread


class Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def host():
    """The window, the benchmark's spans, and one launch per kernel (its
    correlation id the kernel's), on the main thread."""
    return [Event("bench.window", 0, 1000),
            Event("bench.rhs", 10, 90),
            Event("cg.operator", 100, 300),
            Event("cudaLaunchKernel", 110, 120, corr=1),
            Event("cudaLaunchKernel", 130, 140, corr=2),
            Event("cg.preconditioner", 300, 700),
            Event("cudaLaunchKernel", 310, 320, corr=3),
            Event("cudaLaunchKernel", 330, 340, corr=4),
            Event("cudaStreamSynchronize", 700, 990)]


def card0():
    return [Event("laplace", 150, 250, card=0, corr=1),
            Event("laplace", 240, 300, card=0, corr=2),
            Event("cheb", 400, 650, card=0, corr=3),
            Event("cheb", 800, 1100, card=0, corr=4)]


def card1():
    return [Event("laplace", 160, 200, card=1, corr=1),
            Event("cheb", 420, 500, card=1, corr=3)]


def test_one_card_as_before():
    """The numbers that the one-card reduction of the parent commit gave
    for these events, pinned."""
    s = trace.summarize(Results(host() + card0()), cards=[0])
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(6e-7)
    assert s.busy_s_per_card == [pytest.approx(6e-7)]
    assert s.span_device_s == {"cg.operator": pytest.approx(1.6e-7),
                               "cg.preconditioner": pytest.approx(5.5e-7)}
    assert s.span_count == {"cg.operator": 1, "cg.preconditioner": 1}
    assert s.device_ops == [["cheb", pytest.approx(5.5e-7)],
                            ["laplace", pytest.approx(1.6e-7)]]
    assert s.idle_gaps == [["cg.preconditioner", pytest.approx(2.5e-7)],
                           ["(no host event)", pytest.approx(1.5e-7)]]


def test_two_cards_per_card_unions():
    s = trace.summarize(Results(host() + card0() + card1()), cards=[0, 1])
    # card 0: [150, 300] + [400, 650] + [800, 1000]; card 1: 40 + 80 ns
    assert s.busy_s_per_card == [pytest.approx(6e-7), pytest.approx(1.2e-7)]
    assert s.busy_s == pytest.approx(3.6e-7)
    # device time by kernel name and by span sums over the cards
    assert s.device_ops == [["cheb", pytest.approx(6.3e-7)],
                            ["laplace", pytest.approx(2e-7)]]
    assert s.span_device_s == {"cg.operator": pytest.approx(2e-7),
                               "cg.preconditioner": pytest.approx(6.3e-7)}
    # the idle gaps are the least busy card's (card 1), named by the host
    assert s.idle_gaps == [["cg.preconditioner", pytest.approx(5e-7)],
                           ["cg.operator", pytest.approx(2.2e-7)],
                           ["(no host event)", pytest.approx(1.6e-7)]]
    # a card outside the cell's is not counted
    one = trace.summarize(Results(host() + card0() + card1()), cards=[0])
    assert one.busy_s_per_card == [pytest.approx(6e-7)]


def test_an_idle_card_counts():
    """A card of the cell with no device work in the window is busy 0 and
    its gaps are the whole window."""
    s = trace.summarize(Results(host() + card0()), cards=[0, 1])
    assert s.busy_s_per_card == [pytest.approx(6e-7), 0.0]
    assert s.busy_s == pytest.approx(3e-7)
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(1e-6)


def test_no_card():
    """A run on the CPU: no device work, nothing busy, no gaps."""
    s = trace.summarize(Results(host()), cards=[])
    assert s.busy_s == 0 and s.busy_s_per_card == []
    assert s.idle_gaps == [] and s.device_ops == []
