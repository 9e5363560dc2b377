"""The reduction of profiler events: window less the pauses, the union of
device operations, the entry's launches by correlation, idle time by the
benchmark span the host was in."""

import pytest

from gpubench import trace


class Ev:
    def __init__(self, name, start, dur, device=False, corr=0):
        self._n, self._s, self._d, self._dev, self._c = (name, start, dur,
                                                         device, corr)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._c


def test_summarize():
    entry = "gpubench.entry.f"
    events = [
        Ev(trace.WINDOW, 0, 1000), Ev(trace.WINDOW, 0, 1000, device=True),
        Ev(trace.PAUSE, 500, 100), Ev(trace.SPAN + "collect q1", 0, 450),
        Ev("cudaLaunchKernel", 90, 5, corr=1), Ev("k1", 100, 200, True, 1),
        Ev("Memcpy DtoH", 510, 80, True, 2),           # inside the pause
        Ev(entry, 650, 40), Ev("cuLaunchKernel", 660, 5, corr=3),
        Ev("k2", 700, 100, True, 3),
    ]
    s = trace.summarize(events, [entry, "gpubench.entry.g"])
    assert s.window_s == pytest.approx(900e-9)
    assert s.busy_s == pytest.approx(300e-9)
    # an entry never called has no reading
    assert s.entries == {entry: (pytest.approx(100e-9), 1)}
    assert s.device_ops == [("k1", pytest.approx(200e-9)),
                            ("k2", pytest.approx(100e-9))]
    assert dict(s.idle_gaps) == {"collect q1": pytest.approx(300e-9),
                                 "harness": pytest.approx(300e-9)}


def test_no_window_is_an_error():
    with pytest.raises(RuntimeError):
        trace.summarize([Ev("k", 0, 1, True)], ["gpubench.entry.f"])
