"""The reduction of a profile's raw events: busy time, idle gaps named by
the host, kernels linked to block ranges by their launch; with and
without the activity types newer torch gives its events."""

import pytest

from benchmark.harness import trace as T


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, kind=None):
        self._n, self._d, self._s, self._t = name, dev, start, dur
        self._c, self._k = corr, kind

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def correlation_id(self):
        return self._c


class Typed(Ev):
    def activity_type(self):
        return self._k


def events(cls):
    return [cls("bench::resblock", False, 0, 100, kind="user_annotation"),
            cls("cudaLaunchKernel", False, 10, 2, 7, "cuda_runtime"),
            cls("aten::mul", False, 40, 20, kind="cpu_op"),
            cls("conv_kernel", True, 20, 30, 7, "kernel"),
            cls("bench::resblock", True, 5, 90, kind="gpu_user_annotation"),
            cls("cudaLaunchKernel", False, 150, 2, 8, "cuda_runtime"),
            cls("gemm", True, 160, 10, 8, "kernel")]


@pytest.mark.parametrize("cls", [Ev, Typed])
def test_reduce_events(cls):
    out = T.reduce_events(events(cls), wall_ns=200)
    assert out["busy_s"] == pytest.approx(40e-9)
    assert out["window_s"] == pytest.approx(200e-9)
    assert [n for n, _ in out["device_ops"]] == ["conv_kernel", "gemm"]
    assert out["block_device_s"] == {"resblock": pytest.approx(30e-9)}
    assert out["idle_gaps"] == [["aten::mul", pytest.approx(110e-9)]]
    assert out["linked_kernels"] == 1


def test_idle_share_sets_busy_against_the_untraced_window():
    from benchmark.harness import core
    from benchmark.metrics import idle_share

    run = core.Run(window_s=40.0, units=8,
                   trace={"busy_s": 4.0, "window_s": 9.0, "units": 1,
                          "device_events": 3})
    assert idle_share.read(run) == pytest.approx(20.0)   # 1 - 4 / (40 / 8)
    run.units = 0
    assert idle_share.read(run) is None
