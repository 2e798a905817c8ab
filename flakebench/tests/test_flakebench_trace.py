"""The reduction of a profiler trace: busy time as the union of device
intervals, events counted, idle gaps named by the host's innermost
event."""

import pytest

from flakebench import trace


def test_union_and_gaps():
    device = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (45, 50, "c")]
    cpu = [(-5, 60, "flakebench.wait"), (18, 35, "cudaEventSynchronize"),
           (41, 47, "aten::where"), (42, 43, "cudaLaunchKernel")]
    red = trace.reduce_events(device, cpu)
    assert red["busy_s"] == pytest.approx(35e-6)
    assert red["device_events"] == 4
    assert red["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert dict(red["idle_gaps"]) == pytest.approx(
        {"cudaEventSynchronize": 10e-6, "flakebench.wait": 5e-6})


def test_gap_with_no_host_event():
    red = trace.reduce_events([(0, 1, "k"), (3, 4, "k")], [])
    assert red["idle_gaps"] == [["no host event", pytest.approx(2e-6)]]


def test_long_kernel_names_keep_their_operator():
    name = ("void at::native::elementwise_kernel<128, 2, at::native::"
            "gpu_kernel_impl_nocast<at::native::(anonymous namespace)::"
            "where_kernel_impl(at::TensorIterator&)::{lambda()#1}>(int, "
            "at::native::gpu_kernel_impl_nocast<...>)" + " " * 100)
    assert trace.short(name) == "at::native::elementwise_kernel " \
        "[where_kernel_impl]"
    assert trace.short("granule_kernel<true>") == "granule_kernel<true>"
    kernel = ("void (anonymous namespace)::final_pass_kernel<256>(int const*, "
              "int const*, int const*, int const*, int*, unsigned char*, long "
              "long*, int*, int*, int*, long long*, int, int, int, int)")
    assert trace.short(kernel) == "final_pass_kernel<256>"
