"""The device's busy time in ``profile_serving``: the union of the device
spans of a trace, so that spans which overlap (the DeiT token tail's second
pass is a dependent launch that starts under the first) count once."""

from types import SimpleNamespace

import pytest
import torch

from mrla_tpu_torch.profile_serving import device_busy_ms, span_union


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 5.0)], 5.0),
    ([(0.0, 5.0), (5.0, 7.0)], 7.0),           # touching
    ([(0.0, 5.0), (3.0, 8.0)], 8.0),           # overlapping
    ([(3.0, 8.0), (0.0, 5.0)], 8.0),           # out of order
    ([(0.0, 10.0), (2.0, 4.0)], 10.0),         # one inside another
    ([(0.0, 2.0), (4.0, 6.0), (5.0, 9.0)], 7.0),  # a gap, then an overlap
])
def test_span_union(spans, want):
    assert span_union(spans) == want


def _event(start, end, device=True, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=kind, is_user_annotation=annotation)


def test_device_busy_counts_overlapping_kernels_once():
    # pass 1 20.6 us and pass 2 50.8 us that starts 15 us into pass 1, a
    # copy after a gap; host events and a user annotation spanning all of
    # them are left out
    prof = SimpleNamespace(events=lambda: [
        _event(100.0, 120.6), _event(105.6, 156.4), _event(200.0, 210.0),
        _event(0.0, 500.0, device=False),
        _event(90.0, 300.0, annotation=True)])
    assert device_busy_ms(prof) == pytest.approx((156.4 - 100.0 + 10.0) / 1e3)
    kernel_sum = 20.6 + 50.8 + 10.0
    assert device_busy_ms(prof) < kernel_sum / 1e3
