"""The yardstick's arithmetic against the kernel table of PERF.md (bounds at
262,144 points on the H100's data-sheet peaks)."""

import pytest

from portbench import flops
from portbench.reference import nets as N


@pytest.mark.parametrize("width,k1_ms,k2_ms", [(512, 0.973, 5.837), (256, 0.243, 1.459)])
def test_bounds_match_the_kernel_table(width, k1_ms, k2_ms):
    net = N.SDFNet({"multires": 6, "skip_in": [4], "use_last_as_f": width == 512,
                    "dims": [width] * 8}, width)
    assert flops.k1_bf16_bound_s(262144, net.shapes) * 1e3 == pytest.approx(k1_ms, abs=5e-4)
    assert flops.k2_bound_s(262144, net.shapes) * 1e3 == pytest.approx(k2_ms, abs=5e-4)


def test_rows_wrapper_counts_only_device_launches():
    import types

    import torch

    calls = []
    fm = types.SimpleNamespace(
        fused_sdf_value=lambda x, fw: calls.append("v"), fused_hidden=lambda x, fw: None,
        fused_fwd_bwd=lambda x, fw: calls.append("k2"))
    fw = types.SimpleNamespace(dtype=torch.bfloat16)
    with flops.KernelRows(fm) as rows:
        fm.fused_sdf_value(torch.zeros(5, 3), fw)  # a CPU tensor: no launch
    assert calls == ["v"] and rows.calls == []
    assert fm.fused_sdf_value is not None and rows._orig == {}
