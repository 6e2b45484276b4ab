"""The LayerNorm readers (layernorm_ms.enhance, layernorm_ms.stream) on a
hand-made trace: ATen's and the program's LayerNorm kernels are summed over
the window and divided by its units; other operations are left out."""

import pytest

from perfbench import run
from perfbench.trace import WINDOW, Trace

OPS = [
    (10.0, 10.3, "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, "
                 "float>(int, float, float const*, float const*, float const*, float*, float*, "
                 "float*)"),
    (10.5, 10.6, "void (anonymous namespace)::layernorm_regs<float, 16, 1, 8>(float const*, "
                 "float const*, float const*, float*, long long, int, float)"),
    (11.0, 11.05, "void (anonymous namespace)::layernorm_span<float>(float const*)"),
    (11.2, 11.22, "void (anonymous namespace)::layernorm_long<__nv_bfloat16>(float const*)"),
    (12.0, 14.0, "void (anonymous namespace)::flash_rel_fwd<float, 16>(CUtensorMap)"),
    (14.0, 15.0, "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"),
    (15.0, 16.0, "void at::native::batch_norm_collect_statistics_kernel<float>()"),
    (9.0, 9.9, "void (anonymous namespace)::layernorm_regs<float, 16, 1, 8>()"),   # before
    (19.9, 20.5, "void at::native::vectorized_layer_norm_kernel<float, float>()"),  # cut
]
LN_S = 0.3 + 0.1 + 0.05 + 0.02 + 0.1


@pytest.mark.parametrize("metric", ["layernorm_ms.enhance", "layernorm_ms.stream"])
def test_sums_both_kernels_over_the_units(metric):
    r = run.Reading(cell=None, measured={"units": 4}, counters={},
                    trace=Trace(OPS, [(10.0, 20.0, WINDOW)]))
    assert run.reader(metric)(r) == pytest.approx(1e3 * LN_S / 4)


@pytest.mark.parametrize("metric", ["layernorm_ms.enhance", "layernorm_ms.stream"])
def test_none_untraced_without_units_or_without_a_layernorm(metric):
    read = run.reader(metric)
    assert read(run.Reading(None, {"units": 4}, {}, None)) is None
    assert read(run.Reading(None, {"units": 0}, {}, Trace(OPS, [(10.0, 20.0, WINDOW)]))) is None
    assert read(run.Reading(None, {"units": 4}, {}, Trace(OPS[4:7], [(10.0, 20.0, WINDOW)]))) \
        is None
