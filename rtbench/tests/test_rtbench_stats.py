import statistics

import pytest

from rtbench import devtrace, stats


def test_percentile_is_nearest_rank_over_all_frames():
    vals = list(range(1, 201))          # 200 frames
    assert stats.percentile(vals, 95) == 190
    assert len([v for v in vals if v > stats.percentile(vals, 95)]) == 10
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_window_ms_is_the_whole_window_over_frames():
    assert stats.window_ms(10.0, 200) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.window_ms(1.0, 0)


def test_spread_uses_statistics_quartiles():
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_interval_union_counts_overlap_once():
    assert stats.interval_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.interval_union([(0, 10), (2, 3)]) == 10
    assert stats.interval_union([]) == 0


def test_gaps_are_what_no_interval_covers():
    assert stats.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [
        (0, 1), (3, 5), (6, 8)]
    assert stats.gaps([(0, 8)], 0, 8) == []


def test_op_labels_and_layers():
    k1 = "void (anonymous namespace)::bvh8_packet_kernel<24, true>(Args)"
    assert devtrace.op_label(k1) == "hrt_bvh8_trace:bvh8_packet_kernel<24, true>"
    assert devtrace.entry_of(devtrace.op_label(k1)) in devtrace.WALK_ENTRIES
    conv = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc"
    assert devtrace.is_conv(conv)
    assert not devtrace.is_conv("void at::native::vectorized_elementwise")
    assert not devtrace.is_conv(devtrace.op_label(k1))


def test_stretch_arithmetic_and_breakdown():
    ops = [devtrace.Op("hrt_skip_trace:skip_trace_kernel", 0.0, 0.004),
           devtrace.Op("elementwise", 0.003, 0.005),
           devtrace.Op("hrt_brdf_light_major:brdf_light_major_kernel",
                       0.007, 0.008)]
    st = devtrace.Stretch(ops, 2, 0.0, 0.010,
                          [("step", 0.0, 0.001), ("wait", 0.005, 0.007),
                           ("camera", 0.008, 0.0095)])
    assert st.busy_s() == pytest.approx(0.006)
    assert st.per_frame_ms(lambda lb: lb.startswith("hrt_skip")) == \
        pytest.approx(2.0)
    bd = devtrace.breakdown(st)
    assert bd["device_ops"][0][0] == "hrt_skip_trace:skip_trace_kernel"
    assert [g[0] for g in bd["idle_gaps"]] == ["wait", "camera"]
    assert bd["idle_gaps"][0][1] == pytest.approx(0.002)
