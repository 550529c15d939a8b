"""The device trace's reduction on a hand-made Chrome trace: busy time as
the union of device intervals, a kernel's time given to the harness range
its launch lay in (by correlation id), idle gaps named by the host's range."""

import pytest

from devtrace import kernel_group, summarize


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize():
    events = [
        ev("user_annotation", "bench.step", 0, 100),
        ev("user_annotation", "bench.attn.fwd", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_driver", "cuLaunchKernel", 50, 1, corr=2),
        ev("kernel", "attention_fwd_mma", 100, 30, tid=7, corr=1),
        ev("kernel", "cudnn_conv", 120, 40, tid=7, corr=2),   # overlaps the first
        ev("gpu_memcpy", "Memcpy HtoD", 400, 10, tid=8),
        ev("user_annotation", "bench.input_wait", 150, 300),
    ]
    s = summarize(events, window_s=1e-3)
    assert s["busy_s"] == pytest.approx((160 - 100 + 10) / 1e6)
    assert s["range_s"] == {"bench.attn.fwd": pytest.approx(30e-6), "bench.step": pytest.approx(40e-6)}
    assert s["breakdown"]["idle_gaps"] == [["bench.input_wait", pytest.approx(240e-6)]]
    groups = dict(s["breakdown"]["device_ops"])
    assert groups["attention"] == pytest.approx(30e-6) and groups["memcpy"] == pytest.approx(10e-6)


def test_kernel_groups():
    assert kernel_group("void attention_wide::fwd_tc_kernel<8>") == "attention"
    assert kernel_group("sm90_xmma_gemm_bf16") == "conv and gemm"
    assert kernel_group("nvjet_tst_224x128_64x4_1x2_h_bz_coopA_NTN") == "conv and gemm"
    assert kernel_group("elementwise_kernel") == "other"
