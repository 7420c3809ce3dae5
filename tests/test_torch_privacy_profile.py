"""The privacy-step profile script on the CPU at a tiny size: every case's
step goes through, and no device number is reported (a CPU run measures no
card)."""
import json

from ccst_tpu_torch.benchmarks import privacy_profile
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_profile_runs_on_the_cpu_without_device_numbers(capsys):
    assert privacy_profile.main(["--size", "32", "--steps", "1", "--runs", "1",
                                 "--warmup", "0", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"]["device"] == "cpu" and sorted(out["cases"]) == sorted(privacy_profile.CASES)
    for row in out["cases"].values():
        assert row["step_ms"] > 0 and row["device_ms_a_step"] is None
        assert row["family_ms"] is None and row["kernels"] == []


def test_kernel_families():
    assert privacy_profile.family(
        "void (anonymous namespace)::f32::reflect_conv3x3_f32_stage_kernel<128>(float const*)") == "K3"
    assert privacy_profile.family("reflect_conv3x3_wgmma_kernel<64>") == "K3"
    assert privacy_profile.family("cudnn::fprop_implicit_gemm") == "conv"
