"""The training-step profile script on the CPU at a tiny size: the train and
eval steps go through, and no device number is reported (a CPU run measures
no card)."""
import json

from ccst_tpu_torch.benchmarks import fed_profile


def test_profile_runs_on_the_cpu_without_device_numbers(capsys):
    assert fed_profile.main(["--network", "resnet4", "--batch", "2", "--size", "32",
                             "--steps", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"]["device"] == "cpu"
    assert out["step_ms"] > 0 and out["eval_ms"] > 0
    assert out["device_ms_a_step"] is None and out["idle_share"] is None
    assert out["family_ms"] is None and out["kernels"] == []


def test_kernel_families():
    assert fed_profile.family("cudnn::fprop_implicit_gemm") == "conv"
    assert fed_profile.family("void at::native::batch_norm_collect_statistics_kernel") == \
        "batch_norm"
    assert fed_profile.family("void at::native::vectorized_elementwise_kernel<4>") == \
        "elementwise / reduce"
    assert fed_profile.family("cudnn::bn_fw_tr_1C11_kernel_NCHW") == "batch_norm"
    assert fed_profile.family("something_new") == "other"
