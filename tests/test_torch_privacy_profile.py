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


def test_frozen_pass_routes_compute_the_same_passes():
    """The three timed forms of the trainers' grad-free passes agree: K3's
    route (its plain version on the CPU), cuDNN's and the plain one; the
    float32 taps within 1e-4 of their largest value, the bf16 style features
    within 2e-2 (bf16's 8 bits, rounded at every layer in another order)."""
    import torch

    passes = privacy_profile.frozen_passes(torch.device("cpu"), 32)
    for case, routes in passes.items():
        with torch.no_grad():
            out = {route: fn() for route, fn in routes.items()}
        for route in ("cudnn", "plain"):
            for got, want in zip(out[route], out["k3"]):
                pairs = ([(got[k], want[k]) for k in want] if isinstance(want, dict)
                         else [(got, want)])
                for g, w in pairs:
                    tol = 2e-2 if w.dtype == torch.bfloat16 else 1e-4
                    scale = float(w.float().abs().max())
                    assert float((g.float() - w.float()).abs().max()) <= tol * scale, (case, route)
