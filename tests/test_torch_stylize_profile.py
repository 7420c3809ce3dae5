"""The stylize profile script on the CPU at a tiny size: every disk-to-disk
run and every engine's call goes through, and no device number is reported
(a CPU run measures no card)."""
import json

from ccst_tpu_torch.benchmarks import stylize_profile


def test_profile_runs_every_cli_run_and_engine_on_the_cpu(capsys):
    assert stylize_profile.main(["--images-per-domain", "2", "--batch-size", "2", "--size", "32",
                                 "--profile-batch", "2", "--calls", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"]["device"] == "cpu"
    for name, _, _ in stylize_profile.CLI_RUNS:
        run = out["cli"][name]
        assert run["images_per_style"] == 2 and run["images_per_sec"] > 0
        assert run["style_decode_wait_seconds"] >= 0 and run["cli_wall_seconds"] > 0
    for engine in stylize_profile.PROFILE_ENGINES:
        prof = out["profile"][engine]
        assert prof["call_ms"] > 0
        assert prof["device_ms"] is None and prof["idle_share"] is None
