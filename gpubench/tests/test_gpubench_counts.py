"""The yardstick's counts against hand counts."""
from collections import Counter

import pytest

from gpubench.flops import BF16_PEAK_FLOPS, HBM_BYTES_S, bound_s, resnet, vgg


def test_vgg19_relu4_1_at_512_px_is_126_53_gflop_a_pass():
    # 512^2 * 9 * (3*64 + 64*64) + 256^2 * 9 * (64*128 + 128^2)
    # + 128^2 * 9 * (128*256 + 3 * 256^2) + 64^2 * 9 * 256*512 = 63,266,881,536 MAC
    assert vgg.pass_flops(vgg.ENCODER, 512) == 2 * 63_266_881_536
    assert vgg.pass_flops(vgg.DECODER, 512) == vgg.pass_flops(vgg.ENCODER, 512)


def test_a_stylized_image_in_overall_mode_is_one_third_encode_and_one_decode():
    job = vgg.Job(512, 32, 3, False)
    assert job.images == 96
    assert vgg.model_flops(job) / job.images == pytest.approx(126.533763072e9 * (1 / 3 + 1))


def test_single_mode_counts_the_style_image_encode():
    job = vgg.Job(512, 32, 3, True)
    enc = vgg.pass_flops(vgg.ENCODER, 512)
    assert job.images == 32
    assert vgg.model_flops(job) == 32 * 2 * enc + enc


def launches(engine, job):
    return dict(Counter(k for k, _, _ in vgg.launches(engine, job)))


def test_launches_are_the_engines_own():
    # chip_smoke.py's exact counts: ref 9 + 9 S K3; int8-fused 7 + 7 S K0, 1 K1, S K2
    assert launches("ref", vgg.Job(512, 32, 3, False)) == {"K3": 36}
    assert launches("int8-fused", vgg.Job(512, 32, 3, False)) == {"K1": 1, "K0": 28, "K2": 3}
    assert launches("ref", vgg.Job(512, 32, 3, True)) == {"K3": 27}


def test_k3_bound_of_conv3_2_at_batch_4():
    # (4,128,128,256->256): 77.3 GFLOP at 989 TFLOP/s = 0.0782 ms (PERF.md's table)
    c = vgg.Conv3("conv3_2", 256, 256, 4)
    ops, nbytes = vgg._bf16_conv(c, 512, 4)
    assert ops == 2 * 4 * 128 * 128 * 9 * 256 * 256
    assert nbytes == 2 * 4 * 128 * 128 * 512 + 2 * 9 * 256 * 256 + 4 * 256
    assert bound_s(ops, nbytes, BF16_PEAK_FLOPS) == pytest.approx(ops / BF16_PEAK_FLOPS)
    assert bound_s(ops, nbytes, BF16_PEAK_FLOPS) * 1e3 == pytest.approx(0.0782, abs=1e-4)


def test_a_bandwidth_bound_launch_is_bound_by_bytes():
    assert bound_s(1.0, 3.35e9, BF16_PEAK_FLOPS) == pytest.approx(3.35e9 / HBM_BYTES_S)


def test_resnet50_has_53_convs_and_4_09_gmac_at_224():
    assert len(resnet.convs(224)) == 53
    # torchvision's resnet50: 4.09 GMAC at 224 px with the 1000-way head
    assert resnet.forward_flops(224, 1000) / 2 == pytest.approx(4.089e9, rel=1e-3)


def test_resnet50_at_222_px_planes():
    cs = resnet.convs(222)
    assert (cs[0].side_in, cs[0].side_out) == (222, 111)
    assert cs[1].side_in == 56 and cs[-1].side_out == 7


def test_a_training_image_is_forward_plus_both_gradients():
    cs = resnet.convs(222)
    fwd = sum(c.macs() for c in cs)
    head = 2048 * 7
    assert resnet.train_flops(222, 7) == 2 * (3 * fwd - cs[0].macs() + 3 * head)
    work = resnet.conv_work(222, 32, True)
    assert len(work) == 3 * 53 - 1
    assert sum(o for o, _ in work) == 2 * 32 * (3 * fwd - cs[0].macs())
