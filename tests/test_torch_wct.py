"""WCT universal style transfer on the port's stylize path, on the CPU
(``ccst_tpu_torch/ops/wct.py``, ``pipeline/wct.py``, ``kernels/wct.py``, the
second-order bank of ``pipeline/style_bank.py``), held to the benchmark's
plain reference ``gpubench/reference/wct.py`` (float32 convs, float64
transform, which imports nothing of the port):

- the transform of seeded VGG-scale features against the reference's float64
  transform, and the centring kernel's plain version;
- the whole five-level cascade at 32 px, batch 2, 2 banks, float32, on the
  reference's seeded weights;
- the bank summed over uneven batches against one float64 covariance;
- the architectures (the relu4_1 decoder is AdaIN's), the solves counted under
  a profiler, the CLI's ``--model wct`` and its refusals, and that the AdaIN
  path loads nothing of WCT.

This file imports no JAX: WCT has no counterpart in the JAX package.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccst_tpu_torch.cli import main as cli
from ccst_tpu_torch.data.lists import write_list
from ccst_tpu_torch.data.loader import save_image_u8
from ccst_tpu_torch.kernels import wct as kw
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.ops import wct as ops
from ccst_tpu_torch.pipeline import style_bank as sb
from ccst_tpu_torch.pipeline import wct as pw
from ccst_tpu_torch.utils import profiling
from gpubench.reference import wct as ref
from gpubench.reference.images import blocky_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def _vgg_like(rng, b, side, c):
    """ReLU features at VGG's scale (~1e2): a low-rank part, noise, and an
    eighth of the channels dead, as random VGG weights leave them."""
    base = rng.standard_normal((b, side * side, c // 4)) @ rng.standard_normal((c // 4, c)) * 40
    x = np.maximum(base + rng.standard_normal((b, side * side, c)) * 5 + 20, 0)
    x[..., : c // 8] = 0
    return torch.from_numpy(x.reshape(b, side, side, c)).float()


def _transform(f, mean, colour, alpha):
    """One level's transform as the engine runs it: whiten, then colour."""
    hi, w = ops.whiten(f)
    return ops.colour(f, hi, w, mean, colour, alpha)


def _style(rng, c):
    sf = np.maximum(rng.standard_normal((4096, c)) @ rng.standard_normal((c, c)) * 3, 0)
    return torch.from_numpy(sf.mean(0)), ref.colour_matrix(torch.from_numpy(np.cov(sf.T)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("b,side,c", [(2, 32, 64), (2, 24, 128), (2, 32, 256), (2, 24, 512)])
def test_the_transform_matches_the_reference_float64_transform(seed, b, side, c):
    # float32 features: the centring rounds d to float32 and the Gram sums in
    # float32 (2^-24 an operation), the solve is float64; measured worst over
    # five seeds 8.6e-6 of the output's largest value and 7.2e-7 of ||W||_F:
    # ten times that is the tolerance
    rng = np.random.default_rng(seed)
    f = _vgg_like(rng, b, side, c)
    mean, colour = _style(rng, c)
    want = ref.transform(f.permute(0, 3, 1, 2), mean, colour, 1.0).permute(0, 2, 3, 1)
    got = _transform(f, mean.float(), colour, 1.0)
    assert got.dtype == torch.float32 and got.shape == f.shape
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    w = ops.whiten(f)[1]
    w_ref = ref.whitening(f.permute(0, 3, 1, 2).double())[1]
    gap = (w - w_ref).flatten(1).norm(dim=1) / w_ref.flatten(1).norm(dim=1)
    assert float(gap.max()) < 1e-5


def test_alpha_blends_the_transformed_with_the_content_features():
    rng = np.random.default_rng(2)
    f = _vgg_like(rng, 2, 16, 64)
    mean, colour = _style(rng, 64)
    full = _transform(f, mean.float(), colour, 1.0)
    half = _transform(f, mean.float(), colour, 0.5)
    torch.testing.assert_close(half, 0.5 * full + 0.5 * f, rtol=1e-5, atol=1e-3)


def test_inv_sqrt_of_a_batch_equals_the_eigendecomposition():
    # eigenvalues from 1 to 1e5, the spread the 512 px contents reach: the
    # iteration converges within NS_ITERS to float64 rounding times the spread
    rng = np.random.default_rng(3)
    q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((3, 128, 128))))
    e = torch.logspace(0, 5, 128, dtype=torch.float64)
    a = (q * e) @ q.transpose(1, 2)
    want = (q * e.rsqrt()) @ q.transpose(1, 2)
    got = ops.inv_sqrt(a)
    assert float(((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max()) < 1e-9


@pytest.mark.parametrize("p", [100, 3 * 64, 3 * 64 + 17])
def test_the_gram_summed_in_runs_equals_the_float64_gram(p, monkeypatch):
    # runs of 64 positions: none (P < 2 runs), whole runs only, runs and a
    # remainder; float32 sums of 64 products of integers below 2^8 are exact
    monkeypatch.setattr(ops, "GRAM_RUN", 64)
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(-255, 256, (3, p, 24))).float()
    b = torch.from_numpy(rng.integers(-255, 256, (3, p, 16))).float()
    got = ops.gram64(a, b)
    assert got.dtype == torch.float64
    assert torch.equal(got, a.double().transpose(1, 2) @ b.double())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_centring_split_holds_the_centred_features_and_the_ones(dtype):
    rng = np.random.default_rng(4)
    x = (torch.from_numpy(rng.standard_normal((2, 50, 16))) * 60 + 40).to(dtype)
    mean = x.mean(dim=1, dtype=torch.float32)
    hi, lo = kw.centre_split(x, mean)
    d = x.float() - mean[:, None]
    assert hi.shape == (2, 50, 16 + kw.PAD) and hi.dtype == dtype
    assert torch.equal(hi[..., 16:18].float(), torch.ones(2, 50, 2))
    assert torch.equal(hi[..., 18:].float(), torch.zeros(2, 50, 6))
    if dtype == torch.float32:
        assert lo is None and torch.equal(hi[..., :16], d)
    else:
        # hi + lo is d to the rounding of lo: 2^-9 of 2^-8 of |d|
        assert lo.dtype == torch.bfloat16 and lo.shape == x.shape
        err = (hi[..., :16].float() + lo.float() - d).abs()
        assert float((err / d.abs().clamp_min(1e-3)).max()) < 2.0 ** -16


def _weights(seed):
    gen = torch.Generator().manual_seed(seed)
    enc, decs = ref.make_weights(gen, 0.002, 0.5)
    return gen, enc, decs


def _program_bank(enc, images, batches=(None,)):
    step = sb.make_wct_bank_step(enc, torch.float32, "cpu")
    sums = sb.wct_bank_init()
    at = 0
    for n in batches:
        n = images.shape[0] - at if n is None else n
        chunk = images[at:at + n].float() / 255.0
        # the loader pads the last batch; only the valid rows reach the sums
        padded = torch.cat([chunk, chunk[:1]]) if n < images.shape[0] else chunk
        sums = step(sums, padded, n)
        at += n
    return sb.wct_bank_finalize(sums)


@pytest.mark.parametrize("seed", [100, 101])
def test_the_cascade_at_32_px_matches_the_reference(seed):
    # float32 on both sides; the convs differ in summation order only (the
    # plain K3 against F.conv2d), and five whitenings of 2 x 2 .. 32 x 32
    # maps magnify that: measured max 4 levels, mean 0.22-0.49 levels over
    # three seeds, against outputs of std ~45 levels (~30 between contents)
    gen, enc, decs = _weights(seed)
    content = blocky_noise(gen, 2, 32)
    styles = [blocky_noise(gen, 3, 32) for _ in range(2)]
    want = ref.stylize(enc, decs, content, [ref.style_bank(enc, s, 2) for s in styles], 2)
    engine = pw.WCTEngine(enc, decs, dtype=torch.float32, device="cpu", output_u8=True)
    with profile(activities=[ProfilerActivity.CPU]):
        got = engine.stylize_multi(content, engine.stack([_program_bank(enc, s) for s in styles]))
    assert got.shape == (2, 2, 32, 32, 3) and got.dtype == torch.uint8
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 8 and float(diff.float().mean()) <= 1.0
    assert float(want.float().std(dim=1).mean()) > 10  # the outputs differ with their content
    rec = profiling.record()
    assert rec["counters"]["wct.solves"] == 2 * (1 + 4 * 2)
    assert rec["spans"]["stylize.wct_level"]["count"] == 1 + 5 * 2
    assert rec["spans"]["stylize.wct"]["count"] == 1 + 5 * 2
    assert rec["spans"]["stylize.wct_solve"]["count"] == 1 + 4 * 2


def test_the_bank_over_uneven_batches_equals_one_float64_covariance():
    rng = np.random.default_rng(7)
    chans = {"relu5_1": 512, "relu4_1": 512, "relu3_1": 256, "relu2_1": 128, "relu1_1": 64}
    batches = [{lv: _vgg_like(rng, n, 4, c) for lv, c in chans.items()} for n in (3, 1, 2)]
    sums = sb.wct_bank_init()
    for taps in batches:
        sums = sb.wct_bank_update(sums, taps)
    bank = sb.wct_bank_finalize(sums)
    for level, c in chans.items():
        x = torch.cat([t[level] for t in batches]).double().reshape(-1, c).numpy()
        assert bank.count[level] == x.shape[0] == 6 * 16
        np.testing.assert_allclose(bank.mean[level].double().numpy(), x.mean(0),
                                   rtol=1e-6, atol=1e-6 * np.abs(x).max())
        cov = np.cov(x.T)
        # float64 sums of the same float32 features, folded in another order
        np.testing.assert_allclose(bank.cov[level].numpy(), cov, rtol=0,
                                   atol=1e-10 * np.abs(cov).max())
        torch.testing.assert_close(bank.colour[level], ref.colour_matrix(bank.cov[level]))


def test_the_bank_step_takes_the_valid_rows_of_a_padded_batch():
    gen, enc, _ = _weights(7)
    images = blocky_noise(gen, 3, 32).float() / 255.0
    step = sb.make_wct_bank_step(enc, torch.float32, "cpu")
    padded = step(sb.wct_bank_init(), torch.cat([images, images[:1]]), 3)
    alone = step(sb.wct_bank_init(), images, 3)
    for level in vgg.WCT_LEVELS:
        assert padded[level][0] == alone[level][0] == 3 * (32 // {"relu5_1": 16, "relu4_1": 8,
                                                                  "relu3_1": 4, "relu2_1": 2,
                                                                  "relu1_1": 1}[level]) ** 2
        torch.testing.assert_close(padded[level][2], alone[level][2], rtol=1e-5, atol=1e-3)


def test_a_bank_saves_and_loads(tmp_path):
    gen, enc, _ = _weights(8)
    bank = _program_bank(enc, blocky_noise(gen, 2, 32))
    path = str(tmp_path / "stats" / "cartoon_wct.npz")
    sb.save_wct_bank(path, bank)
    back = sb.load_wct_bank(path)
    for kind in ("mean", "cov", "colour"):
        for level in vgg.WCT_LEVELS:
            assert torch.equal(getattr(back, kind)[level], getattr(bank, kind)[level])
    assert back.count == bank.count


def test_the_architectures_are_the_published_ones():
    assert vgg.WCT_DECODER_ARCHS["relu4_1"] is vgg.DECODER_ARCH
    assert vgg.WCT_ENCODER_ARCH[:len(vgg.ENCODER_ARCH)] == vgg.ENCODER_ARCH
    assert vgg.WCT_DECODER_ARCHS["relu5_1"][-len(vgg.DECODER_ARCH):] == vgg.DECODER_ARCH
    convs = {lv: [(l.name, l.cin, l.cout) for l in a if isinstance(l, vgg.Conv)]
             for lv, a in vgg.WCT_DECODER_ARCHS.items()}
    for level, layers in convs.items():
        assert [n for n, *_ in layers] == [l[0] for l in ref.convs(ref.DECODERS[level])]
        assert layers[-1] == ("dconv1_1", 64, 3)
    assert convs["relu1_1"] == [("dconv1_1", 64, 3)]
    assert [(n, ci, co) for n, ci, co, _, _ in ref.convs(ref.ENCODER)] == [
        (l.name, l.cin, l.cout) for l in vgg.WCT_ENCODER_ARCH if isinstance(l, vgg.Conv)]


def test_a_call_of_32_under_3_banks_counts_416_solves(monkeypatch):
    # the count is of matrices whitened: the encoders, decoders and solves are
    # swapped for cheap ones of the same shapes so that batch 32 runs fast
    chans = {"relu5_1": 512, "relu4_1": 512, "relu3_1": 256, "relu2_1": 128, "relu1_1": 64}
    monkeypatch.setattr(vgg, "encode_to", lambda p, x, tap, taps=(): torch.rand(
        x.shape[0], 2, 2, chans[tap]))
    monkeypatch.setattr(vgg, "decode_from", lambda p, f, tap: torch.rand(f.shape[0], 8, 8, 3))
    monkeypatch.setattr(ops, "inv_sqrt", lambda a, iters=ops.NS_ITERS: a)
    gen, enc, decs = _weights(9)
    engine = pw.WCTEngine(enc, decs, dtype=torch.float32, device="cpu", output_u8=True)
    banks = pw.StackedBanks({lv: torch.rand(3, c) for lv, c in chans.items()},
                            {lv: torch.rand(3, c, c, dtype=torch.float64)
                             for lv, c in chans.items()})
    images = torch.zeros((32, 8, 8, 3), dtype=torch.uint8)
    engine.stylize_multi(images, banks)
    assert profiling.record()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        out = engine.stylize_multi(images, banks)
    assert out.shape == (3, 32, 8, 8, 3)
    assert profiling.record()["counters"]["wct.solves"] == 416


def test_the_engine_refuses_what_wct_does_not_run():
    from ccst_tpu_torch.pipeline.stylize import EngineBase, StylizeEngine

    _, enc, decs = _weights(10)
    with pytest.raises(ValueError, match="ref engine only"):
        pw.WCTEngine(enc, decs, dtype=torch.float32, device="cpu", engine="int8-fused")
    engine = pw.WCTEngine(enc, decs, dtype=torch.float32, device="cpu")
    # Single mode's entries are AdaIN's engine's alone (the CLI refuses the mode)
    assert not hasattr(engine, "stylize") and not hasattr(engine, "style_stats_of")
    assert not isinstance(engine, StylizeEngine) and isinstance(engine, EngineBase)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 domains x 3 images at 32 px, train lists."""
    root = str(tmp_path_factory.mktemp("wct_tree"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names = [f"PACS/kfold/{d}/c0/img{i}.png" for i in range(3)]
        for n in names:
            save_image_u8(rng.random((32, 32, 3), np.float32), os.path.join(root, n))
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, [0] * 3)
    return root


def test_the_cli_writes_wct_banks_and_stylizes_with_them(tree, tmp_path):
    stats, out = str(tmp_path / "stats"), str(tmp_path / "out")
    common = ["--dataset", "pacs", "--list-root", tree, "--data-root", tree,
              "--style-stats-dir", stats, "--image-size", "32", "--batch-size", "2",
              "--dtype", "float32", "--device", "cpu"]
    assert cli(["style-bank", "--model", "wct", *common]) == 0
    for d in DOMAINS:
        bank = sb.load_wct_bank(os.path.join(stats, "pacs", f"{d}_wct.npz"))
        assert set(bank.cov) == set(vgg.WCT_LEVELS) and bank.count["relu1_1"] == 3 * 32 * 32
    assert not os.path.exists(os.path.join(stats, "pacs", "art_painting_mean_std.npz"))
    assert cli(["stylize", "--model", "wct", *common, "--target", "photo", "--mode", "overall",
                "--output-root", out]) == 0
    written = sorted(os.path.relpath(os.path.join(dp, f), out)
                     for dp, _, fs in os.walk(out) for f in fs if f.endswith(".png"))
    assert len(written) == 3 * 3
    with open(os.path.join(out, "pacs_photo_overall_stylize_time.json")) as f:
        assert json.load(f)["images_per_style"] == 3
    for bad in (["--engine", "int8-fused"], ["--mode", "single"], ["--skip-existing"]):
        with pytest.raises(SystemExit):
            cli(["stylize", "--model", "wct", *common, "--target", "photo", *bad,
                 "--output-root", out])


def test_the_adain_path_loads_nothing_of_wct():
    code = ("import sys\n"
            "from ccst_tpu_torch import cli\n"
            "from ccst_tpu_torch.pipeline import stylize, style_bank\n"
            "print(sorted(m for m in sys.modules if m.endswith(('.wct', 'wct_centre'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
