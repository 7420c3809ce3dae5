"""The port's SWA / AutoSWA policies, plots, summaries and round exports
against ``ccst_tpu``'s.

``utils/swa.py`` is a port to torch state dicts: the cases of
``tests/test_eval_time.py`` (running mean, weighted merge, SWALR, LossValley's
convergence and dead valley, IIDMax, ``swa_update_bn``) run through both
packages and must give the same averages, counts, steps and decisions; the
re-estimated BatchNorm statistics of ``resnet4`` within float32's reduction
error (1e-5). ``utils/plotting.py``, ``utils/excel_log.py`` and the CLI's
``summarize`` and ``plot`` run on one JSONL log in both packages: the same
PNG bytes, the same CSV, the same printed summary.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccst_tpu.utils.swa as jswa
import ccst_tpu_torch.utils.swa as tswa
from ccst_tpu.cli import main as jax_cli
from ccst_tpu_torch.cli import main as torch_cli
from tests.torch_parity import one_torch_thread  # noqa: F401


def _tree(pkg, v):
    return {"w": jnp.asarray([float(v)])} if pkg is jswa else {"w": torch.tensor([float(v)])}


def _w(state):
    return float(np.asarray(state.avg_params["w"])[0])


def _same_state(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert _w(a) == pytest.approx(_w(b), rel=1e-6)
    assert (a.n_averaged, a.start_step, a.end_step) == (b.n_averaged, b.start_step, b.end_step)
    assert a.end_loss == b.end_loss


def _running_mean(pkg):
    s = pkg.swa_init(_tree(pkg, 1.0), step=0)
    out = []
    for i, v in enumerate((3.0, 5.0, -2.5), 1):
        s = pkg.swa_update(s, _tree(pkg, v), step=i)
        out.append(s)
    return out


def test_swa_running_mean_matches_jax():
    for a, b in zip(_running_mean(tswa), _running_mean(jswa)):
        _same_state(a, b)
    assert _w(_running_mean(tswa)[1]) == 3.0


def _merged(pkg):
    a = pkg.swa_update(pkg.swa_init(_tree(pkg, 1.0)), _tree(pkg, 1.0), step=4)
    b = pkg.swa_init(_tree(pkg, 4.0), step=2)
    b.end_loss = 0.5
    return pkg.swa_merge(a, b)


def test_swa_merge_weighted_matches_jax():
    _same_state(_merged(tswa), _merged(jswa))
    assert _w(_merged(tswa)) == 2.0 and _merged(tswa).n_averaged == 3


def test_swa_lr_schedule_matches_jax():
    ours, theirs = tswa.swa_lr_schedule(0.1, 0.01, 10), jswa.swa_lr_schedule(0.1, 0.01, 10)
    assert [ours(s) for s in (0, 3, 5, 9, 10, 100)] == [theirs(s) for s in (0, 3, 5, 9, 10, 100)]


@pytest.mark.parametrize("converge,tolerance,ratio,losses", [
    (3, 3, 0.5, [1.0, 0.8, 0.9, 0.85, 0.82, 0.84]),
    (2, 2, 0.1, [0.5, 0.6, 5.0, 6.0, 7.0]),          # the valley dies
    (3, 6, 0.3, [0.9, 0.7, 0.8, 0.75, 0.72, 0.74, 0.73, 0.9, 0.71]),
    (4, 2, 0.3, [0.9, 0.6, 0.8, 0.75, 0.72, 0.64, 0.73, 0.9]),
    (3, 6, 0.3, [1.0, 0.9, 0.8, 0.7]),               # never converges
])
def test_loss_valley_matches_jax(converge, tolerance, ratio, losses):
    def run(pkg):
        lv = pkg.LossValley(n_converge=converge, n_tolerance=tolerance, tolerance_ratio=ratio)
        for i, loss in enumerate(losses):
            seg = pkg.swa_init(_tree(pkg, float(i)), step=i)
            lv.update(seg, loss)
        return lv, lv.get_final()

    (ours, final), (theirs, want) = run(tswa), run(jswa)
    assert (ours.is_converged, ours.dead_valley, ours.converge_step, ours.threshold) == (
        theirs.is_converged, theirs.dead_valley, theirs.converge_step, theirs.threshold)
    _same_state(final, want)


def test_iidmax_matches_jax():
    def run(pkg):
        pol = pkg.IIDMax()
        for i, acc in enumerate([0.5, 0.7, 0.6, 0.65, 0.8, 0.75]):
            pol.update(_tree(pkg, float(i)), acc,
                       lambda p: float(np.asarray(p["w"])[0]) / 10 - 0.01 * float(i), i)
        return pol

    ours, theirs = run(tswa), run(jswa)
    assert (ours.iid_max_acc, ours.swa_max_acc) == (theirs.iid_max_acc, theirs.swa_max_acc)
    _same_state(ours.get_final(), theirs.get_final())


def test_swa_update_bn_matches_jax():
    from ccst_tpu.data.loader import Batch as JBatch
    from ccst_tpu.models.classifiers import get_network as jnet
    from ccst_tpu_torch.data.loader import Batch as TBatch
    from ccst_tpu_torch.models.classifiers import get_network as tnet
    from ccst_tpu_torch.models.convert_resnet import from_jax

    model = jnet("resnet4", classes=4)
    v = jax.jit(lambda k: model.init(k, jnp.ones((1, 36, 36, 3)), train=False))(
        jax.random.PRNGKey(0))
    r = np.random.default_rng(3)
    data = [(r.random((8, 36, 36, 3), np.float32), r.integers(0, 4, 8), valid)
            for valid in (8, 5)]
    want = jswa.swa_update_bn(model, v["params"], [JBatch(x, y, [""] * k, k) for x, y, k in data],
                              image_size=32)
    got = tswa.swa_update_bn(tnet("resnet4", 4), from_jax(v["params"], v["batch_stats"]),
                             [TBatch(x, y, [""] * k, k) for x, y, k in data], 32, "cpu")
    want = {k: w for k, w in from_jax(v["params"], want).items() if "running" in k}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    assert not np.allclose(got["bn1.running_mean"].numpy(), 0.0)  # moved toward the data


@pytest.fixture(scope="module")
def log(tmp_path_factory):
    """A fed-train JSONL log of four rounds, with a test event between."""
    path = tmp_path_factory.mktemp("logs") / "run_seed1.jsonl"
    r = np.random.default_rng(0)
    with open(path, "w") as f:
        f.write(json.dumps({"event": "config", "dataset": "pacs"}) + "\n")
        for i in range(4):
            f.write(json.dumps({"event": "round", "round": i, "train_loss": float(r.random()),
                                "val_acc_mean": float(r.random()),
                                "test_acc": float(r.random())}) + "\n")
        f.write(json.dumps({"event": "test", "test_acc": 0.5}) + "\n")
    return str(path)


def test_summarize_prints_what_jax_prints(log, capsys):
    assert jax_cli(["summarize", log, log, "--expected-rounds", "5"]) == 0
    want = capsys.readouterr().out
    assert torch_cli(["summarize", log, log, "--expected-rounds", "5"]) == 0
    assert capsys.readouterr().out == want
    assert json.loads(want)["incomplete_runs"] == [0, 1]


def test_plot_writes_the_png_jax_writes(log, tmp_path, capsys):
    for cli, name in ((jax_cli, "jax.png"), (torch_cli, "torch.png")):
        assert cli(["plot", log, "-o", str(tmp_path / name), "--metrics",
                    "test_acc,train_loss,jig_acc", "--title", "run"]) == 0
    assert capsys.readouterr().out.split() == [str(tmp_path / "jax.png"),
                                               str(tmp_path / "torch.png")]
    with open(tmp_path / "jax.png", "rb") as a, open(tmp_path / "torch.png", "rb") as b:
        assert a.read() == b.read()


def test_round_exports_and_stage_timer_match_jax(log, tmp_path):
    """The round exports. (The port's ``StageTimer``, which nothing called, is
    gone; the test keeps its name.)"""
    import ccst_tpu.utils.excel_log as jx
    import ccst_tpu_torch.utils.excel_log as tx

    for mod, name in ((jx, "jax"), (tx, "torch")):
        mod.export_rounds_csv(log, str(tmp_path / f"{name}.csv"))
        mod.export_rounds_csv(log, str(tmp_path / f"{name}_test.csv"), event="test")
        mod.export_rounds_xlsx(log, str(tmp_path / f"{name}.xlsx"))
    for suffix in (".csv", "_test.csv"):
        assert (tmp_path / f"torch{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()
    # no openpyxl here: both fall back to the CSV beside the asked path
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{n}{s}" for n in ("jax", "torch") for s in (".csv", "_test.csv"))
