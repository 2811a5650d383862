"""The port's training data path, loop and CLIs against the JAX package: the
BatchLoader's order, FreiburgPairDataset (get_batch bit-equal to the JAX
one, __getitem__ within 1e-3 relative of its cv2 resize, debug_loading),
FreiburgRGBThermalDataset and create_freiburg_dataloaders,
evaluate_thermal_depth, train_and_evaluate (early stop and resume against
the JAX loop), and cli.train / cli.grid_search on the tiny preset, with
their checkpoints read back by cli.infer. Synthetic Freiburg trees written
with cv2; tiny models in float32."""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import TINY_KW, configs, drawn_params, to_np, torch_state
from thermal3d.core.config import TrainConfig as JaxTrainConfig
from thermal3d.data import freiburg as jax_freiburg
from thermal3d.data.pipeline import BatchLoader as JaxBatchLoader
from thermal3d_torch.core.config import TrainConfig
from thermal3d_torch.data import freiburg
from thermal3d_torch.data.pipeline import BatchLoader
from thermal3d_torch.models.dustr import trainable_model

CPU = torch.device("cpu")
FRAME_HW = (48, 64)
STAMPS = [f"157000{i}_00{i}" for i in range(7)]
GT_HW = (16, 16)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/seq_00_day/00/{fl_ir_aligned,fl_rgb} with 7 frames (6 pairs at
    frame_skip 1), pseudo-GT for 5 of the pairs (one without confidences,
    one without a pose), the flat per-frame pseudo-GT layout, a pair with a
    corrupt thermal frame in a night sequence, and a tiny model's .pth."""
    root = tmp_path_factory.mktemp("train_tree")
    rng = np.random.default_rng(0)
    ds, pgt, flat = root / "ds", root / "pgt", root / "flat"
    for seq_dir in ("seq_00_day/00", "seq_01_night/00"):
        for sub in ("fl_ir_aligned", "fl_rgb"):
            (ds / "train" / seq_dir / sub).mkdir(parents=True)
    for sub in ("pointmap1", "pointmap2", "confidence1", "confidence2", "poses", "depth",
                "depth1"):
        (pgt / sub).mkdir(parents=True)
    (flat / "depth").mkdir(parents=True)
    yy, xx = np.meshgrid(np.linspace(0, 1, FRAME_HW[0]), np.linspace(0, 1, FRAME_HW[1]),
                         indexing="ij")
    seq = ds / "train" / "seq_00_day" / "00"
    for i, s in enumerate(STAMPS):
        frame = 0.5 * xx + 0.3 * np.sin(6 * yy + i) + 0.2 * rng.uniform(size=FRAME_HW)
        cv2.imwrite(str(seq / "fl_ir_aligned" / f"fl_ir_aligned_{s}.png"),
                    (21000 + 5000 * frame).astype(np.uint16))
        cv2.imwrite(str(seq / "fl_rgb" / f"fl_rgb_{s}.png"),
                    rng.integers(0, 256, (*FRAME_HW, 3)).astype(np.uint8))
        np.save(flat / "depth" / f"fl_rgb_{s}.npy",
                rng.uniform(1, 5, FRAME_HW).astype(np.float32))
    for i in range(5):
        b1, b2 = f"fl_rgb_{STAMPS[i]}", f"fl_rgb_{STAMPS[i + 1]}"
        name = f"{b1}_{b2}"
        for sub in ("pointmap1", "pointmap2"):
            pm = rng.uniform(0.1, 5, (*GT_HW, 3)).astype(np.float32)
            np.save(pgt / sub / f"{name}.npy", pm)
        if i != 1:
            for sub in ("confidence1", "confidence2"):
                np.save(pgt / sub / f"{name}.npy",
                        (1 + rng.uniform(size=GT_HW)).astype(np.float32))
        if i != 2:
            np.save(pgt / "poses" / f"{name}.npy", np.eye(4, dtype=np.float32) * (i + 1))
        np.save(pgt / "depth1" / f"{b1}.npy", rng.uniform(1, 5, GT_HW).astype(np.float32))
    bad = ds / "train" / "seq_01_night" / "00"  # no pseudo-GT: in the plain index only
    night = ["1580000_000", "1580001_001"]
    for s in night:
        cv2.imwrite(str(bad / "fl_rgb" / f"fl_rgb_{s}.png"), np.zeros((*FRAME_HW, 3), np.uint8))
    (bad / "fl_ir_aligned" / f"fl_ir_aligned_{night[0]}.png").write_bytes(b"not a png")
    cv2.imwrite(str(bad / "fl_ir_aligned" / f"fl_ir_aligned_{night[1]}.png"),
                np.full(FRAME_HW, 22000, np.uint16))
    _, tcfg = configs(**TINY_KW)
    weights = root / "tiny.pth"
    torch.save({"state_dict": trainable_model(tcfg, CPU, seed=5).state_dict()}, weights)
    return dict(root=root, ds=str(ds), pgt=str(pgt), flat=str(flat), weights=str(weights))


# --- BatchLoader ------------------------------------------------------------

class _Indexed:
    """Samples that carry their own index; every seventh one fails to load."""

    def __init__(self, n, batched):
        self.n = n
        if batched:
            self.get_batch = lambda idxs: [self[i] for i in idxs]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return None if i % 7 == 6 else {"i": np.array([i]), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("batched", [False, True])
def test_batch_loader_order_matches_jax(shuffle, drop_last, batched):
    idx = np.arange(3, 20)
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, drop_last=drop_last, num_workers=2)
    ours = BatchLoader(_Indexed(20, batched), idx, **kw)
    ref = JaxBatchLoader(_Indexed(20, batched), idx, **kw)
    assert len(ours) == len(ref)
    assert [ours.local_real_count(b) for b in range(len(ours))] == \
        [ref.local_real_count(b) for b in range(len(ref))]
    for _ in range(2):  # two epochs: the shuffle order moves with the epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert np.array_equal(g[k], w[k])


def test_batch_loader_refuses_several_processes():
    with pytest.raises(NotImplementedError, match="item 11"):
        BatchLoader(_Indexed(8, False), batch_size=4, process_id=1, process_count=2)


# --- the Freiburg datasets --------------------------------------------------

def _pair_datasets(tree, img_size=(32, 32)):
    kw = dict(img_size=img_size, pseudo_gt_dir=tree["pgt"], frame_skip=1)
    return (freiburg.FreiburgPairDataset(tree["ds"], **kw),
            jax_freiburg.FreiburgPairDataset(tree["ds"], **kw))


def test_pair_dataset_get_batch_bit_equal_to_jax(tree):
    ours, ref = _pair_datasets(tree)
    assert len(ours) == len(ref) == 5
    assert ours.pairs == ref.pairs
    idxs = [4, 0, 1, 2, 3]
    got, want = ours.get_batch(idxs), ref.get_batch(idxs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_pair_dataset_getitem_within_tolerance_of_jax(tree):
    """__getitem__: the JAX dataset decodes the full frame and resizes with
    cv2; the port decodes and resizes in one call of its decoder. The
    frames agree within 1e-3 relative of the raw counts; the pseudo-GT
    arrays are equal."""
    ours, ref = _pair_datasets(tree)
    for i in range(len(ours)):
        g, w = ours[i], ref[i]
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            if k.startswith("thermal"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-3)
            else:
                assert np.array_equal(g[k], w[k]), k


def test_pair_dataset_drops_undecodable_frames(tree, tmp_path):
    ds = freiburg.FreiburgPairDataset(tree["ds"], img_size=(32, 32), frame_skip=1,
                                      use_pseudo_gt=False)
    ref = jax_freiburg.FreiburgPairDataset(tree["ds"], img_size=(32, 32), frame_skip=1,
                                           use_pseudo_gt=False)
    assert ds.pairs == ref.pairs and len(ds) == 7  # 6 + the pair with the corrupt frame
    bad = next(i for i, p in enumerate(ds.pairs) if p["sequence"] == "seq_01_night")
    assert ds[bad] is None and ref[bad] is None
    assert len(ds.get_batch([0, bad, 1])) == len(ref.get_batch([0, bad, 1])) == 2


def test_debug_loading_matches_jax(tree, capsys):
    ours, ref = _pair_datasets(tree)
    for idx in (0, 6):
        got, want = ours.debug_loading(idx), ref.debug_loading(idx)
        assert got == want
    out = capsys.readouterr().out
    assert "loaded OK" in out and "gt.pose" in out
    empty = freiburg.FreiburgPairDataset(str(tree["root"] / "nothing"), sequences=[])
    assert empty.debug_loading() == {"pairs": 0}


def test_rgb_thermal_dataset_and_loaders_match_jax(tree):
    kw = dict(img_size=(32, 32), use_pseudo_gt=True, pseudo_gt_dir=tree["flat"])
    ours = freiburg.FreiburgRGBThermalDataset(tree["ds"], **kw)
    ref = jax_freiburg.FreiburgRGBThermalDataset(tree["ds"], **kw)
    assert ours.pairs == ref.pairs
    for i in range(len(ours)):
        g, w = ours[i], ref[i]
        if w is None:
            assert g is None
            continue
        assert sorted(g) == sorted(w)
        np.testing.assert_allclose(g["thermal"], w["thermal"], rtol=1e-3)
        np.testing.assert_allclose(g["rgb"], w["rgb"], atol=2e-2)  # 8-bit resize rounding
        if "depth" in w:
            assert np.array_equal(g["depth"], w["depth"])
    got = freiburg.create_freiburg_dataloaders(tree["ds"], batch_size=2, img_size=(32, 32),
                                               seed=1)
    want = jax_freiburg.create_freiburg_dataloaders(tree["ds"], batch_size=2,
                                                    img_size=(32, 32), seed=1)
    for g, w in zip(got, want):
        assert np.array_equal(g.indices, w.indices) and len(g) == len(w)
        assert (g.shuffle, g.drop_last) == (w.shuffle, w.drop_last)


def test_evaluate_thermal_depth_matches_jax(tree):
    """Both evaluators on the same in-memory samples (depth1 GT, a pointmap
    GT and one without GT), tiny engines on the same weights."""
    from thermal3d.evaluation.evaluator import evaluate_thermal_depth as jax_eval
    from thermal3d.infer.engine import InferenceEngine as JaxEngine
    from thermal3d_torch.evaluation.evaluator import evaluate_thermal_depth
    from thermal3d_torch.infer.engine import InferenceEngine

    jcfg, tcfg = configs(**TINY_KW)
    params = drawn_params(jcfg, seed=2)
    rng = np.random.default_rng(4)
    samples = []
    for i in range(4):
        s = {"thermal1": rng.uniform(21000, 26000, (32, 32, 3)).astype(np.float32)}
        if i == 0:
            s["depth1"] = rng.uniform(1, 5, (24, 20)).astype(np.float32)
        elif i < 3:
            s["pointmap1"] = rng.uniform(0.5, 5, (32, 32, 3)).astype(np.float32)
        samples.append(s)
    want = jax_eval(JaxEngine(jcfg, params=params), samples)
    got = evaluate_thermal_depth(InferenceEngine(tcfg, state_dict=torch_state(params),
                                                 device="cpu"), samples)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k


# --- the loop ---------------------------------------------------------------

def _batch(rng, b, hw=32, ghw=16):
    return {
        "thermal1": rng.uniform(21000, 26000, (b, hw, hw, 3)).astype(np.float32),
        "thermal2": rng.uniform(21000, 26000, (b, hw, hw, 3)).astype(np.float32),
        "pointmap1": rng.uniform(0.1, 5, (b, ghw, ghw, 3)).astype(np.float32),
        "pointmap2": rng.uniform(0.1, 5, (b, ghw, ghw, 3)).astype(np.float32),
        "confidence1": np.ones((b, ghw, ghw), np.float32),
        "confidence2": np.ones((b, ghw, ghw), np.float32),
    }


class _Samples:
    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.samples = [{k: v[0] for k, v in _batch(rng, 1).items()} for _ in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def test_loop_early_stop_and_resume_match_jax(tmp_path):
    """lr 0 holds the weights, so each epoch's validation loss repeats:
    epoch 1 improves, epoch 2 does not, and patience 1 stops the run after
    2 epochs. The port straight through, and resumed from its epoch-1
    checkpoint, ends as the JAX loop does: the same epochs_run, final_step
    and best_val (10 samples in batches of 3: a short validation batch of 2,
    padded)."""
    from thermal3d.core.mesh import make_mesh
    from thermal3d.models.dustr import AsymmetricCroCo3DStereo as JaxModel
    from thermal3d.train.loop import train_and_evaluate as jax_loop
    from thermal3d_torch.train.loop import train_and_evaluate

    jcfg, tcfg = configs(**TINY_KW)
    params = drawn_params(jcfg, seed=1)
    kw = dict(lr=0.0, eta_min=0.0, batch_size=3, early_stop_patience=1, log_interval=1,
              max_batches=1)
    ds = _Samples(10)
    mesh = make_mesh((1,), ("data",), devices=jax.devices("cpu")[:1])
    want = jax_loop(JaxModel(jcfg), jax.tree_util.tree_map(jnp.asarray, params), ds,
                    JaxTrainConfig(epochs=5, **kw), mesh=mesh)
    assert want["epochs_run"] == 2 and want["final_step"] == 2

    def port_run(epochs, resume, ckpt):
        model = trainable_model(tcfg, CPU, torch_state(params))
        return train_and_evaluate(model, ds, TrainConfig(epochs=epochs, **kw),
                                  checkpoint_dir=ckpt and str(tmp_path / ckpt), resume=resume)

    straight = port_run(5, False, None)
    first = port_run(1, False, "port")
    resumed = port_run(5, True, "port")
    assert first["epochs_run"] == 1 and first["final_step"] == 1
    for got in (straight, resumed):
        assert (got["epochs_run"], got["final_step"]) == (want["epochs_run"], want["final_step"])
        assert got["best_val_loss"] == pytest.approx(want["best_val_loss"], rel=1e-5)


def test_loop_logs_the_reference_metrics(tmp_path):
    from thermal3d_torch.train.logging import MetricLogger
    from thermal3d_torch.train.loop import train_and_evaluate

    _, tcfg = configs(**TINY_KW)
    log = tmp_path / "log.jsonl"
    logger = MetricLogger(use_wandb=True, log_file=str(log))
    model = trainable_model(tcfg, CPU, seed=0)
    cfg = TrainConfig(epochs=1, batch_size=2, lr=1e-3, log_interval=2, max_batches=3)
    summary = train_and_evaluate(model, _Samples(12, seed=1), cfg, logger=logger)
    logger.finish()
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    steps = [x for x in lines if "batch_loss" in x]
    assert [x["global_step"] for x in steps] == [1, 2, 3] and summary["final_step"] == 3
    assert set(steps[0]) >= {"batch_loss", "basic_loss", "edge_loss", "smoothness_loss",
                             "detail_loss", "learning_rate", "global_step"}
    assert steps[0]["learning_rate"] == pytest.approx(1e-3)  # one epoch: no warmup
    assert any("train_loss" in x for x in lines) and any("val_loss" in x for x in lines)
    with pytest.raises(NotImplementedError, match="item 11"):
        train_and_evaluate(model, _Samples(4), TrainConfig(mesh_shape=(2,)))


# --- the CLIs ---------------------------------------------------------------

def _train_args(tree, out, *extra):
    return ["--dataset_dir", tree["ds"], "--pseudo_gt_dir", tree["pgt"], "--weights",
            tree["weights"], "--output_model", out, "--model_preset", "tiny", "--img_size",
            "32", "32", "--compute_dtype", "float32", "--batch_size", "2", "--frame_skip", "1",
            "--max_batches", "2", "--use_thermal_aware_loss", "--multi_scale", "--device", "cpu",
            "--no_wandb", *extra]


def test_cli_train_resume_and_infer_from_its_checkpoint(tree, tmp_path, capsys):
    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.cli import train as cli_train
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.train.checkpoint import load_params_from_checkpoint_dir

    out = str(tmp_path / "ckpt")
    first = cli_train.main(_train_args(tree, out, "--epochs", "2", "--lr", "1e-4"))
    assert first["epochs_run"] == 2 and first["final_step"] == 4
    assert os.listdir(os.path.join(out, "last")) == ["2"]
    capsys.readouterr()
    second = cli_train.main(_train_args(tree, out, "--epochs", "3", "--lr", "1e-4", "--resume"))
    logged = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert second["epochs_run"] == 3 and second["final_step"] == 6
    assert {x["epoch"] for x in logged if "epoch" in x} == {3.0}  # resumed at epoch 3
    assert [x["global_step"] for x in logged if "global_step" in x] == [5.0, 6.0]

    frame = os.path.join(tree["ds"], "train", "seq_00_day", "00", "fl_ir_aligned",
                         f"fl_ir_aligned_{STAMPS[0]}.png")
    cli_infer.main(["--img_path", frame, "--output_dir", str(tmp_path / "inf"), "--weights",
                    out, "--model_preset", "tiny", "--img_size", "32", "32",
                    "--compute_dtype", "float32", "--no_vis", "--device", "cpu"])
    depth = np.load(tmp_path / "inf" / f"fl_ir_aligned_{STAMPS[0]}_depth.npy")
    state, meta = load_params_from_checkpoint_dir(out)
    _, tcfg = configs(**TINY_KW)
    ref = InferenceEngine(tcfg, state_dict=state, device="cpu").infer_paths(
        [frame], outputs=("depth",))["depth"][0]
    np.testing.assert_array_equal(depth, ref)
    assert meta["epoch"] in (1, 2, 3)


def test_cli_train_debug_loading(tree, capsys):
    from thermal3d_torch.cli import train as cli_train

    assert cli_train.main(_train_args(tree, "unused", "--debug_loading", "0")) is None
    assert "loaded OK" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [(["--mesh_shape", "2"], "item 11"),
                                        (["--multihost"], "item 11"), (["--zero1"], "item 11"),
                                        (["--scan_layers"], "item 12"), (["--ndev", "2"], "item 11")])
def test_cli_train_parser_errors(tree, flags, item, capsys):
    from thermal3d_torch.cli import train as cli_train

    with pytest.raises(SystemExit) as exc:
        cli_train.main(_train_args(tree, "unused", *flags))
    assert exc.value.code == 2 and item in capsys.readouterr().err


def test_cli_grid_search(tree, tmp_path):
    from thermal3d_torch.cli import grid_search

    out = tmp_path / "grid"
    payload = grid_search.main([
        "--dataset_dir", tree["ds"], "--pseudo_gt_dir", tree["pgt"], "--weights",
        tree["weights"], "--output_dir", str(out), "--edge_weights", "0.3", "0.7",
        "--smoothness_weights", "0.1", "--epochs", "1", "--batch_size", "2",
        "--max_batches", "1", "--frame_skip", "1", "--img_size", "32", "32",
        "--model_preset", "tiny", "--device", "cpu"])
    assert [(r["edge_weight"], r["smoothness_weight"]) for r in payload["results"]] == \
        [(0.3, 0.1), (0.7, 0.1)]
    assert all(np.isfinite(r["val_loss"]) for r in payload["results"])
    assert json.loads((out / "best_params.json").read_text()) == payload
    script = (out / "run_best_params.sh").read_text()
    assert "thermal3d_torch.cli.train" in script and f"--edge_weight {payload['best']['edge_weight']}" in script
