"""The port's multi-process training (thermal3d_torch/core/{distributed,mesh,
collectives}.py, the tensor-parallel layers, ZeRO-1 in train/state.py, the
loop and cli.train) in real OS processes joined over gloo on the CPU, on the
tiny model and global batch of tests/_multihost_worker.py.

Each test launches its ranks as `python tests/test_torch_distributed.py
CASE RANK WORLD PORT DIR` (the worker at the bottom of this file, which
imports torch and numpy only), waits with its own timeout and kills every
rank on the way out. The references run in this process: the port's
one-process step on the global batch and, for the data-parallel step, the
JAX package's 8-device DP step (_multihost_worker.run_one_step).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tests._multihost_worker import GLOBAL_BATCH, TINY_KW, make_global_batch  # noqa: E402

TIMEOUT = 300  # seconds for every rank of one job
STEP_LR = 1e-3  # lr of the step cases
# a narrow model whose head counts 4 ranks divide (head_dim 8), for the
# 4-rank layouts of the multi-device phase: DP 4, ZeRO-1 4, DP×TP 2×2, TP 4
NARROW_KW = dict(img_size=(32, 32), enc_embed_dim=32, enc_depth=2, enc_num_heads=4,
                 dec_embed_dim=32, dec_depth=1, dec_num_heads=4)
FOUR_RANK_LAYOUTS = ["4", "4_zero1", "2x2", "1x4"]


# --- shared by the ranks and the one-process references ---------------------

def _global_batch(step: int):
    """make_global_batch() for step 0; later steps scale its rows."""
    return {k: v * np.float32(1.0 + 0.05 * step) if k.startswith(("thermal", "pointmap"))
            else v for k, v in make_global_batch().items()}


def _init_state(out: str, name: str = "init.pt"):
    return torch.load(os.path.join(out, name), weights_only=True)


def run_steps(out: str, mesh=None, zero1: bool = False, steps: int = 1,
              narrow: bool = False) -> dict:
    """`steps` train steps of the tiny model from out/init.pt (with narrow,
    the NARROW_KW model from out/narrow.pt) on the global batches; on a
    process mesh each rank takes its 'data' rows. Returns the losses and
    grad norms, the full parameters and AdamW moments (gathered: every rank
    of a mesh must call this), this rank's moment bytes and the attention
    modules' head counts."""
    from thermal3d_torch.core.config import DustrModelConfig, TrainConfig
    from thermal3d_torch.core.mesh import full_state_dict, shard_batch, shard_model_
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.state import create_train_state
    from thermal3d_torch.train.step import make_train_step

    model = trainable_model(DustrModelConfig(**(NARROW_KW if narrow else TINY_KW)),
                            torch.device("cpu"),
                            _init_state(out, "narrow.pt" if narrow else "init.pt"))
    if mesh is not None:
        shard_model_(model, mesh)
    cfg = TrainConfig(batch_size=GLOBAL_BATCH, lr=STEP_LR, epochs=2, zero1=zero1)
    state = create_train_state(model, cfg, steps_per_epoch=10, mesh=mesh)
    step = make_train_step(model, cfg, mesh=mesh)
    losses, norms = [], []
    for s in range(steps):
        batch = _global_batch(s)
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        _, metrics = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                                  for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    opt = state.tx.full_state_dict()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return dict(losses=losses, norms=norms, params=full_state_dict(model, mesh),
                mu=dict(zip(names, opt["mu"])), nu=dict(zip(names, opt["nu"])),
                slot_bytes=sum(t.numel() * t.element_size()
                               for t in state.tx.mu + state.tx.nu),
                heads=sorted({m.num_heads for m in model.modules() if hasattr(m, "num_heads")}))


class SyntheticPairs:
    """n samples of the tiny model's training layout (identical in every
    process); with same=True all n are one sample, so the order of a
    batch's rows changes nothing. The samples of `fail` fail to load
    (None), as an undecodable frame does."""

    def __init__(self, n: int = 6, seed: int = 5, same: bool = False, fail=()):
        rng = np.random.default_rng(seed)
        base = make_global_batch()
        self.samples = [{k: (v[0 if same else i % GLOBAL_BATCH]
                             * (1.0 if same else rng.uniform(0.9, 1.1))).astype(np.float32)
                         for k, v in base.items()} for i in range(n)]
        self.fail = set(fail)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return None if i in self.fail else self.samples[i]


def failing_pairs() -> SyntheticPairs:
    """12 samples (8 train: two batches of 4 an epoch; 4 validation), the
    third row of the first epoch's first train batch failing to load: on 2
    ranks it lies in rank 1's slice."""
    from thermal3d_torch.data.pipeline import split_index

    train_idx, _ = split_index(12, 0.3, 0)
    return SyntheticPairs(n=12, fail=[np.random.default_rng(0).permutation(train_idx)[2]])


def run_loop(out: str, ckpt: str, epochs: int, zero1: bool, resume: bool = False,
             same: bool = False, fail: bool = False) -> dict:
    """train_and_evaluate of the tiny model from out/init.pt on
    SyntheticPairs(same=same), over the job's processes: 4 train samples,
    one batch of 4 an epoch; 2 validation samples, one batch padded to 4 (on
    2 ranks: rank 1's slice is all padding). With fail, on failing_pairs()."""
    from thermal3d_torch.core.config import DustrModelConfig, TrainConfig
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.logging import MetricLogger
    from thermal3d_torch.train.loop import train_and_evaluate

    model = trainable_model(DustrModelConfig(**TINY_KW), torch.device("cpu"), _init_state(out))
    # a constant lr (no warmup, the cosine's floor at lr): a run of 2 epochs
    # steps as the first 2 epochs of a run of 3 do
    cfg = TrainConfig(batch_size=4, lr=1e-3, eta_min=1e-3, warmup_frac=0.0, epochs=epochs,
                      zero1=zero1, log_interval=1, val_fraction=0.3)
    log = os.path.join(out, f"log_{os.environ.get('T3D_RANK', 'single')}_{epochs}.jsonl")
    data = failing_pairs() if fail else SyntheticPairs(same=same)
    summary = train_and_evaluate(model, data, cfg, checkpoint_dir=ckpt,
                                 logger=MetricLogger(log_file=log), resume=resume)
    from thermal3d_torch.core.mesh import full_state_dict

    return dict(summary=summary, params=full_state_dict(model, getattr(model, "tp_mesh", None)))


# --- the worker ---------------------------------------------------------------

def _worker(case: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from thermal3d_torch.core.collectives import STAGED
    from thermal3d_torch.core.distributed import initialize_multihost, process_info
    from thermal3d_torch.core.mesh import make_mesh

    torch.set_num_threads(1)
    os.environ["T3D_RANK"] = str(rank)
    assert initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
    assert process_info() == (rank, world)
    if case == "narrow4":  # every layout of FOUR_RANK_LAYOUTS, in turn
        result = {}
        for layout in FOUR_RANK_LAYOUTS:
            shape = tuple(int(x) for x in layout.split("_")[0].split("x"))
            mesh = make_mesh(shape, ("data", "model")[:len(shape)])
            result[layout] = run_steps(out, mesh, zero1="zero1" in layout, narrow=True)
    elif case.startswith("loop"):  # loop_<epochs>_<checkpoint dir>[_resume][_same][_fail]
        parts = case.split("_")
        result = run_loop(out, os.path.join(out, parts[2]), int(parts[1]), zero1=True,
                          resume="resume" in parts, same="same" in parts, fail="fail" in parts)
    else:  # <mesh, e.g. 2 or 2x2>_<steps>[_zero1]
        parts = case.split("_")
        shape = tuple(int(x) for x in parts[0].split("x"))
        mesh = make_mesh(shape, ("data", "model")[:len(shape)])
        result = run_steps(out, mesh, zero1="zero1" in parts, steps=int(parts[1]))
    result["staged"] = dict(STAGED)
    torch.save(result, os.path.join(out, f"{case}_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    sys.exit(0)


# --- the tests ----------------------------------------------------------------

import pytest  # noqa: E402

from tests import test_torch_common  # noqa: E402,F401  (threads, exp warm-up)
from tests.test_torch_train_data import tree  # noqa: E402,F401  (the Freiburg tree fixture)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_ranks(commands, timeout: int = TIMEOUT):
    """Start one process a command, wait for all within `timeout` seconds,
    kill every one of them on any failure; returns their stdouts."""
    procs = [subprocess.Popen(c, env=e, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c, e in commands]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def launch(case: str, world: int, out) -> list:
    """Run the worker's `case` on `world` gloo ranks; returns each rank's
    result."""
    port = free_port()
    run_ranks([([sys.executable, os.path.abspath(__file__), case, str(r), str(world), str(port),
                 str(out)], _env()) for r in range(world)])
    return [torch.load(os.path.join(out, f"{case}_{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """out/init.pt: the JAX tiny model's init params (key 0, as
    _multihost_worker.run_one_step draws them), converted once."""
    import jax

    from thermal3d.core.config import DustrModelConfig as JaxConfig
    from thermal3d.models.dustr import AsymmetricCroCo3DStereo
    from thermal3d_torch.convert.from_jax import state_dict_from_jax

    out = tmp_path_factory.mktemp("dist")
    img = np.zeros((1, 32, 32, 3), np.float32)
    params = AsymmetricCroCo3DStereo(JaxConfig(**TINY_KW)).init(
        jax.random.key(0), img, img)["params"]
    torch.save(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)),
               os.path.join(out, "init.pt"))
    return out


@pytest.fixture(scope="module")
def single(init):
    """The one-process references: 1 step, and 3 steps."""
    return {n: run_steps(str(init), steps=n) for n in (1, 3)}


def _close(got: dict, want: dict, atol: float, what: str) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


# after one step (measured on the CPU: DP and dp2×tp2 against one process):
# mu within 1.4e-9 absolute, the float32 sum of the ranks' gradients in
# another order (a mis-sharding, wrong scaling or a missing reduce would be
# off by O(|grad|) ~ 1e-1, the JAX test's argument at test_train.py:406);
# the parameters within 1.4e-5, where Adam's g / (sqrt(v) + eps) turns those
# ~1e-9 gradient differences on near-zero gradients into up to one
# lr-sized update; gated at 1e-7 and 1e-4 (a tenth of an lr=1e-3 update)
MU_ATOL_ONE_STEP = 1e-7
PARAMS_ATOL_ONE_STEP = 1e-4


def test_two_rank_dp_step_matches_one_process_and_jax(init, single, tmp_path):
    """2-rank DP: the loss equal on both ranks and within 2e-5 of the port's
    one-process step on the global batch and of the JAX 8-device DP step;
    the updated parameters and moments equal to the one-process step's
    within the envelope above, and bit-equal across the ranks."""
    import tests._multihost_worker as worker

    ranks = launch("2_1", 2, init)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    ref = single[1]
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=2e-5)
    np.testing.assert_allclose(ranks[0]["norms"], ref["norms"], rtol=2e-5)
    np.testing.assert_allclose(ranks[0]["losses"][0], worker.run_one_step(), rtol=2e-5)
    _close(ranks[0]["mu"], ref["mu"], MU_ATOL_ONE_STEP, "mu")
    _close(ranks[0]["params"], ref["params"], PARAMS_ATOL_ONE_STEP, "params")
    _close(ranks[1]["params"], ranks[0]["params"], 0, "rank 1 params")
    assert ranks[0]["staged"]["count"] == 0  # CPU tensors: no host staging


def test_dp2_tp2_step_matches_dp(init, single, tmp_path):
    """dp2 × tp2 over 4 ranks (the counterpart of tests/test_train.py:363):
    the loss and the gathered parameters and moments equal to the
    one-process step's within the envelope above."""
    ranks = launch("2x2_1", 4, init)
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    np.testing.assert_allclose(ranks[0]["losses"], single[1]["losses"], rtol=2e-5)
    np.testing.assert_allclose(ranks[0]["norms"], single[1]["norms"], rtol=2e-5)
    _close(ranks[0]["mu"], single[1]["mu"], MU_ATOL_ONE_STEP, "mu")
    _close(ranks[0]["params"], single[1]["params"], PARAMS_ATOL_ONE_STEP, "params")


@pytest.fixture(scope="module")
def narrow(init):
    """out/narrow.pt (the port's seeded NARROW_KW weights), its one-process
    step on the global batch, and one 4-rank job that runs the step in every
    layout of FOUR_RANK_LAYOUTS."""
    from thermal3d_torch.core.config import DustrModelConfig
    from thermal3d_torch.models.dustr import trainable_model

    model = trainable_model(DustrModelConfig(**NARROW_KW), torch.device("cpu"), seed=0)
    torch.save(model.state_dict(), init / "narrow.pt")
    return run_steps(str(init), narrow=True), launch("narrow4", 4, init)


@pytest.mark.parametrize("layout", FOUR_RANK_LAYOUTS)
def test_four_rank_layouts_match_one_process(narrow, layout):
    """DP 4, ZeRO-1 4, DP×TP 2×2 and TP 4 (one of the 4 heads a rank) on 4
    gloo ranks: the loss equal on every rank and within 2e-5 of the
    one-process step on the global batch, the gathered parameters and
    moments within the one-step envelope above, the heads a rank the
    mesh's share, and ZeRO-1's moments a quarter of the one-process bytes."""
    single, ranks = narrow
    got = [r[layout] for r in ranks]
    assert len({tuple(r["losses"]) for r in got}) == 1
    np.testing.assert_allclose(got[0]["losses"], single["losses"], rtol=2e-5)
    np.testing.assert_allclose(got[0]["norms"], single["norms"], rtol=2e-5)
    _close(got[0]["mu"], single["mu"], MU_ATOL_ONE_STEP, "mu")
    _close(got[0]["params"], single["params"], PARAMS_ATOL_ONE_STEP, "params")
    tp = int(layout.split("x")[1]) if "x" in layout else 1
    assert all(r["heads"] == [4 // tp] for r in got)
    full, mine = single["slot_bytes"], [r["slot_bytes"] for r in got]
    assert len(set(mine)) == 1
    if layout == "4_zero1":
        assert full / 4 <= mine[0] < 1.01 * full / 4
    elif tp > 1:  # split tensors: a tp-th; replicated ones (norms, embed, head): whole
        assert full / tp < mine[0] < full
    else:
        assert mine[0] == full


@pytest.mark.parametrize("case,world", [("2_3_zero1", 2), ("2x2_3_zero1", 4)])
def test_zero1_three_steps_match_dp(init, single, case, world):
    """ZeRO-1 after 3 steps (alone and composed with TP, the counterparts of
    tests/test_train.py:406 and :480): the losses of every step within 2e-5
    of the one-process run, the gathered parameters and moments within the
    envelope the JAX test sets (2e-4 absolute: reduction-order noise
    amplified by Adam through the steps), and each rank's moments half the
    one-process bytes (ZeRO-1 over 2 'data' ranks; tp2 halves them again)."""
    ranks = launch(case, world, init)
    ref = single[3]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=2e-5)
    _close(ranks[0]["params"], ref["params"], 2e-4, "params")
    _close(ranks[0]["mu"], ref["mu"], 2e-4, "mu")
    _close(ranks[0]["nu"], ref["nu"], 2e-4, "nu")
    full, got = ref["slot_bytes"], [r["slot_bytes"] for r in ranks]
    assert len(set(got)) == 1, got
    if world == 2:  # every tensor of the tiny model has an even axis
        assert got[0] == full / 2
    else:  # split tensors: a quarter; replicated ones (norms, embed, head): a half
        assert full / 4 < got[0] < full / 2


def _ckpt_params(ckpt):
    from thermal3d_torch.train.checkpoint import load_params_from_checkpoint_dir

    return load_params_from_checkpoint_dir(str(ckpt))


def test_two_rank_loop_agrees_and_logs_once(init):
    """A 2-rank --zero1 train_and_evaluate: both ranks return the same
    summary, its validation loss is the one-process loop's (the padded
    remainder counted once: rank 1's slice of the 2 validation samples is
    all padding and still joins the all-reduce), and only the coordinator
    logs."""
    ranks = launch("loop_2_ck", 2, init)
    assert ranks[0]["summary"] == ranks[1]["summary"]
    assert ranks[0]["summary"]["epochs_run"] == 2 and ranks[0]["summary"]["final_step"] == 2
    one = run_loop(str(init), str(init / "ck_single"), 2, zero1=True)
    np.testing.assert_allclose(ranks[0]["summary"]["best_val_loss"],
                               one["summary"]["best_val_loss"], rtol=1e-5)
    _close(ranks[0]["params"], one["params"], 2e-4, "params")
    assert os.path.getsize(init / "log_0_2.jsonl") > 0
    assert os.path.getsize(init / "log_1_2.jsonl") == 0


def test_a_batch_one_rank_cannot_fill_is_skipped_by_every_rank(init):
    """A train sample that fails to load lies in rank 1's slice of the first
    global batch: both ranks skip that batch, as one process skips the short
    batch, and train on the second, so the 2-rank run equals the
    one-process run (one step). Without the vote rank 1 alone skipped it,
    and its gradient all-reduce paired with rank 0's step on the first
    batch: a step no process takes."""
    ranks = launch("loop_1_ckfail_fail", 2, init)
    one = run_loop(str(init), str(init / "ckfail_single"), 1, zero1=True, fail=True)
    assert ranks[0]["summary"] == ranks[1]["summary"]
    assert ranks[0]["summary"]["final_step"] == one["summary"]["final_step"] == 1
    np.testing.assert_allclose(ranks[0]["summary"]["best_val_loss"],
                               one["summary"]["best_val_loss"], rtol=1e-5)
    _close(ranks[0]["params"], one["params"], 2e-4, "params")


def test_zero1_checkpoint_resumes_on_any_world_size(init):
    """A 2-rank --zero1 run checkpointed after 2 epochs, resumed to a third
    in 2 processes and in 1 process, against the uninterrupted 2-rank run
    of 3 epochs (the counterpart of tests/test_train.py:271). The samples
    are one sample repeated, so the resumed loaders' restarted shuffle
    feeds the same rows: in 2 processes the resumed run is bit-equal to the
    uninterrupted one; in 1 process it differs only by the order of its
    gradient sums, within the one-step envelope. The checkpoint holds full
    tensors: a one-device model's state dict."""
    import shutil

    straight = launch("loop_3_straight_same", 2, init)[0]
    launch("loop_2_split_same", 2, init)
    shutil.copytree(init / "split", init / "split_single")
    resumed2 = launch("loop_3_split_resume_same", 2, init)[0]
    resumed1 = run_loop(str(init), str(init / "split_single"), 3, zero1=True, resume=True,
                        same=True)
    for got in (resumed2, resumed1):
        assert got["summary"]["epochs_run"] == 3 and got["summary"]["final_step"] == 3
    _close(resumed2["params"], straight["params"], 0, "params, resumed on 2")
    _close(resumed1["params"], straight["params"], PARAMS_ATOL_ONE_STEP, "params, resumed on 1")
    sd, meta = _ckpt_params(init / "split")
    assert meta["epoch"] == 3
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in straight["params"].items()}


def test_cli_train_mesh_shape_2_on_two_gloo_processes(tree, tmp_path):
    """cli.train --mesh_shape 2 launched as torchrun launches it (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): gloo on the CPU,
    the summary printed by the coordinator only, and its best validation
    loss the one-process run's; its checkpoint serves one-device cli.infer."""
    _cli_train_job(tree, tmp_path, "env", 2)


@pytest.mark.parametrize("launcher", ["multihost", "torchrun"])
def test_cli_train_on_four_gloo_processes(tree, tmp_path, launcher):
    """cli.train --mesh_shape 4 --zero1 on 4 gloo processes, one launch a
    process with --multihost --coordinator --num_processes 4 --process_id R,
    or under torchrun itself (python -m torch.distributed.run, whose agent
    hosts the rendezvous store the tcp:// init joins): as the two-process
    case, against the one-process run on the same batch of 4 (one row a
    rank; ranks 1-3 see only padding in validation)."""
    _cli_train_job(tree, tmp_path, launcher, 4)


def _cli_train_job(tree, tmp_path, launcher: str, world: int):
    from tests.test_torch_train_data import _train_args
    from thermal3d_torch.cli import train as cli_train

    port = free_port()
    out = str(tmp_path / f"ck{world}")
    batch = ["--batch_size", str(max(2, world))]
    argv = _train_args(tree, out, "--epochs", "1", "--lr", "1e-4", *batch,
                       "--mesh_shape", str(world), *(["--zero1"] if world > 2 else []))
    module = [sys.executable, "-m", "thermal3d_torch.cli.train"]
    if launcher == "torchrun":
        commands = [([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                      str(world), "--master_addr", "127.0.0.1", "--master_port", str(port),
                      "-m", "thermal3d_torch.cli.train", *argv], _env())]
    elif launcher == "multihost":
        commands = [([*module, *argv, "--multihost", "--coordinator", f"127.0.0.1:{port}",
                      "--num_processes", str(world), "--process_id", str(r)], _env())
                    for r in range(world)]
    else:
        commands = [([*module, *argv], dict(_env(), RANK=str(r), WORLD_SIZE=str(world),
                                            LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                                            MASTER_PORT=str(port)))
                    for r in range(world)]
    outs = run_ranks(commands)
    text = "\n".join(outs)
    done = [line for line in text.splitlines() if line.startswith("Training done")]
    assert len(done) == 1 and "Training done" in outs[0]
    assert f"gloo, world {world}" in outs[0]
    for other in outs[1:]:  # no metric lines from the other ranks
        assert not [x for x in other.splitlines() if x.startswith("{")]
    one = cli_train.main(_train_args(tree, str(tmp_path / "ck1"), "--epochs", "1",
                                     "--lr", "1e-4", *batch))
    got = eval(done[0].split(": ", 1)[1], {"inf": float("inf")})
    assert got["final_step"] == one["final_step"] and got["epochs_run"] == 1
    np.testing.assert_allclose(got["best_val_loss"], one["best_val_loss"], rtol=1e-5)
    sd, _ = _ckpt_params(out)
    sd1, _ = _ckpt_params(tmp_path / "ck1")
    _close(sd, sd1, 2e-4, "checkpoint")
    # the multi-process checkpoint is a one-device model's: cli.infer serves it
    from tests.test_torch_train_data import STAMPS
    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.core.config import DustrModelConfig
    from thermal3d_torch.infer.engine import InferenceEngine

    frame = os.path.join(tree["ds"], "train", "seq_00_day", "00", "fl_ir_aligned",
                         f"fl_ir_aligned_{STAMPS[0]}.png")
    cli_infer.main(["--img_path", frame, "--output_dir", str(tmp_path / "inf"), "--weights", out,
                    "--model_preset", "tiny", "--img_size", "32", "32", "--compute_dtype",
                    "float32", "--no_vis", "--device", "cpu"])
    ref = InferenceEngine(DustrModelConfig(**TINY_KW), state_dict=sd, device="cpu").infer_paths(
        [frame], outputs=("depth",))["depth"][0]
    np.testing.assert_array_equal(np.load(tmp_path / "inf" / f"fl_ir_aligned_{STAMPS[0]}_depth.npy"),
                                  ref)

