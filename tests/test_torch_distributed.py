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


# --- shared by the ranks and the one-process references ---------------------

def _global_batch(step: int):
    """make_global_batch() for step 0; later steps scale its rows."""
    return {k: v * np.float32(1.0 + 0.05 * step) if k.startswith(("thermal", "pointmap"))
            else v for k, v in make_global_batch().items()}


def _init_state(out: str):
    return torch.load(os.path.join(out, "init.pt"), weights_only=True)


def run_steps(out: str, mesh=None, zero1: bool = False, steps: int = 1) -> dict:
    """`steps` train steps of the tiny model from out/init.pt on the global
    batches; on a process mesh each rank takes its 'data' rows. Returns the
    losses and grad norms, the full parameters and AdamW moments (gathered:
    every rank of a mesh must call this), and this rank's moment bytes."""
    from thermal3d_torch.core.config import DustrModelConfig, TrainConfig
    from thermal3d_torch.core.mesh import full_state_dict, shard_batch, shard_model_
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.state import create_train_state
    from thermal3d_torch.train.step import make_train_step

    model = trainable_model(DustrModelConfig(**TINY_KW), torch.device("cpu"), _init_state(out))
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
                               for t in state.tx.mu + state.tx.nu))


class SyntheticPairs:
    """n samples of the tiny model's training layout (identical in every
    process); with same=True all n are one sample, so the order of a
    batch's rows changes nothing."""

    def __init__(self, n: int = 6, seed: int = 5, same: bool = False):
        rng = np.random.default_rng(seed)
        base = make_global_batch()
        self.samples = [{k: (v[0 if same else i % GLOBAL_BATCH]
                             * (1.0 if same else rng.uniform(0.9, 1.1))).astype(np.float32)
                         for k, v in base.items()} for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def run_loop(out: str, ckpt: str, epochs: int, zero1: bool, resume: bool = False,
             same: bool = False) -> dict:
    """train_and_evaluate of the tiny model from out/init.pt on
    SyntheticPairs(same=same), over the job's processes: 4 train samples,
    one batch of 4 an epoch; 2 validation samples, one batch padded to 4 (on
    2 ranks: rank 1's slice is all padding)."""
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
    summary = train_and_evaluate(model, SyntheticPairs(same=same), cfg, checkpoint_dir=ckpt,
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
    if case.startswith("loop"):  # loop_<epochs>_<checkpoint dir>[_resume][_same]
        parts = case.split("_")
        result = run_loop(out, os.path.join(out, parts[2]), int(parts[1]), zero1=True,
                          resume="resume" in parts, same="same" in parts)
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
    from tests.test_torch_train_data import _train_args
    from thermal3d_torch.cli import train as cli_train

    port = free_port()
    out = str(tmp_path / "ck2")
    argv = _train_args(tree, out, "--epochs", "1", "--mesh_shape", "2", "--lr", "1e-4")
    commands = []
    for r in range(2):
        env = dict(_env(), RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        commands.append(([sys.executable, "-m", "thermal3d_torch.cli.train", *argv], env))
    outs = run_ranks(commands)
    done = [line for line in outs[0].splitlines() if line.startswith("Training done")]
    assert len(done) == 1 and "Training done" not in outs[1]
    assert not [x for x in outs[1].splitlines() if x.startswith("{")]  # no metric lines
    one = cli_train.main(_train_args(tree, str(tmp_path / "ck1"), "--epochs", "1",
                                     "--lr", "1e-4"))
    got = eval(done[0].split(": ", 1)[1], {"inf": float("inf")})
    assert got["final_step"] == one["final_step"] and got["epochs_run"] == 1
    np.testing.assert_allclose(got["best_val_loss"], one["best_val_loss"], rtol=1e-5)
    sd, _ = _ckpt_params(out)
    sd1, _ = _ckpt_params(tmp_path / "ck1")
    _close(sd, sd1, 2e-4, "checkpoint")
    # the 2-process checkpoint is a one-device model's: cli.infer serves it
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

