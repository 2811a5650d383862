"""The port's meshes and the single-controller data-parallel paths
(thermal3d_torch/core/{mesh,distributed}.py, the mesh engine and generator,
evaluate_test_set on a mesh, --ndev of the CLIs and the bench, the process
slicing of BatchLoader) against the JAX package on the 8-device CPU mesh of
tests/conftest.py. A port mesh over the CPU repeats the one CPU device
(`[cpu] * 8`): every position shares one replica, and the batch is split
as the JAX mesh splits it. A mesh over `cpu` and `cpu:0`, two devices that
compare unequal, takes the path of a host with several cards: a replica and
a thread each."""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_common import PROD_DEPTH1_KW, TINY_KW, configs, torch_state
from tests.test_torch_files import (BATCH, CLI_TINY, _close, _compare_trees, _engines,
                                    data)  # noqa: F401  (the data fixture)
from thermal3d.core import mesh as jax_mesh
from thermal3d_torch.core import mesh as tmesh
from thermal3d_torch.core.mesh import make_mesh

CPU8 = ["cpu"] * 8


def _jax_mesh(shape, axes, n=8):
    return jax_mesh.make_mesh(shape, axes, devices=jax.devices("cpu")[:n])


# --- make_mesh ----------------------------------------------------------------

@pytest.mark.parametrize("n,shape,axes", [
    (8, (-1,), ("data",)), (8, (-1, 2), ("data", "model")), (8, (2, -1), ("data", "model")),
    (4, (2, 2), ("data", "model")), (2, (1, -1), ("data", "model")), (1, (-1,), ("data",)),
])
def test_make_mesh_shapes_match_jax(n, shape, axes):
    got = make_mesh(shape, axes, devices=["cpu"] * n)
    want = _jax_mesh(shape, axes, n)
    assert got.shape == dict(want.shape) and got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names) and not got.over_processes
    assert got.size == n and got.data_devices() == [torch.device("cpu")] * got.shape["data"]


def test_make_mesh_refuses_what_jax_refuses():
    for shape in ((3,), (3, -1)):
        with pytest.raises(ValueError):
            _jax_mesh(shape, ("data", "model")[:len(shape)])
        with pytest.raises(ValueError):
            make_mesh(shape, ("data", "model")[:len(shape)], devices=CPU8)


def test_make_mesh_without_cuda_raises(monkeypatch):
    """devices=None and no process group means this host's cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_local_batch_size_and_shard_batch_match_jax():
    got, want = make_mesh((4, 2), ("data", "model"), devices=CPU8), _jax_mesh((4, 2),
                                                                            ("data", "model"))
    assert tmesh.local_batch_size(got, 8) == jax_mesh.local_batch_size(want, 8) == 2
    for m, fn in ((got, tmesh.local_batch_size), (want, jax_mesh.local_batch_size)):
        with pytest.raises(ValueError, match="global batch size 6 not divisible by "
                                             "data-parallel size 4"):
            fn(m, 6)
    x = np.arange(8 * 3).reshape(8, 3)
    parts = [tmesh.shard_batch(got, {"x": x}, i)["x"] for i in range(4)]
    placed = jax_mesh.shard_batch(want, {"x": x})["x"]
    for shard in placed.addressable_shards:
        i = list(want.devices.reshape(-1)).index(shard.device) // 2
        np.testing.assert_array_equal(parts[i], np.asarray(shard.data))


# --- the sharding rules ------------------------------------------------------------

def test_param_partition_spec_rules():
    """The rule table of tests/test_train.py:503, on the port's keys and
    torch's [out, in] layout."""
    mesh = make_mesh((-1, 2), ("data", "model"), devices=CPU8)
    cases = [
        ("enc_blocks.0.attn.qkv.weight", 2, ("model", None)),
        ("enc_blocks.0.attn.qkv.bias", 1, ("model",)),
        ("enc_blocks.0.attn.proj.weight", 2, (None, "model")),
        ("enc_blocks.0.attn.proj.bias", 1, ()),
        ("dec_blocks.1.cross_attn.projk.weight", 2, ("model", None)),
        ("dec_blocks2.1.cross_attn.proj.weight", 2, (None, "model")),
        ("enc_blocks.0.mlp.fc1.weight", 2, ("model", None)),
        ("enc_blocks.0.mlp.fc2.weight", 2, (None, "model")),
        ("enc_blocks.0.norm1.weight", 1, ()),
        ("patch_embed.proj.weight", 4, ()),
        ("downstream_head1.proj.weight", 2, ()),
        ("decoder_embed.weight", 2, ()),
    ]
    for name, ndim, want in cases:
        assert tmesh.param_partition_spec(name, ndim, mesh) == want, name
    dp = make_mesh((-1,), ("data",), devices=CPU8)
    assert tmesh.param_partition_spec("enc_blocks.0.attn.qkv.weight", 2, dp) == ()


def _flax_to_torch_axes(ndim: int):
    """torch axis i holds the JAX kernel's axis perm[i] (Dense [in, out] →
    [out, in]; conv HWIO → OIHW)."""
    return {2: (1, 0), 4: (3, 2, 0, 1)}.get(ndim, tuple(range(ndim)))


def _torch_key_and_shape(path, shape):
    """The port's state_dict key and shape of a Flax param leaf of `shape`."""
    from thermal3d_torch.convert.from_jax import _key_and_value

    names = [str(getattr(p, "key", getattr(p, "name", p))) for p in path]
    fake = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape, (0,) * len(shape))
    key, value = _key_and_value(names[:-1], names[-1], fake)
    return key, tuple(value.shape)


def _shard_shape(shape, spec, mesh):
    """The per-position shape of a tensor of `shape` under a port spec."""
    return tuple(d // mesh.shape[a] if a is not None else d
                 for d, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


@pytest.fixture(scope="module")
def jax_states():
    """Abstract JAX TrainStates (shapes only, jax.eval_shape) of the tiny
    model and of full-width, full-depth DUSt3R-224."""
    from thermal3d.core.config import DUSTR_224_LINEAR, TrainConfig
    from thermal3d.models.dustr import AsymmetricCroCo3DStereo
    from thermal3d.train.state import create_train_state

    out = {}
    for name, cfg in (("tiny", configs(**TINY_KW)[0]), ("dustr224", DUSTR_224_LINEAR)):
        model = AsymmetricCroCo3DStereo(cfg)
        h, w = cfg.img_size
        img = jax.ShapeDtypeStruct((1, h, w, 3), np.float32)
        params = jax.eval_shape(lambda a, b: model.init(jax.random.key(0), a, b)["params"],
                                img, img)
        out[name] = jax.eval_shape(lambda p: create_train_state(model, p, TrainConfig(), 10),
                                   params)
    return out


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("shape,axes", [((8,), ("data",)), ((4, 2), ("data", "model")),
                                        ((2, 2), ("data", "model")),
                                        ((1, 4), ("data", "model"))])
@pytest.mark.parametrize("model", ["tiny", "dustr224"])
def test_state_sharding_matches_jax(jax_states, model, shape, axes, zero1):
    """For every parameter and both AdamW moments: the port's spec is JAX's
    state_sharding spec on the same mesh, in the torch layout, and its
    per-rank slice shape is JAX's NamedSharding.shard_shape, transposed;
    on 8 devices and on the 4-rank layouts of the multi-device phase (DP×TP
    2×2, TP 4: 4 of DUSt3R-224's 16 encoder and 3 of its 12 decoder heads a
    rank)."""
    state = jax_states[model]
    n = int(np.prod(shape))
    jm = _jax_mesh(shape, axes, n)
    sh = jax_mesh.state_sharding(jm, state, zero1=zero1)
    tm = make_mesh(shape, axes, devices=CPU8[:n])
    adam_sh, adam = sh.opt_state[1][0], state.opt_state[1][0]
    trees = {"params": (sh.params, state.params), "mu": (adam_sh.mu, adam.mu),
             "nu": (adam_sh.nu, adam.nu)}
    shapes, want_spec, want_shard = {}, {}, {}
    for slot, (shardings, leaves) in trees.items():
        flat_sh = jax.tree_util.tree_flatten_with_path(shardings)[0]
        flat_leaves = jax.tree_util.tree_leaves(leaves)
        assert len(flat_sh) == len(flat_leaves)
        for (path, ns), leaf in zip(flat_sh, flat_leaves):
            key, tshape = _torch_key_and_shape(path, leaf.shape)
            key_, tshard = _torch_key_and_shape(path, ns.shard_shape(leaf.shape))
            assert key == key_
            perm = _flax_to_torch_axes(len(leaf.shape))
            spec = tuple(ns.spec) + (None,) * (len(leaf.shape) - len(ns.spec))
            shapes[key] = tshape
            want_spec[slot, key] = tuple(spec[a] for a in perm)
            want_shard[slot, key] = tshard
    got = tmesh.state_sharding(tm, shapes, zero1=zero1, slots=("mu", "nu"))
    n_sharded = 0
    for (slot, key), spec in want_spec.items():
        mine = got[slot][key] + (None,) * (len(shapes[key]) - len(got[slot][key]))
        assert mine == spec, (slot, key)
        assert _shard_shape(shapes[key], got[slot][key], tm) == want_shard[slot, key]
        n_sharded += any(mine)
    assert len(want_spec) == 3 * len(shapes) > 30
    assert (n_sharded > 0) == ("model" in axes or zero1)


def test_split_and_join_by_heads():
    """The packed qkv weight [3C, C] splits by heads within each of q, k, v
    (the rows of q heads [r·H/tp, (r+1)·H/tp), then k's, then v's), and the
    parts join back to the whole."""
    c, tp = 8, 2
    w = torch.arange(3 * c * 2, dtype=torch.float32).reshape(3 * c, 2)
    parts = [tmesh.split_tensor(w, 0, tp, r, pack=3) for r in range(tp)]
    assert parts[0].is_contiguous() and parts[0].shape == (3 * c // tp, 2)
    want0 = torch.cat([w[0:4], w[8:12], w[16:20]])
    assert torch.equal(parts[0], want0)
    assert torch.equal(tmesh.join_tensors(parts, 0, pack=3), w)
    assert tmesh.tp_pack("enc_blocks.3.attn.qkv.bias") == 3
    assert tmesh.tp_pack("dec_blocks.0.cross_attn.projq.weight") == 1


def test_shard_model_needs_tp_to_divide_both_head_counts():
    from thermal3d_torch.models.dustr import trainable_model

    _, tcfg = configs(**dict(TINY_KW, enc_num_heads=4, dec_num_heads=3, dec_embed_dim=48))
    model = trainable_model(tcfg, torch.device("cpu"), seed=0)
    with pytest.raises(ValueError, match="enc_num_heads=4, dec_num_heads=3"):
        tmesh.shard_model_(model, make_mesh((4, 2), ("data", "model"), devices=CPU8))


# --- the loader's process slices -----------------------------------------------------

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i]), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("pid,pcount", [(0, 2), (1, 2), (0, 4), (3, 4)])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batch_loader_process_slices_match_jax(pid, pcount, shuffle, drop_last):
    """Each process's batches and local_real_count equal the JAX loader's:
    17 indices in global batches of 8 (with drop_last=False a last batch of
    1 real row, padded in every process's slice)."""
    from thermal3d.data.pipeline import BatchLoader as JaxBatchLoader
    from thermal3d_torch.data.pipeline import BatchLoader

    kw = dict(batch_size=8, shuffle=shuffle, seed=2, drop_last=drop_last, num_workers=2,
              process_id=pid, process_count=pcount)
    ours, ref = BatchLoader(_Indexed(20), np.arange(3, 20), **kw), JaxBatchLoader(
        _Indexed(20), np.arange(3, 20), **kw)
    assert len(ours) == len(ref)
    assert [ours.local_real_count(b) for b in range(len(ours))] == \
        [ref.local_real_count(b) for b in range(len(ref))]
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["i"].shape[0] == 8 // pcount
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_batch_loader_process_errors_match_jax():
    from thermal3d.data.pipeline import BatchLoader as JaxBatchLoader
    from thermal3d_torch.data.pipeline import BatchLoader

    for kw, text in ((dict(batch_size=6, process_id=0, process_count=4), "divisible"),
                     (dict(batch_size=8, process_id=4, process_count=4), "out of range")):
        msgs = []
        for cls in (BatchLoader, JaxBatchLoader):
            with pytest.raises(ValueError, match=text) as e:
                cls(_Indexed(8), **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# --- initialize_multihost ------------------------------------------------------------

def _spy_init(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    for name in ("THERMAL3D_COORDINATOR", "THERMAL3D_NUM_PROCESSES", "THERMAL3D_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    return calls


def test_initialize_multihost_env_fallback(monkeypatch):
    """The THERMAL3D_* variables feed init_process_group when the arguments
    are omitted (the JAX package's launch pattern, tests/test_multihost.py),
    gloo on the CPU."""
    from thermal3d_torch.core import distributed

    calls = _spy_init(monkeypatch)
    monkeypatch.setenv("THERMAL3D_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("THERMAL3D_NUM_PROCESSES", "4")
    monkeypatch.setenv("THERMAL3D_PROCESS_ID", "2")
    monkeypatch.setenv("WORLD_SIZE", "9")  # the THERMAL3D_ variables come first
    assert distributed.initialize_multihost(device="cpu") == (0, 1)  # no group is up
    assert calls == [(("gloo",), dict(init_method="tcp://10.0.0.1:8476", world_size=4,
                                      rank=2))]
    assert distributed.process_device() == torch.device("cpu")


def test_initialize_multihost_torchrun_fallback(monkeypatch):
    from thermal3d_torch.core import distributed

    calls = _spy_init(monkeypatch)
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29511"), ("WORLD_SIZE", "2"),
                 ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    distributed.initialize_multihost(device="cpu")
    assert calls == [(("gloo",), dict(init_method="tcp://127.0.0.1:29511", world_size=2,
                                      rank=1))]
    # explicit arguments win over the environment
    distributed.initialize_multihost("h:1", 3, 0, device="cpu")
    assert calls[-1][1] == dict(init_method="tcp://h:1", world_size=3, rank=0)


def test_initialize_multihost_refuses(monkeypatch):
    from thermal3d_torch.core import distributed

    calls = _spy_init(monkeypatch)
    with pytest.raises(ValueError, match="THERMAL3D_COORDINATOR"):
        distributed.initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        distributed.initialize_multihost("h:1", 1, 0, device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize_multihost("h:1", 1, 0)
    assert calls == []
    assert distributed.process_info() == (0, 1) and distributed.is_coordinator()


# --- data-parallel serving and pseudo-GT -----------------------------------------------

def _assert_close(got, want, rtol=1e-4):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=rtol * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("kw", [TINY_KW, PROD_DEPTH1_KW])
def test_engine_mesh_matches_single_and_jax(kw):
    """infer() over [cpu]*8 against the port without a mesh and against the
    JAX engine over its 8-device mesh, rtol 1e-4 as tests/test_engine.py:101
    (the per-chunk GEMMs block differently from the whole batch's);
    infer_async's tensors on the mesh's first device; an indivisible batch
    raises the JAX engine's ValueError."""
    from tests.test_torch_common import jax_model_params, thermal_head_params
    from thermal3d.infer.engine import InferenceEngine as JaxEngine
    from thermal3d_torch.convert.from_jax import thermal_head_state_from_jax
    from thermal3d_torch.infer.engine import InferenceEngine

    jcfg, tcfg = configs(**kw)
    params, thp = jax_model_params(jcfg, 3), thermal_head_params()
    sd, hs = torch_state(params), thermal_head_state_from_jax(thp)
    single = InferenceEngine(tcfg, state_dict=sd, thermal_head_state=hs, device="cpu")
    mesh = make_mesh((8,), ("data",), devices=CPU8)
    meshed = InferenceEngine(tcfg, state_dict=sd, thermal_head_state=hs, device="cpu",
                             mesh=mesh)
    jeng = JaxEngine(jcfg, params=params, thermal_head_params=thp, mesh=_jax_mesh((8,),
                                                                                  ("data",)))
    rng = np.random.default_rng(0)
    raw = (rng.uniform(21000, 26000, (8, 48, 64)) / 65535.0).astype(np.float32)
    got = meshed.infer(raw)
    _assert_close(got, single.infer(raw))
    _assert_close(got, {k: np.asarray(v) for k, v in jeng.infer(raw).items()})
    assert meshed.infer_async(raw)["depth"].device == torch.device("cpu")
    msgs = []
    for eng in (meshed, jeng):
        with pytest.raises(ValueError) as e:
            eng.infer(raw[:6])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "batch size 6 not divisible by the mesh's data-parallel size 8"


def test_generator_mesh_matches_single_and_jax(data, tmp_path):
    """run_pairs over [cpu]*8 against the port without a mesh and against the
    JAX generator over its 8-device mesh; generate_pseudo_gt and the test-set
    writer on the mesh write the single-device files."""
    from tests.test_torch_files import _mastr_generators
    from thermal3d.pseudo_gt.generator import PseudoGTGenerator as JaxGenerator
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator, generate_pseudo_gt
    from thermal3d_torch.pseudo_gt.test_set import generate_test_set_pseudo_gt

    _, single = _mastr_generators(data, batch_size=8)
    cfg = single.config
    mesh = make_mesh((8,), ("data",), devices=CPU8)
    meshed = PseudoGTGenerator(cfg, state_dict=single.model.state_dict(), batch_size=8,
                               device="cpu", mesh=mesh)
    jgen = JaxGenerator(data["mastr_jcfg"], params=data["mastr_params"], batch_size=8,
                        mesh=_jax_mesh((8,), ("data",)))
    rng = np.random.default_rng(1)
    rgb1, rgb2 = (rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32) for _ in range(2))
    got = meshed.run_pairs(rgb1, rgb2)
    _assert_close(got, single.run_pairs(rgb1, rgb2))
    _assert_close(got, jgen.run_pairs(rgb1, rgb2))
    with pytest.raises(ValueError, match="not divisible by the mesh's data-parallel size"):
        meshed.run_pairs(rgb1[:4], rgb2[:4])

    from thermal3d_torch.data.freiburg import build_rgb_pair_index, build_rgb_thermal_index

    pairs = build_rgb_pair_index(data["ds"], frame_skip=1)
    for gen, sub in ((single, "s"), (meshed, "m")):
        assert generate_pseudo_gt(pairs, str(tmp_path / sub), gen) == 4
        assert generate_test_set_pseudo_gt(build_rgb_thermal_index(data["ds"]),
                                           str(tmp_path / f"{sub}_test"), gen) == 5
    _compare_trees(str(tmp_path / "m"), str(tmp_path / "s"))
    _compare_trees(str(tmp_path / "m_test"), str(tmp_path / "s_test"))


def test_evaluate_test_set_on_a_mesh_matches(data, tmp_path):
    """evaluate_test_set on an engine over [cpu]*8 (through infer_paths, the
    6 frames padded to a batch of 8, a multiple of the mesh) against the port
    without a mesh and the JAX evaluator on an 8-device mesh engine
    (tests/test_pseudo_gt.py:187)."""
    from thermal3d.evaluation.evaluator import evaluate_test_set as jax_evaluate
    from thermal3d.infer.engine import InferenceEngine as JaxEngine
    from thermal3d_torch.evaluation.evaluator import evaluate_test_set
    from thermal3d_torch.infer.engine import InferenceEngine

    jeng, single = _engines(data)
    meshed = InferenceEngine(single.config, state_dict=single.model.state_dict(),
                             thermal_head_state=single.thermal_head.state_dict(), device="cpu",
                             mesh=make_mesh((8,), ("data",), devices=CPU8))
    jmesh = JaxEngine(jeng.config, params=jeng.params, thermal_head_params=jeng.thermal_head_params,
                      mesh=_jax_mesh((8,), ("data",)))
    kw = dict(save_visualizations=False, batch_size=8)
    got = evaluate_test_set(meshed, data["paths"], data["gt"], str(tmp_path / "m"), **kw)
    want = evaluate_test_set(single, data["paths"], data["gt"], str(tmp_path / "s"), **kw)
    ref = jax_evaluate(jmesh, data["paths"], data["gt"], str(tmp_path / "j"), **kw)
    assert got["n_images"] == want["n_images"] == ref["n_images"] == 6
    for k in ref:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        evaluate_test_set(meshed, data["paths"], data["gt"], batch_size=3,
                          save_visualizations=False)


# --- several distinct devices: a replica and a thread each --------------------------------

# torch.device("cpu") != torch.device("cpu", 0): two devices to run_on_mesh
CPU_PAIR = [torch.device("cpu"), torch.device("cpu", 0)]


def test_run_on_mesh_runs_a_thread_a_distinct_device():
    """Over [cpu, cpu:0, cpu, cpu:0] each device's chunks run on a thread of
    their own (both threads are live at once: a barrier that one thread alone
    could not pass), in position order, and come back in position order on
    the first device; launches counted from both threads add up."""
    import threading

    from thermal3d_torch.core.mesh import run_on_mesh
    from thermal3d_torch.kernels._build import count_launch

    class Wrapper:
        launches = 0

    positions, per, n_counts = CPU_PAIR * 2, 2, 20000
    barrier = threading.Barrier(2, timeout=20)
    ran = []

    def chunk(device, rows):
        i = rows.start // per
        ran.append((device, i, threading.get_ident()))
        if i < 2:  # the first chunk of each device
            barrier.wait()
        for _ in range(n_counts):
            count_launch(Wrapper)
        return {"rows": torch.arange(rows.start, rows.stop, device=device),
                "device": torch.full((per,), float(positions.index(device)), device=device)}

    out = run_on_mesh(positions, per * len(positions), chunk)
    assert torch.equal(out["rows"], torch.arange(8))
    assert out["device"].tolist() == [0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0]
    assert out["rows"].device == positions[0]
    assert Wrapper.launches == n_counts * len(positions)
    threads = {d: {t for dev, _, t in ran if dev == d} for d in CPU_PAIR}
    assert all(len(t) == 1 for t in threads.values())
    assert len(threads[CPU_PAIR[0]] | threads[CPU_PAIR[1]]) == 2
    assert threading.get_ident() not in threads[CPU_PAIR[0]] | threads[CPU_PAIR[1]]
    for d in CPU_PAIR:
        assert [i for dev, i, _ in ran if dev == d] == [positions.index(d), positions.index(d) + 2]


def test_run_on_mesh_chunks_run_on_the_callers_streams(monkeypatch):
    """On a mesh of distinct cards each chunk's thread takes the caller's
    current stream of every card of the mesh, not its own default stream:
    a chunk that copies its rows from an input still being staged on the
    caller's stream of cuda:0, and the gather and fetch the caller queues
    after, stay ordered with it. torch.cuda's stream and device calls are
    stood in with per-thread recorders (no card here)."""
    import threading

    from thermal3d_torch.core.mesh import run_on_mesh

    class Stream:
        def __init__(self, device, name):
            self.device, self.name = torch.device(device), name

    local = threading.local()

    def current(device=None):
        d = torch.device(device)
        return getattr(local, "streams", {}).get(d, Stream(d, "default"))

    class use:  # torch.cuda.stream(s): s current on its card in this thread
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            streams = getattr(local, "streams", {})
            self.prev, local.streams = dict(streams), {**streams, self.stream.device: self.stream}

        def __exit__(self, *exc):
            local.streams = self.prev

    monkeypatch.setattr(torch.cuda, "current_stream", current)
    monkeypatch.setattr(torch.cuda, "stream", use)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    positions = [torch.device("cuda", 0), torch.device("cuda", 1)]
    seen = {}

    def chunk(device, rows):
        seen[device] = ({d: current(d).name for d in positions}, threading.get_ident())
        return {}

    import contextlib

    with use(Stream("cuda:0", "staging")):
        run_on_mesh(positions, 4, chunk)
    want = {positions[0]: "staging", positions[1]: "default"}
    assert {d: names for d, (names, _) in seen.items()} == {d: want for d in positions}
    assert threading.get_ident() not in {t for _, t in seen.values()}


def _by_chunks(run, n, *arrays):
    """run() on each of n equal row chunks of the arrays, concatenated."""
    per = arrays[0].shape[0] // n
    parts = [run(*(a[i * per:(i + 1) * per] for a in arrays)) for i in range(n)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("path", ["engine", "generator"])
def test_mesh_over_distinct_devices_is_bit_equal(path, data):
    """The engine and the generator over [cpu, cpu:0, cpu, cpu:0] (a replica
    on each device, a thread each) against the single-device object run on
    the same four chunks, and against the mesh over one device ([cpu] * 4,
    the calling thread): bit-equal; the second replica is a copy of its own."""
    from tests.test_torch_files import _mastr_generators
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    rng = np.random.default_rng(2)
    if path == "engine":
        _, single = _engines(data)
        kw = dict(state_dict=single.model.state_dict(),
                  thermal_head_state=single.thermal_head.state_dict(), device="cpu")
        make = lambda devices: InferenceEngine(  # noqa: E731
            single.config, mesh=make_mesh((4,), ("data",), devices=devices), **kw)
        arrays = ((rng.uniform(21000, 26000, (8, 48, 64)) / 65535.0).astype(np.float32),)
        run = lambda obj: lambda *a: obj.infer(*a)  # noqa: E731
    else:
        _, single = _mastr_generators(data, batch_size=8)
        make = lambda devices: PseudoGTGenerator(  # noqa: E731
            single.config, state_dict=single.model.state_dict(), batch_size=8,
            device="cpu", mesh=make_mesh((4,), ("data",), devices=devices))
        arrays = tuple(rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32) for _ in range(2))
        run = lambda obj: lambda *a: obj.run_pairs(*a)  # noqa: E731
    threaded, one_device = make(CPU_PAIR * 2), make(["cpu"] * 4)
    assert list(threaded._replicas) == CPU_PAIR
    first, second = (threaded._replicas[d][0] for d in CPU_PAIR)
    assert first is threaded.model and second is not first
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(first.parameters(), second.parameters()))
    got = run(threaded)(*arrays)
    _assert_equal(got, _by_chunks(run(single), 4, *arrays))
    _assert_equal(got, run(one_device)(*arrays))


# --- --ndev ------------------------------------------------------------------------------

def _parser_error(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


NDEV_CASES = [
    ("infer", ["--img_path", "x.png", "--no_vis", "--ndev", "5"]),
    ("infer", ["--img_path", "x.png", "--no_vis", "--ndev", "16"]),
    ("infer", ["--img_path", "x.png", "--img_path2", "y.png", "--ndev", "2"]),
    ("infer", ["--img_path", "x.png", "--fire_scene", "--ndev", "2"]),
    ("evaluate", ["--thermal_dir", "t", "--pseudo_gt_dir", "g", "--output_dir", "o",
                  "--ndev", "5"]),
    ("evaluate", ["--thermal_dir", "t", "--pseudo_gt_dir", "g", "--output_dir", "o",
                  "--batch_size", "32", "--ndev", "16"]),
    ("pseudo_gt", ["--dataset_dir", "d", "--output_dir", "o", "--ndev", "3"]),
    ("pseudo_gt", ["--dataset_dir", "d", "--output_dir", "o", "--batch_size", "16",
                   "--ndev", "16"]),
]


@pytest.mark.parametrize("cli,argv", NDEV_CASES)
def test_ndev_parser_errors_match_jax(cli, argv, capsys, tmp_path, monkeypatch):
    """The same parser error as the JAX CLI's (its 8 CPU devices; the port
    counted on [cpu]*8), on the same arguments: a batch that --ndev does
    not divide, more devices than the host has, --ndev > 1 with stereo or
    the fire modes."""
    from thermal3d_torch.cli import common

    monkeypatch.setattr(common, "available_devices", lambda device=None: CPU8)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "d").mkdir()  # an empty dataset: the JAX CLI indexes it first
    args = [*argv, *CLI_TINY]
    ours = _parser_error(importlib.import_module(f"thermal3d_torch.cli.{cli}").main,
                         [*args, "--device", "cpu"], capsys)
    theirs = _parser_error(importlib.import_module(f"thermal3d.cli.{cli}").main, args, capsys)
    assert ours.split("error: ")[1] == theirs.split("error: ")[1]


def test_ndev_parser_errors_of_the_other_clis(capsys, tmp_path):
    """ais_investigate takes --ndev for its 'original' stage only (the JAX
    infer guard's text); on this host's one CPU device --ndev 2 is the
    device-count error."""
    from thermal3d_torch.cli import ais_investigate, infer

    err = _parser_error(ais_investigate.main, ["--img_path", str(tmp_path), "--ndev", "2",
                                               *CLI_TINY, "--device", "cpu"], capsys)
    assert "supports only the directory-batch monocular path" in err
    err = _parser_error(infer.main, ["--img_path", "x.png", "--ndev", "2", "--batch_size", "2",
                                     *CLI_TINY, "--device", "cpu"], capsys)
    assert err.endswith("--ndev=2 but only 1 devices available")


def test_cli_ndev_runs_match_the_plain_cli(data, tmp_path, monkeypatch):
    """--ndev 1 is the plain CLI, file for file; cli.infer --ndev 8,
    cli.evaluate --ndev 2 and cli.pseudo_gt --ndev 2 --test_set (on
    [cpu]*N) write the one-device files within rtol 1e-4; ais_investigate
    --ndev 2 --stages original passes its --ndev to cli.infer."""
    from thermal3d_torch.cli import ais_investigate, common, evaluate, infer, pseudo_gt

    monkeypatch.setattr(common, "available_devices", lambda device=None: CPU8)
    base = ["--img_path", data["frames"], "--no_vis", "--weights", data["pth"]["wrapper"],
            *CLI_TINY, "--device", "cpu"]
    infer.main(base + ["--batch_size", "8", "--output_dir", str(tmp_path / "i")])
    infer.main(base + ["--batch_size", "8", "--ndev", "1", "--output_dir", str(tmp_path / "i1")])
    infer.main(base + ["--batch_size", "8", "--ndev", "8", "--output_dir", str(tmp_path / "i8")])
    assert len(_compare_trees(str(tmp_path / "i1"), str(tmp_path / "i"))) == 6
    for p in (tmp_path / "i").glob("*.npy"):
        assert np.array_equal(np.load(tmp_path / "i1" / p.name), np.load(p))
        _close(np.load(tmp_path / "i8" / p.name), np.load(p), p.name)

    ev = ["--thermal_dir", data["frames"], "--pseudo_gt_dir", data["gt"], "--model",
          data["pth"]["wrapper"], "--no_vis", "--batch_size", "4", *CLI_TINY, "--device", "cpu"]
    got = evaluate.main(ev + ["--ndev", "2", "--output_dir", str(tmp_path / "e2")])
    want = evaluate.main(ev + ["--output_dir", str(tmp_path / "e")])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)

    pg = ["--dataset_dir", data["ds"], "--weights", data["pth"]["mastr"], "--test_set",
          "--batch_size", "2", *CLI_TINY, "--device", "cpu"]
    assert pseudo_gt.main(pg + ["--ndev", "2", "--output_dir", str(tmp_path / "p2")]) == 5
    assert pseudo_gt.main(pg + ["--output_dir", str(tmp_path / "p")]) == 5
    assert len(_compare_trees(str(tmp_path / "p2"), str(tmp_path / "p"))) == 5

    ais_investigate.main(["--img_path", data["frames"], "--output_dir", str(tmp_path / "a"),
                          "--stages", "original", "--ndev", "2", "--no_vis", "--weights",
                          data["pth"]["wrapper"], *CLI_TINY, "--device", "cpu"])
    for p in (tmp_path / "i").glob("*.npy"):
        _close(np.load(tmp_path / "a" / "original" / p.name), np.load(p), p.name)


def test_bench_ndev_on_the_cpu(monkeypatch, capsys):
    """bench --ndev 2: the headline at twice the batch over a mesh of 2,
    reported as the aggregate with its per-device share (bench.py's keys);
    more devices than there are is an error."""
    from thermal3d_torch import bench
    from thermal3d_torch.cli import common

    argv = ["--device", "cpu", "--model_preset", "tiny", "--iters", "1", "--batch", "4",
            "--ndev", "2"]
    monkeypatch.setattr(common, "available_devices", lambda device=None: CPU8)
    assert bench.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "thermal_frames_per_sec_cpu_check_aggregate_dustr224"
    assert line["ndev"] == 2 and line["per_chip"] == pytest.approx(line["value"] / 2, abs=0.01)
    assert line["batch"] == 4 and "secondary_metrics" not in line
    monkeypatch.setattr(common, "available_devices", lambda device=None: ["cpu"])
    with pytest.raises(SystemExit):
        bench.main(argv)
