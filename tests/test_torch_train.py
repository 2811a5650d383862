"""Parity of the port's training slice (thermal3d_torch/train, the autograd
Functions of kernels/flash_attention.py, models.dustr.trainable_model) with
the JAX package (thermal3d/train, the custom_vjp backwards of
thermal3d/kernels/flash_attention.py) on seeded numpy inputs, at the tiny
preset in float32 unless stated."""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_common import TINY_KW, configs, drawn_params, to_np, torch_state
from tests.test_train import torch_lr_oracle
from thermal3d.core.config import LossConfig as JaxLossConfig
from thermal3d.core.config import TrainConfig as JaxTrainConfig
from thermal3d.models.rope import make_grid_positions as jax_grid
from thermal3d.models.rope import rope_tables as jax_rope_tables
from thermal3d_torch.convert.from_jax import state_dict_from_jax
from thermal3d_torch.core.config import LossConfig, TrainConfig
from thermal3d_torch.models import layers
from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo, trainable_model
from thermal3d_torch.train import state as tstate
from thermal3d_torch.train import step as tstep
from thermal3d_torch.train.checkpoint import CheckpointManager, load_params_from_checkpoint_dir

CPU = torch.device("cpu")
# the modules (each kernels package re-exports a function of the same name)
jfa = importlib.import_module("thermal3d.kernels.flash_attention")
tfa = importlib.import_module("thermal3d_torch.kernels.flash_attention")


# --- the learning-rate schedule ------------------------------------------

@pytest.mark.parametrize("kw", [dict(epochs=3), dict(epochs=3, warmup_frac=0.34),
                                dict(epochs=3, warmup_frac=0.67, warmup_start_factor=0.3)])
def test_lr_schedule_matches_jax_every_step(kw):
    from thermal3d.train.state import make_lr_schedule as jax_schedule

    spe = 7
    ours = tstate.make_lr_schedule(TrainConfig(**kw), spe)
    ref = jax_schedule(JaxTrainConfig(**kw), spe)
    got = [ours(s) for s in range(3 * spe + 2)]
    want = [float(ref(s)) for s in range(3 * spe + 2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("epochs", [10, 50])
def test_lr_schedule_matches_torch_oracle(epochs):
    spe = 7
    ours = tstate.make_lr_schedule(TrainConfig(epochs=epochs, lr=5e-4), spe)
    got = [ours(e * spe) for e in range(epochs)]
    np.testing.assert_allclose(got, torch_lr_oracle(epochs, 5e-4), rtol=1e-5)


# --- the optimizer, fed identical gradients -------------------------------

SHAPES = {"a": (5, 7), "b": (11,), "c": (3, 4, 2)}


@pytest.mark.parametrize("case", ["above_clip", "below_clip", "mu_bf16", "accumulate2"])
def test_optimizer_matches_optax(case):
    """The clip + AdamW chain (+ MultiSteps) against the JAX make_optimizer
    on the same parameters and gradients: parameters within 1e-6 after 3
    updates; the clip triggers in 'above_clip' only."""
    from thermal3d.train.state import make_optimizer

    rng = np.random.default_rng(7)
    kw = dict(lr=5e-4, epochs=3, warmup_frac=0.34)
    kw.update({"mu_bf16": dict(mu_dtype="bfloat16"),
               "accumulate2": dict(accumulation_steps=2)}.get(case, {}))
    scale = 0.01 if case == "below_clip" else 1.0
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    k_steps = 2 if case == "accumulate2" else 1
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3 * k_steps)]
    norms = [math.sqrt(sum(float((g ** 2).sum()) for g in gs.values())) for gs in grads]
    assert (min(norms) > 1.0) if scale == 1.0 else (max(norms) < 1.0)

    tx = make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    keys = sorted(SHAPES)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    opt = tstate.AdamW(tp, TrainConfig(**kw), steps_per_epoch=2)
    for g in grads:
        opt.step([torch.from_numpy(g[k]) for k in keys])
    assert opt.count == 3
    for k, t in zip(keys, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)
    if case == "mu_bf16":
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)


def test_adamw_decay_agrees_with_torch_adamw():
    """optax adds wd·p to the update, torch's AdamW decays p before its Adam
    step: below the clip, with the schedule constant, the two agree."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [(0.05 * rng.normal(size=p0.shape)).astype(np.float32) for _ in range(4)]
    cfg = TrainConfig(lr=1e-2, weight_decay=0.1, epochs=1, warmup_frac=0.0, eta_min=1e-2)
    ours = torch.from_numpy(p0.copy())
    opt = tstate.AdamW([ours], cfg, steps_per_epoch=100)
    ref = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    torch_opt = torch.optim.AdamW([ref], lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)
    for g in grads:
        opt.step([torch.from_numpy(g)])
        ref.grad = torch.from_numpy(g)
        torch_opt.step()
    np.testing.assert_allclose(ours.numpy(), ref.detach().numpy(), rtol=0, atol=1e-6)


def test_flatten_optimizer_is_accepted_and_changes_nothing():
    rng = np.random.default_rng(1)
    g = [torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))]
    out = []
    for flat in (False, True):
        p = [torch.ones(4, 3)]
        opt = tstate.AdamW(p, TrainConfig(flatten_optimizer=flat), 5)
        opt.step(g)
        out.append(p[0])
    assert torch.equal(*out)


# --- the attention gradients against jax.vjp ------------------------------

def _rope(hg, wg, d):
    cos, sin = (np.array(t) for t in jax_rope_tables(jax_grid(hg, wg), d, 100.0))
    return cos, sin


def _limit(dtype):
    return 1e-5 if dtype == "float32" else 2.0 ** -6


def _assert_rel(got, want, limit, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= limit, f"{what}: max|Δ|/max|ref| {err:.3e} > {limit:.1e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cross", [False, True])
def test_k2_k3_vjp_matches_jax(dtype, cross):
    rng = np.random.default_rng(11)
    b, hg, wg, nh, d = 2, 4, 5, 2, 16
    s, c = hg * wg, nh * d
    cos, sin = _rope(hg, wg, d)
    scale = 1.0 / math.sqrt(d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xs = [rng.standard_normal((b, s, c if cross else 3 * c)).astype(np.float32)
          for _ in range(3 if cross else 1)]
    g = rng.standard_normal((b, s, c)).astype(np.float32)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    if cross:
        f = lambda q, k, v: jfa.fused_rope_cross_attention(  # noqa: E731
            q, k, v, jc, js, nh, scale, 4, True)
    else:
        f = lambda qkv: jfa.fused_rope_attention(qkv, jc, js, nh, scale, 4, True)  # noqa: E731
    out, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in xs))
    want = vjp(jnp.asarray(g, jdt))

    ts = [torch.tensor(x, dtype=tdt, requires_grad=True) for x in xs]
    tc, tsn = torch.from_numpy(cos), torch.from_numpy(sin)
    fn = tfa.fused_rope_cross_attention if cross else tfa.fused_rope_attention
    got_out = fn(*ts, tc, tsn, nh, scale)
    assert got_out.grad_fn is not None and "Fused" in type(got_out.grad_fn).__name__
    got_out.backward(torch.tensor(g, dtype=tdt))
    _assert_rel(to_np(got_out.float()), np.asarray(out, np.float32), _limit(dtype), "forward")
    for t, w, name in zip(ts, want, "qkv"):
        assert t.grad.dtype == tdt
        _assert_rel(to_np(t.grad.float()), np.asarray(w, np.float32), _limit(dtype), f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["pallas", "grouped", "multihead"])
def test_k4_k6_vjp_matches_jax(dtype, which):
    rng = np.random.default_rng(12)
    b, h, sq, sk, d = 2, 3, 24, 40, 16
    scale = 1.0 / math.sqrt(d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, sk, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    if which == "pallas":
        def f(q_, k_, v_):
            out = jfa._flash_attention_core(q_.reshape(b * h, sq, d), k_.reshape(b * h, sk, d),
                                            v_.reshape(b * h, sk, d), scale, True)
            return out.reshape(b, h, sq, d)
        fn = tfa.flash_attention_pallas
    elif which == "grouped":
        f = lambda q_, k_, v_: jfa._grouped_core(q_, k_, v_, scale, 2, True)  # noqa: E731
        fn = tfa.flash_attention_grouped
    else:
        f = lambda q_, k_, v_: jfa._multihead_core(q_, k_, v_, scale, True)  # noqa: E731
        fn = tfa.flash_attention_multihead
    _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    ts = [torch.tensor(x, dtype=tdt, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts, scale)
    out.backward(torch.tensor(g, dtype=tdt))
    for t, w, name in zip(ts, want, "qkv"):
        _assert_rel(to_np(t.grad.float()), np.asarray(w, np.float32), _limit(dtype), f"d{name}")


def test_no_grad_path_skips_the_function():
    """Under torch.no_grad (serving, pseudo-GT) the wrappers return without
    an autograd node, as before training existed."""
    qkv = torch.randn(1, 20, 96, requires_grad=True)
    cos, sin = (torch.from_numpy(t) for t in _rope(4, 5, 16))
    with torch.no_grad():
        assert tfa.fused_rope_attention(qkv, cos, sin, 2, 0.25).grad_fn is None
    assert tfa.fused_rope_attention(qkv, cos, sin, 2, 0.25).grad_fn is not None


# --- the model: routes, TF32, remat ----------------------------------------

@pytest.mark.parametrize("impl", ["pallas_fused", "pallas_fused4"])
def test_pallas_fused_routes_to_k2_k3(impl, monkeypatch):
    """The JAX model's explicit K2/K3 names build and match 'auto'
    bit for bit, through the K2/K3 wrappers."""
    _, tcfg = configs(**TINY_KW)
    calls = []
    for name in ("fused_rope_attention", "fused_rope_cross_attention"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    outs = {}
    for route in ("auto", impl):
        model = AsymmetricCroCo3DStereo(dataclasses.replace(tcfg, attention_impl=route))
        model.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs[route] = model(img, img.flip(1))
    assert calls.count("fused_rope_attention") == 2 * 6 and calls.count(
        "fused_rope_cross_attention") == 2 * 4
    for key in ("pts3d", "conf"):
        assert torch.equal(outs["auto"][0][key], outs[impl][0][key])
    with pytest.raises(ValueError, match="attention impl"):
        AsymmetricCroCo3DStereo(dataclasses.replace(tcfg, attention_impl="xla"))


@pytest.mark.parametrize("dtype,want_tf32", [("float32", False), ("bfloat16", True)])
def test_float32_convs_run_without_tf32(dtype, want_tf32, monkeypatch):
    """Inside the patch-embed and DPT convs the cuDNN TF32 flag is off
    exactly when they compute in float32, and restored after."""
    import torch.nn.functional as F

    from thermal3d_torch.core.config import DUSTR_512_DPT
    from thermal3d_torch.models import heads

    seen = []

    def spy(fn):
        def wrapped(*a, **k):
            seen.append(torch.backends.cudnn.allow_tf32)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(layers.F, "conv2d", spy(F.conv2d))
    monkeypatch.setattr(heads.F, "conv_transpose2d", spy(F.conv_transpose2d))
    monkeypatch.setattr(heads._Conv, "_conv_forward", spy(torch.nn.Conv2d._conv_forward))
    cfg = dataclasses.replace(DUSTR_512_DPT, compute_dtype=dtype, img_size=(32, 32),
                              enc_embed_dim=32, enc_depth=1, enc_num_heads=2, dec_embed_dim=32,
                              dec_depth=4, dec_num_heads=2,
                              head=dataclasses.replace(DUSTR_512_DPT.head, feature_dim=16,
                                                       last_dim=8, dpt_layer_dims=(4, 8, 8, 16)))
    model = AsymmetricCroCo3DStereo(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.rand(1, 32, 32, 3))
    assert len(seen) > 10 and set(seen) == {want_tf32}
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.parametrize("dtype,dpt_dtype,want_tf32", [("float32", "compute", False),
                                                      ("bfloat16", "float32", False),
                                                      ("bfloat16", "compute", True)])
def test_train_step_backward_tf32(dtype, dpt_dtype, want_tf32, monkeypatch):
    """The backward of a train step runs with the cuDNN TF32 flag off
    whenever the trunk or the DPT heads compute in float32 (a hook on the
    head's and the patch embed's conv weights reads the flag as their
    gradients arrive), and the flag is restored after."""
    from thermal3d_torch.core.config import DUSTR_512_DPT

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = dataclasses.replace(DUSTR_512_DPT, compute_dtype=dtype, img_size=(32, 32),
                              enc_embed_dim=32, enc_depth=1, enc_num_heads=2, dec_embed_dim=32,
                              dec_depth=4, dec_num_heads=2,
                              head=dataclasses.replace(DUSTR_512_DPT.head, feature_dim=16,
                                                       last_dim=8, dpt_layer_dims=(4, 8, 8, 16),
                                                       dpt_dtype=dpt_dtype))
    model = trainable_model(cfg, CPU, seed=0)
    seen = []
    convs = [p for n, p in model.named_parameters()
             if p.dim() == 4 and ("patch_embed" in n or "head" in n)]
    for p in convs:
        p.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    cfg_t = TrainConfig(lr=1e-3, use_enhanced_loss=False)
    state = tstate.create_train_state(model, cfg_t, 10)
    tstep.make_train_step(model, cfg_t)(state, _batch(np.random.default_rng(0), 1))
    assert len(seen) == len(convs) > 10 and set(seen) == {want_tf32}
    assert torch.backends.cudnn.allow_tf32 is True


def test_remat_matches_plain_step():
    _, tcfg = configs(**TINY_KW)
    batch = _batch(np.random.default_rng(2), 2)
    out = {}
    for remat in (False, True):
        model = trainable_model(dataclasses.replace(tcfg, remat=remat), CPU, seed=3)
        state = tstate.create_train_state(model, TrainConfig(lr=1e-3), 10)
        _, m = tstep.make_train_step(model, TrainConfig(lr=1e-3))(state, batch)
        out[remat] = (float(m["loss"]), float(m["grad_norm"]), model.state_dict())
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-5)
    for k, v in out[False][2].items():
        np.testing.assert_allclose(to_np(out[True][2][k]), to_np(v), rtol=0, atol=1e-6)


# --- the train and eval steps against JAX ----------------------------------

def _batch(rng, b, hw=32, ghw=16):
    arrays = {
        "thermal1": rng.uniform(21000, 26000, (b, hw, hw, 3)).astype(np.float32),
        "thermal2": rng.uniform(21000, 26000, (b, hw, hw, 3)).astype(np.float32),
        "pointmap1": rng.uniform(0.1, 5, (b, ghw, ghw, 3)).astype(np.float32),
        "pointmap2": rng.uniform(0.1, 5, (b, ghw, ghw, 3)).astype(np.float32),
        "confidence1": np.ones((b, ghw, ghw), np.float32),
        "confidence2": np.ones((b, ghw, ghw), np.float32),
    }
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs(**TINY_KW)
    return dict(jcfg=jcfg, tcfg=tcfg, params=drawn_params(jcfg, seed=1))


@pytest.mark.parametrize("enhanced", [True, False])
def test_train_step_matches_jax(tiny, enhanced):
    """One step on converted JAX params: the loss and grad_norm within 1e-5
    of the JAX make_train_step's, and (v2 loss) each gradient tensor within
    1e-4 of its max|g| of jax.grad of the same loss."""
    from thermal3d.models.dustr import AsymmetricCroCo3DStereo as JaxModel
    from thermal3d.train.state import create_train_state as jax_state
    from thermal3d.train.step import _batch_loss, _prepare_views
    from thermal3d.train.step import make_train_step as jax_step

    jcfg_t = JaxTrainConfig(lr=1e-3, use_enhanced_loss=enhanced,
                            loss=JaxLossConfig(multi_scale=True))
    cfg_t = TrainConfig(lr=1e-3, use_enhanced_loss=enhanced, loss=LossConfig(multi_scale=True))
    batch = _batch(np.random.default_rng(5), 2)
    jbatch = {k: jnp.asarray(to_np(v)) for k, v in batch.items()}
    jmodel = JaxModel(tiny["jcfg"])

    def loss_fn(p):
        b = _prepare_views(jbatch)
        pred1, pred2 = jmodel.apply({"params": p}, b["thermal1_enh"], b["thermal2_enh"])
        return _batch_loss(pred1, pred2, b, pred1["pts3d"].shape[1:3], jcfg_t)[0]

    jparams = jax.tree_util.tree_map(jnp.asarray, tiny["params"])
    state = jax_state(jmodel, jax.tree_util.tree_map(jnp.array, jparams), jcfg_t, 10)
    _, jmetrics = jax_step(jmodel, jcfg_t)(state, jbatch)

    model = trainable_model(tiny["tcfg"], CPU, torch_state(tiny["params"]))
    names = [n for n, _ in model.named_parameters()]
    views = tstep._prepare_views(batch)
    pred1, pred2 = model(views["thermal1_enh"], views["thermal2_enh"])
    loss, _ = tstep._batch_loss(pred1, pred2, views, pred1["pts3d"].shape[1:3], cfg_t)
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    if enhanced:  # the gradient of every tensor (the basic loss: its norm only)
        jgrads = state_dict_from_jax(jax.jit(jax.grad(loss_fn))(jparams))
        assert sorted(grads) == sorted(jgrads)
        for k, g in grads.items():
            want = to_np(jgrads[k])
            err = np.abs(to_np(g) - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, f"grad {k}: {err:.3e}"

    state_t = tstate.create_train_state(model, cfg_t, 10)
    _, metrics = tstep.make_train_step(model, cfg_t)(state_t, batch)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=1e-5)
    comps = ("basic_loss", "edge_loss", "smoothness_loss", "detail_loss") if enhanced \
        else ("basic_loss",)
    for k in comps:
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5, abs=1e-7), k
    for k in ("sample_pred_depth", "sample_gt_depth"):
        np.testing.assert_allclose(to_np(metrics[k]), np.asarray(jmetrics[k]), rtol=1e-4,
                                   atol=1e-5)
    assert state_t.step == 1 and state_t.tx.count == 1


def test_eval_step_matches_jax(tiny):
    from thermal3d.models.dustr import AsymmetricCroCo3DStereo as JaxModel
    from thermal3d.train.step import make_eval_step as jax_eval

    batch = _batch(np.random.default_rng(6), 3)
    want = jax_eval(JaxModel(tiny["jcfg"]), JaxTrainConfig())(
        jax.tree_util.tree_map(jnp.asarray, tiny["params"]),
        {k: jnp.asarray(to_np(v)) for k, v in batch.items()})
    model = trainable_model(tiny["tcfg"], CPU, torch_state(tiny["params"]))
    got = tstep.make_eval_step(model, TrainConfig())(model, batch)
    assert got.shape == (3,) and not got.requires_grad
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5)


# --- checkpoints and the loop -----------------------------------------------

def test_checkpoint_roundtrip(tmp_path, tiny):
    """save → restore: identical parameters, optimizer state, step and meta;
    best keeps the 3 lowest val_loss, last only the newest."""
    cfg = TrainConfig(lr=1e-3, mu_dtype="bfloat16")
    model = trainable_model(tiny["tcfg"], CPU, seed=4)
    state = tstate.create_train_state(model, cfg, 10)
    tstep.make_train_step(model, cfg)(state, _batch(np.random.default_rng(1), 2))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for epoch, val in ((1, 0.5), (2, 0.4), (3, 0.6), (4, 0.45)):
        mgr.save_best(epoch, state, val, {"epoch": epoch, "best_val": 0.4, "patience": 1})
        mgr.save_last(epoch, state, val, {"epoch": epoch, "best_val": 0.4, "patience": 1})
    assert sorted(int(d.name) for d in (tmp_path / "ck" / "best").iterdir()) == [1, 2, 4]
    assert [d.name for d in (tmp_path / "ck" / "last").iterdir()] == ["4"]
    assert mgr.latest_step() == 4 and mgr.best_step() == 2

    fresh = trainable_model(tiny["tcfg"], CPU, seed=9)
    restored, meta = mgr.restore(tstate.create_train_state(fresh, cfg, 10))
    assert meta == {"val_loss": 0.45, "epoch": 4, "best_val": 0.4, "patience": 1}
    assert restored.step == 1 and restored.tx.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    for a, b in zip(state.tx.mu + state.tx.nu, restored.tx.mu + restored.tx.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, meta_best = mgr.restore(tstate.create_train_state(fresh, cfg, 10), step=2)
    assert meta_best["val_loss"] == 0.4
    sd, meta_p = load_params_from_checkpoint_dir(str(tmp_path / "ck"))
    assert meta_p["epoch"] == 4 and sorted(sd) == sorted(model.state_dict())
    with pytest.raises(FileNotFoundError):
        mgr.restore(tstate.create_train_state(fresh, cfg, 10), step=3)
