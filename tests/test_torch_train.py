"""The port's training path (``Model.loss``, remat, ``repro_torch.train``,
the launcher and the example) vs the JAX package's.

At reduced widths (``reduced()``: d_model 128, vocab 512) and B 2, S 24,
inputs made from a seed with numpy, weights drawn by the port and laid out
as JAX's ``Model.init`` tree (``jax.eval_shape``; DeepSeek-V3's MTP block
too):

* ``Model.loss`` and every parameter's gradient against JAX's jitted
  ``jax.value_and_grad(Model.loss)`` for qwen1_5_4b (a 1-D dedup mask),
  mamba2_130m and deepseek_v3_671b (MLA, MoE and the MTP block; its three
  dense layers and one MoE layer), and the loss for hubert_xlarge (frames,
  labels, a [B, S] mask). Tolerances: the loss 2e-3 relative; each
  gradient's largest error 5e-2 of the leaf's largest value (bf16
  weights and activations rounded at other places by the two frameworks;
  the worst leaf measured 0.037, deepseek's MTP router). Four JAX model
  compiles in all, one per architecture;
* ``_chunked_ce`` (a ``loss_chunk`` that does not divide S) against an
  unchunked CE; remat ``full`` and ``dots`` against none: equal
  gradients, bit for bit;
* ``adamw_update`` (float32 and int8 moments) and ``schedule`` against
  JAX's; a JAX state carried by ``convert.train_state_from_reference``
  stepping as JAX's; microbatches 2 against 1; two ``make_train_step``
  steps against JAX's (value_and_grad + adamw_update);
* ``checkpoint`` (bf16 and ``QTensor`` leaves, keep-last-k, a stale
  ``.tmp``), ``TrainingRunner`` failing and resuming bit-equal to an
  uninterrupted run, ``remesh``, ``grad_compression`` against JAX's with
  error feedback;
* ``launch.train`` and ``examples/train_lm_dedup_torch.py`` with
  ``--device cpu`` at a few steps; serving a trainable model builds no
  graph.
"""

import dataclasses
import functools
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.train import grad_compression as RGC
from repro.train import optimizer as RO
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.sharded_filter import Mesh, make_mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.train import (AdamWConfig, AdamWState, TrainingRunner,
                               adamw_init, adamw_update, checkpoint, compress,
                               decompress, init_train_state, make_train_step,
                               remesh, schedule, zero_residual)
from repro_torch.train import optimizer as TO

from test_torch_models import _numpy, _reference_params

torch.set_num_threads(1)

B, S = 2, 24
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen1_5_4b", "mamba2_130m", "deepseek_v3_671b", "hubert_xlarge"]
GRAD_ARCHS = ARCHS[:3]


def _cut(cfg):
    """``reduced()`` with CE chunks of 12 (two a sequence)."""
    return dataclasses.replace(cfg.reduced(), loss_chunk=12)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        return {"frames": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32),
            "mask": np.array([True, False])}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_params(cfg, model, port):
    """The port's weights as JAX's ``Model.init`` tree, the MTP block's
    included."""
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    tree = _reference_params(cfg, shapes, port.state_dict())
    if "mtp" in tree:
        state = port.state_dict()

        def leaf(path, _):
            keys = [str(getattr(k, "key", getattr(k, "idx", None)))
                    for k in path]
            return _numpy(state["mtp." + ".".join(keys)])

        tree["mtp"] = jax.tree_util.tree_map_with_path(leaf, shapes["mtp"])
    return tree


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(cfg, a trainable port model on the CPU, JAX's model, its params,
    JAX's jitted value_and_grad of ``loss``): one compile an
    architecture."""
    cfg = _cut(get_config(arch))
    port = build_model(cfg, device="cpu", seed=0)
    port.init_mtp(seed=1)
    port.requires_grad_(True)
    model = r_build_model(_cut(r_get_config(arch)))
    params = _jax_params(cfg, model, port)
    return cfg, port, model, params, jax.jit(jax.value_and_grad(model.loss))


def _port_grads(port, batch, **kw):
    names, params = zip(*port.named_parameters())
    loss = port.loss(_torch_batch(batch), **kw)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def _jax_loss_grads(arch, batch):
    cfg, port, _, params, vg = _setup(arch)
    loss, grads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), convert.model_params_from_reference(
        cfg, jax.tree.map(np.asarray, grads), mtp="mtp" in params)


def _grad_close(got, want, what):
    assert set(got) == set(want), what
    for name in want:
        g, w = got[name].float().numpy(), want[name].float().numpy()
        assert g.shape == w.shape, (what, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= 5e-2 * scale, f"{what} {name}: {err} > 5e-2 x {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, port, _, params, _ = _setup(arch)
    batch = _batch(cfg)
    want_loss, want_grads = _jax_loss_grads(arch, batch)
    if arch in GRAD_ARCHS:
        loss, grads = _port_grads(port, batch)
        _grad_close(grads, want_grads, arch)
    else:
        with torch.no_grad():
            loss = port.loss(_torch_batch(batch))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-3)
    if arch == "deepseek_v3_671b":
        assert any(n.startswith("mtp.block.ffn") for n in grads)


def test_mtp_block_only_for_training():
    cfg, port, _, params, _ = _setup("deepseek_v3_671b")
    serving = build_model(cfg, device="cpu", seed=0)
    assert serving.mtp is None
    assert not any(n.startswith("mtp.") for n in serving.state_dict())
    state = convert.model_params_from_reference(
        cfg, jax.tree.map(np.asarray, params))
    assert not any(n.startswith("mtp.") for n in state)
    serving.load_state_dict(state)
    carried = convert.model_params_from_reference(
        cfg, jax.tree.map(np.asarray, params), mtp=True)
    for name, t in port.state_dict().items():
        assert torch.equal(carried[name], t), name


def test_chunked_ce_matches_unchunked():
    cfg, port, _, _, _ = _setup("qwen1_5_4b")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    mask = torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32))
    port.cfg = dataclasses.replace(cfg, loss_chunk=5)   # 5 -> 4: 6 chunks
    try:
        with torch.no_grad():
            got = port._chunked_ce(x, labels, mask)
    finally:
        port.cfg = cfg
    with torch.no_grad():
        logits = port._logits(x)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    want = (nll * mask).sum() / mask.sum()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    cfg, port, _, _, _ = _setup("qwen1_5_4b")
    batch = _batch(cfg, seed=4)
    try:
        port.cfg = dataclasses.replace(cfg, remat_policy=policy)
        loss, grads = _port_grads(port, batch)
        port.cfg = dataclasses.replace(cfg, remat_policy="none")
        loss0, grads0 = _port_grads(port, batch)
    finally:
        port.cfg = cfg
    loss1, grads1 = _port_grads(port, batch, remat=False)
    assert torch.equal(loss, loss0) and torch.equal(loss, loss1)
    for name in grads0:
        assert torch.equal(grads[name], grads0[name]), name
        assert torch.equal(grads1[name], grads0[name]), name


def _opt_tree(seed=5):
    """A small parameter tree (a bf16 matrix, float32 vectors) and two
    steps of gradients, as numpy."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 300)).astype(jnp.bfloat16),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "s": rng.normal(size=(600,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * (0.5 + i)).astype(np.float32)
              for k, v in params.items()} for i in range(2)]
    return params, grads


def _to_torch(tree):
    return {k: convert._tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_matches_reference(quantize):
    params, grads = _opt_tree()
    rcfg = RO.AdamWConfig(warmup_steps=1, quantize_state=quantize)
    cfg = AdamWConfig(warmup_steps=1, quantize_state=quantize)
    r_params, r_state = params, RO.adamw_init(rcfg, params)
    t_params = _to_torch(params)
    t_state = adamw_init(cfg, t_params)
    update = jax.jit(functools.partial(RO.adamw_update, rcfg))
    for g in grads:
        r_params, r_state, r_metrics = update(g, r_state, r_params)
        t_params, t_state, t_metrics = adamw_update(cfg, _to_torch(g),
                                                    t_state, t_params)
    assert int(t_state.step) == int(r_state.step) == 2
    np.testing.assert_allclose(float(t_metrics["grad_norm"]),
                               float(r_metrics["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(t_metrics["lr"]), float(r_metrics["lr"]),
                               rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(t_params[k].float().numpy(),
                                   np.asarray(r_params[k], np.float32),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        for t, r in ((t_state.m[k], r_state.m[k]), (t_state.v[k], r_state.v[k])):
            if quantize:
                assert t.q.dtype == torch.int8 and t.q.shape[0] % 512 == 0
                # One int8 step of the block's scale at most.
                np.testing.assert_allclose(
                    TO._dequantize(t).numpy(), np.asarray(RO._dequantize(r)),
                    rtol=0, atol=float(np.asarray(r.scale).max()) * 1.01)
            else:
                # A float32 ulp apart at most (XLA may fuse the moment
                # update's multiply and add).
                np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                           rtol=1e-5, atol=1e-8)


def test_schedule_matches_reference():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    rcfg = RO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(schedule(cfg, torch.tensor(step, dtype=torch.int32))),
            float(RO.schedule(rcfg, jnp.asarray(step, jnp.int32))),
            rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("quantize", [False, True])
def test_carried_train_state_steps_as_reference(quantize):
    cfg, port, model, params, _ = _setup("mamba2_130m")
    opt = AdamWConfig(warmup_steps=1, quantize_state=quantize)
    ropt = RO.AdamWConfig(warmup_steps=1, quantize_state=quantize)
    rng = np.random.default_rng(6)
    np_params = jax.tree.map(np.asarray, params)

    def grads_like(tree):
        return jax.tree.map(lambda p: rng.normal(size=p.shape)
                            .astype(np.float32), tree)

    update = jax.jit(functools.partial(RO.adamw_update, ropt))
    r_params, r_state, _ = update(grads_like(np_params),
                                  RO.adamw_init(ropt, np_params), np_params)
    state, t_state = convert.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, r_params),
        jax.tree.map(np.asarray, r_state))
    assert int(t_state.step) == 1
    g = grads_like(np_params)
    r_params, r_state, _ = update(g, r_state, r_params)
    t_params = dict(state)
    t_params, t_state, _ = adamw_update(
        opt, convert.model_params_from_reference(cfg, g), t_state, t_params)
    want = convert.model_params_from_reference(
        cfg, jax.tree.map(np.asarray, r_params))
    for name, p in t_params.items():
        w = want[name].float().numpy()
        # float32 moments: the same arithmetic (bf16 weights: one bf16
        # step apart at most); int8: the moments were requantized per
        # layer, so an update may differ by a few lr.
        atol = 8 * opt.lr if quantize else 1e-6
        np.testing.assert_allclose(p.float().numpy(), w, rtol=2 ** -7,
                                   atol=atol, err_msg=name)


def test_microbatches_match_one_batch():
    cfg, _, _, _, _ = _setup("qwen1_5_4b")
    batch = _batch(cfg, seed=7)
    batch["mask"] = np.array([True, True])
    opt = AdamWConfig(warmup_steps=1)
    out = {}
    for mb in (1, 2):
        model = build_model(cfg, device="cpu", seed=0)
        model, state = init_train_state(model, opt)
        step = make_train_step(model, opt, microbatches=mb)
        model, state, metrics = step(model, state, _torch_batch(batch))
        out[mb] = (model, metrics)
    np.testing.assert_allclose(float(out[2][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out[2][1]["grad_norm"]),
                               float(out[1][1]["grad_norm"]), rtol=2e-2)
    two = dict(out[2][0].named_parameters())
    for name, p in out[1][0].named_parameters():
        # AdamW's first step moves each weight by ~lr whatever the
        # gradient's size: a bf16-rounded gradient near 0 may flip sign.
        np.testing.assert_allclose(two[name].detach().float().numpy(),
                                   p.detach().float().numpy(),
                                   rtol=2 ** -7, atol=2.5 * opt.lr,
                                   err_msg=name)


def test_two_train_steps_match_reference():
    cfg, _, model, params, vg = _setup("qwen1_5_4b")
    port = build_model(cfg, device="cpu", seed=0)
    opt = AdamWConfig(warmup_steps=1)
    ropt = RO.AdamWConfig(warmup_steps=1)
    port, state = init_train_state(port, opt)
    step = make_train_step(port, opt)
    update = jax.jit(functools.partial(RO.adamw_update, ropt))
    r_params, r_state = params, RO.adamw_init(ropt, params)
    for i in range(2):
        batch = _batch(cfg, seed=10 + i)
        port, state, metrics = step(port, state, _torch_batch(batch))
        loss, grads = vg(r_params, {k: jnp.asarray(v) for k, v in batch.items()})
        r_params, r_state, r_metrics = update(grads, r_state, r_params)
        np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                                   rtol=2e-3)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(r_metrics["grad_norm"]), rtol=2e-2)
        assert float(metrics["lr"]) == pytest.approx(float(r_metrics["lr"]),
                                                     rel=1e-6)
    want = convert.model_params_from_reference(
        cfg, jax.tree.map(np.asarray, r_params))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   want[name].float().numpy(), rtol=2 ** -7,
                                   atol=4.5 * opt.lr, err_msg=name)


def test_checkpoint_roundtrip(tmp_path):
    cfg, _, _, _, _ = _setup("mamba2_130m")
    model = build_model(cfg, device="cpu", seed=2)
    opt = AdamWConfig(quantize_state=True)
    model, state = init_train_state(model, opt)
    g = {n: torch.randn(p.shape) for n, p in model.named_parameters()}
    model, state, _ = adamw_update(opt, g, state, model)
    tree = {"params": model, "opt": state}
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "step_00000009.tmp"))     # a crash's leftover
    for step in (1, 2, 3, 4):
        checkpoint.save(d, step, tree, aux={"data_cursor": step}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000009.tmp"]
    assert checkpoint.latest_step(d) == 4
    fresh, fresh_state = init_train_state(build_model(cfg, device="cpu",
                                                      seed=3), opt)
    got, step, aux = checkpoint.restore(d, {"params": fresh,
                                            "opt": fresh_state})
    assert step == 4 and aux == {"data_cursor": 4}
    assert int(got["opt"].step) == int(state.step) == 1
    for name, p in model.named_parameters():
        q = dict(fresh.named_parameters())[name]
        assert q.dtype == p.dtype and torch.equal(q, p), name
        for a, b in ((fresh_state.m[name], state.m[name]),
                     (fresh_state.v[name], state.v[name])):
            assert isinstance(a, TO.QTensor) and a.shape == b.shape
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), tree)


def _mamba_run(tmp, fail_at=None):
    cfg, _, _, _, _ = _setup("mamba2_130m")
    from repro_torch.data import DataConfig, make_batch
    data = DataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=16)
    opt = AdamWConfig(warmup_steps=2, total_steps=6)

    def fresh():
        return init_train_state(build_model(cfg, device="cpu", seed=0), opt)

    def runner(fail):
        return TrainingRunner(make_train_step(None, opt),
                              lambda s: make_batch(data, s, "cpu"), tmp,
                              ckpt_every=3, fail_at_step=fail)

    model, state = fresh()
    if fail_at is not None:
        with pytest.raises(RuntimeError, match="injected failure"):
            runner(fail_at).run(model, state, 6, log_fn=lambda s: None)
        model, state = fresh()
        model, state, start = runner(None).resume(model, state)
        assert start == fail_at
    else:
        start = 0
    return runner(None).run(model, state, 6, start_step=start,
                            log_fn=lambda s: None)[:2]


def test_runner_resume_is_bit_equal(tmp_path):
    model, state = _mamba_run(str(tmp_path / "a"))
    model2, state2 = _mamba_run(str(tmp_path / "b"), fail_at=3)
    assert int(state.step) == int(state2.step) == 6
    other = dict(model2.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, other[name]), name
        assert torch.equal(state.m[name], state2.m[name]), name
        assert torch.equal(state.v[name], state2.v[name]), name


def test_remesh_moves_onto_the_mesh():
    cfg, _, _, _, _ = _setup("mamba2_130m")
    model, state = init_train_state(build_model(cfg, device="cpu", seed=0),
                                    AdamWConfig(quantize_state=True))
    seen = []
    out = remesh({"params": model, "opt": state}, None,
                 make_mesh(1, device="cpu"),
                 lambda path, leaf: seen.append(path))
    assert out["params"] is model and isinstance(out["opt"], AdamWState)
    assert isinstance(next(iter(out["opt"].m.values())), TO.QTensor)
    # Each parameter, the step, each moment's q and scale.
    assert len(seen) == 5 * len(dict(model.named_parameters())) + 1
    with pytest.raises(NotImplementedError, match="item 13"):
        remesh(state, None, Mesh(("cpu", "meta")), lambda p, l: None)


def test_grad_compression_matches_reference():
    rng = np.random.default_rng(8)
    shapes = {"a": (3, 100), "b": (257,), "c": (5,)}
    t_res = zero_residual({k: torch.zeros(s) for k, s in shapes.items()})
    r_res = RGC.zero_residual({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        tc, t_res = compress(_to_torch(g), t_res)
        rc, r_res = RGC.compress(g, r_res)
        for k in shapes:
            assert tc.q[k].dtype == torch.int8
            np.testing.assert_array_equal(tc.q[k].numpy(), np.asarray(rc.q[k]))
            np.testing.assert_array_equal(tc.scale[k].numpy(),
                                          np.asarray(rc.scale[k]))
            np.testing.assert_allclose(t_res[k].numpy(), np.asarray(r_res[k]),
                                       rtol=0, atol=1e-7)
        dec = decompress(tc, _to_torch(g))
        rdec = RGC.decompress(rc, g)
        for k in shapes:
            np.testing.assert_array_equal(dec[k].numpy(), np.asarray(rdec[k]))


def test_launch_train_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen1_5_4b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "16", "--dedup", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    out = launch_train.main(argv)
    assert [s["flash_forward"] for s in out["steps"]] == [0, 0, 0]
    assert len(out["steps"]) == 3 and out["peak_bytes"] is None
    assert all(np.isfinite(s["loss"]) for s in out["steps"])
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert "losses:" in capsys.readouterr().out
    again = launch_train.main(argv[:4] + ["4"] + argv[5:] + ["--resume"])
    assert again["start_step"] == 3 and len(again["steps"]) == 1


def test_launch_train_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])


def test_example_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_dedup_torch", ROOT / "examples" / "train_lm_dedup_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    # Four steps: the failure at step 2 comes before the first checkpoint
    # (every 25), so the second runner starts over; the last step writes
    # one.
    out = example.main(["--device", "cpu", "--steps", "4", "--ckpt-dir",
                        str(tmp_path)])
    assert out["resumed_at"] == 0 and out["final_step"] == 4
    assert out["duplicates"] > 0 and all(np.isfinite(out["losses"]))
    assert "injected failure at step 2" in capsys.readouterr().out


def test_serving_a_trainable_model_builds_no_graph():
    cfg, port, _, _, _ = _setup("qwen1_5_4b")
    assert all(p.requires_grad for p in port.parameters())
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 8)) \
        .astype(np.int32)
    logits, caches = port.prefill(tokens)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(t.grad_fn is None for c in caches for t in c)
    logits, _ = port.decode_step(tokens[:, 0], port.init_caches(B, 16), 0)
    assert logits.grad_fn is None
    out, _ = ServeEngine(port, batch=B, max_len=12).generate(tokens, steps=2)
    assert out.shape == (B, 3)      # the prefill's token and two decoded
    _, hubert, _, _, _ = _setup("hubert_xlarge")
    assert hubert.encode(torch.zeros((1, 4, hubert.cfg.d_model))).grad_fn is None
