"""The port's consumer models (``models/``) against the JAX package's, on
the CPU at the JAX package's mini configs.

* Forward: flax parameters carried across by ``models/convert.py``; f32
  logits within 1e-5 (the runs show ~1.3e-6 GPT, ~8e-7 ViT), bf16 within
  0.1 (the runs show ~0.03 on logits of magnitude ~3.5: torch rounds a
  fused op once where XLA rounds each bf16 op).
* Training: 4 f32 steps against the JAX step at dp = 1 (a gloo group of
  one) and dp = 2 (two gloo processes importing only the port, against the
  conftest's virtual mesh (2, 1)): losses within 1e-5 relative, parameters
  within 1e-5, except the key projection's bias: its gradient is
  mathematically zero (the softmax is shift-invariant along keys), so
  AdamW normalises rounding noise into steps of up to lr each, in either
  package; it is held within 2 * lr * steps.
* The epoch, run and mixture-run runners equal the step loop exactly (the
  same ops in the same order on the CPU).
"""

import inspect
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from partiallyshuffledistributedsampler_tpu.models import gpt as JG
from partiallyshuffledistributedsampler_tpu.models import train as JT
from partiallyshuffledistributedsampler_tpu.models import vit as JV
from partiallyshuffledistributedsampler_tpu.parallel import (
    sharded_epoch_indices as jax_sharded_epoch_indices,
)
from partiallyshuffledistributedsampler_tpu_torch import MixtureSpec, parallel
from partiallyshuffledistributedsampler_tpu_torch.models import (
    GPTConfig,
    MiniGPT,
    MiniViT,
    ViTConfig,
    create_state,
    demo_training_run,
    demo_vit_run,
    forward,
    gpt_params_from_flax,
    init_params,
    init_vit_params,
    make_epoch_runner,
    make_mixture_run_runner,
    make_run_runner,
    make_train_step,
    make_vit_train_step,
    vit_forward,
    vit_params_from_flax,
)
from partiallyshuffledistributedsampler_tpu_torch.models import train as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL, BF16_TOL = 1e-5, 0.1
STEPS, LR = 4, 3e-4

GPT_SHAPES = {
    "tiny": dict(vocab_size=64, seq_len=16, d_model=32, n_layers=1,
                 n_heads=2, d_ff=64),
    "default": {},  # the JAX package's GPTConfig() mini defaults
}
VIT_SHAPES = {
    "tiny": dict(image_size=16, patch_size=4, d_model=64, n_layers=1,
                 n_heads=2, d_ff=128, num_classes=7),
    "default": {},
}
DTYPES = {"f32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A gloo group of one process on the CPU: the data mesh of dp = 1
    (destroyed afterwards, so no other test file sees a group)."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield parallel.data_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _pair(shape: str, dt: str):
    t, j, _tol = DTYPES[dt]
    kw = GPT_SHAPES[shape]
    return JG.GPTConfig(dtype=j, **kw), GPTConfig(dtype=t, **kw)


def _carried(jcfg, cfg, seed=0):
    params = jax.device_get(JG.init_params(jcfg, jax.random.PRNGKey(seed)))
    model = MiniGPT(cfg)
    model.load_state_dict(gpt_params_from_flax(params), strict=True)
    return params, model


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("shape", list(GPT_SHAPES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_gpt_forward_matches_flax(shape, dt):
    jcfg, cfg = _pair(shape, dt)
    params, model = _carried(jcfg, cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, cfg.seq_len)).astype(np.int32)
    want = np.asarray(JG.forward(jcfg, params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = forward(cfg, model, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (3, cfg.seq_len, cfg.vocab_size)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= DTYPES[dt][2], err


@pytest.mark.parametrize("shape", list(VIT_SHAPES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_vit_forward_matches_flax(shape, dt):
    t, j, tol = DTYPES[dt]
    jcfg = JV.ViTConfig(dtype=j, **VIT_SHAPES[shape])
    cfg = ViTConfig(dtype=t, **VIT_SHAPES[shape])
    params = jax.device_get(JV.init_vit_params(jcfg, jax.random.PRNGKey(1)))
    model = MiniViT(cfg)
    model.load_state_dict(vit_params_from_flax(params), strict=True)
    images = np.random.default_rng(1).normal(
        size=(3, cfg.image_size, cfg.image_size, cfg.channels)
    ).astype(np.float32)
    want = np.asarray(JV.vit_forward(jcfg, params, jnp.asarray(images)))
    with torch.no_grad():
        got = vit_forward(cfg, model, torch.from_numpy(images))
    assert got.dtype == torch.float32
    assert got.shape == (3, cfg.num_classes)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol, err


def test_parameter_names_and_counts_match_flax():
    """The port's modules hold exactly the flax modules' parameters (the
    converters' strict load), with the same element counts."""
    for jcfg, cfg, jinit, init, conv in (
            (JG.GPTConfig(), GPTConfig(), JG.init_params, init_params,
             gpt_params_from_flax),
            (JV.ViTConfig(), ViTConfig(), JV.init_vit_params,
             init_vit_params, vit_params_from_flax)):
        params = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0)))
        model = init(cfg, torch.Generator().manual_seed(0))
        sd = conv(params)
        assert set(sd) == set(model.state_dict())
        for k, v in model.state_dict().items():
            assert v.shape == sd[k].shape and v.dtype == torch.float32, k
        n_flax = sum(int(np.prod(a.shape))
                     for a in jax.tree_util.tree_leaves(params))
        assert n_flax == sum(p.numel() for p in model.parameters())


def test_converters_refuse_unknown_and_missing_keys():
    params = jax.device_get(JG.init_params(JG.GPTConfig(n_layers=1),
                                           jax.random.PRNGKey(0)))
    extra = dict(params, bogus={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="bogus"):
        gpt_params_from_flax(extra)
    missing = {k: v for k, v in params.items() if k != "lnf"}
    with pytest.raises(KeyError, match="lnf"):
        gpt_params_from_flax(missing)
    leaf = dict(params, head={"kernel": params["head"]["kernel"]})
    with pytest.raises(KeyError, match="bias"):
        gpt_params_from_flax(leaf)
    gap = {k: v for k, v in params.items()}
    gap["block2"] = gap.pop("block0")
    with pytest.raises(KeyError, match="block"):
        gpt_params_from_flax(gap)
    vparams = jax.device_get(JV.init_vit_params(JV.ViTConfig(n_layers=1),
                                                jax.random.PRNGKey(0)))
    with pytest.raises(KeyError, match="cls"):
        vit_params_from_flax({k: v for k, v in vparams.items()
                              if k != "cls"})


def test_init_follows_flax_families():
    """Not bit-equal to JAX's PRNG, but the same families: lecun-normal
    kernels (truncated at 2 std), Embed variance 1/d, LayerNorm ones and
    zeros, zero biases and ``cls``; the same seed gives the same model."""
    cfg = GPTConfig(vocab_size=4096, d_model=256, n_layers=1, d_ff=1024)
    a = init_params(cfg, torch.Generator().manual_seed(3))
    b = init_params(cfg, torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    fc1 = a.block0.fc1.weight.detach()
    assert abs(float(fc1.std()) - (1 / 256) ** 0.5) < 0.05 * (1 / 256) ** 0.5
    assert float(fc1.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.8796 + 1e-6
    assert abs(float(a.wte.weight.detach().std()) - (1 / 256) ** 0.5) < 0.002
    assert torch.equal(a.block0.ln1.weight, torch.ones(256))
    assert not a.block0.qkv.bias.any() and not a.lnf.bias.any()
    v = init_vit_params(ViTConfig(), torch.Generator().manual_seed(0))
    assert not v.cls.any()
    fan_in = 3 * 4 * 4
    assert abs(float(v.patch.weight.std()) - fan_in ** -0.5) < 0.1 * \
        fan_in ** -0.5


def test_vit_attention_is_bidirectional():
    """Information from the last patch reaches the cls token."""
    cfg = ViTConfig(**VIT_SHAPES["tiny"])
    model = init_vit_params(cfg, torch.Generator().manual_seed(1))
    imgs = torch.zeros(1, 16, 16, 3)
    imgs2 = imgs.clone()
    imgs2[0, 12:, 12:, :] = 5.0  # the last patch only
    with torch.no_grad():
        assert not torch.allclose(model(imgs), model(imgs2))


def test_config_guards():
    with pytest.raises(ValueError, match="divisible"):
        ViTConfig(image_size=30, patch_size=4)
    assert ViTConfig(image_size=224, patch_size=16).num_patches == 196


def test_adamw_is_optax_adamw():
    sig = inspect.signature(optax.adamw).parameters
    assert T.ADAMW == dict(
        lr=3e-4, betas=(sig["b1"].default, sig["b2"].default),
        eps=sig["eps"].default, weight_decay=sig["weight_decay"].default)
    model = init_params(GPTConfig(**GPT_SHAPES["tiny"]),
                        torch.Generator().manual_seed(0))
    group = T.make_optimizer(model).param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 1e-4)


# --------------------------------------------------------------- training
def _assert_trained_alike(jparams, model, jlosses, losses):
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = gpt_params_from_flax(jax.device_get(jparams))
    for k, v in model.state_dict().items():
        if k.endswith("qkv.bias"):
            d = v.shape[0] // 3
            np.testing.assert_allclose(v[d:2 * d], want[k][d:2 * d],
                                       atol=2 * LR * STEPS)
            v, w = torch.cat([v[:d], v[2 * d:]]), torch.cat(
                [want[k][:d], want[k][2 * d:]])
        else:
            w = want[k]
        np.testing.assert_allclose(v.numpy(), w.numpy(), atol=1e-5,
                                   err_msg=k)


def _jax_steps(jcfg, jmesh, tokens, n, window, seed, batch, epoch=0):
    params, opt_state, tx = JT.create_sharded_state(jcfg, jmesh, 3)
    start = jax.device_get(params)
    step = JT.make_train_step(jcfg, tx, jmesh, batch)
    idx = jax_sharded_epoch_indices(jmesh, n, window, seed, epoch,
                                    axis="dp")
    losses = []
    for s in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(tokens), idx,
                                       jnp.int32(s))
        losses.append(float(loss))
    return start, params, losses, np.asarray(idx)


TRAIN = dict(n=256, window=32, seed=7, batch=4)


def _tokens(cfg):
    return np.random.default_rng(5).integers(
        0, cfg.vocab_size, (TRAIN["n"], cfg.seq_len + 1)).astype(np.int32)


def test_train_step_matches_jax_dp1(mesh):
    jcfg, cfg = _pair("tiny", "f32")
    tokens = _tokens(cfg)
    start, jparams, jlosses, jidx = _jax_steps(
        jcfg, JT.make_mesh(1, tp=1), tokens, TRAIN["n"], TRAIN["window"],
        TRAIN["seed"], TRAIN["batch"])
    model, opt = create_state(cfg, mesh, 3)
    model.load_state_dict(gpt_params_from_flax(start), strict=True)
    step = make_train_step(cfg, opt, mesh, TRAIN["batch"])
    idx = parallel.sharded_epoch_indices(TRAIN["n"], TRAIN["window"],
                                         TRAIN["seed"], 0, mesh=mesh)
    np.testing.assert_array_equal(idx.numpy(), jidx[0])
    losses = [float(step(model, torch.from_numpy(tokens), idx, s))
              for s in range(STEPS)]
    _assert_trained_alike(jparams, model, jlosses, losses)


def test_vit_train_step_matches_jax_dp1(mesh):
    cfgs = dict(VIT_SHAPES["tiny"])
    jcfg = JV.ViTConfig(dtype=jnp.float32, **cfgs)
    cfg = ViTConfig(dtype=torch.float32, **cfgs)
    rng = np.random.default_rng(2)
    images = rng.normal(size=(128, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, 128).astype(np.int32)
    jmesh = JT.make_mesh(1, tp=1)
    params = JV.init_vit_params(jcfg, jax.random.PRNGKey(4))
    start = jax.device_get(params)
    tx = optax.adamw(3e-4)
    opt_state = tx.init(params)
    jstep = JV.make_vit_train_step(jcfg, tx, jmesh, 4)
    jidx = jax_sharded_epoch_indices(jmesh, 128, 16, 9, 1, axis="dp")
    model = MiniViT(cfg)
    model.load_state_dict(vit_params_from_flax(start), strict=True)
    opt = T.make_optimizer(model)
    step = make_vit_train_step(cfg, opt, mesh, 4)
    idx = parallel.sharded_epoch_indices(128, 16, 9, 1, mesh=mesh)
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    for s in range(STEPS):
        params, opt_state, jl = jstep(params, opt_state, jnp.asarray(images),
                                      jnp.asarray(labels), jidx, s)
        loss = step(model, ti, tl, idx, s)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = vit_params_from_flax(jax.device_get(params))
    for k, v in model.state_dict().items():
        d = cfg.d_model
        if k.endswith("qkv.bias"):  # the key bias: see the module notes
            v, w = torch.cat([v[:d], v[2 * d:]]), torch.cat(
                [want[k][:d], want[k][2 * d:]])
        else:
            w = want[k]
        np.testing.assert_allclose(v.numpy(), w.numpy(), atol=1e-5,
                                   err_msg=k)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    n, window, seed, batch, steps = eval(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    from partiallyshuffledistributedsampler_tpu_torch import parallel
    from partiallyshuffledistributedsampler_tpu_torch.models import (
        GPTConfig, create_state, gpt_params_from_flax, make_train_step)

    tree = {}
    for key, a in np.load(f"{out}/params.npz").items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    tokens = torch.from_numpy(np.load(f"{out}/tokens.npy"))
    cfg = GPTConfig(vocab_size=64, seq_len=16, d_model=32, n_layers=1,
                    n_heads=2, d_ff=64, dtype=torch.float32)
    mesh = parallel.data_mesh(device="cpu")
    model, opt = create_state(cfg, mesh, 3)
    model.load_state_dict(gpt_params_from_flax(tree), strict=True)
    step = make_train_step(cfg, opt, mesh, batch)
    idx = parallel.sharded_epoch_indices(n, window, seed, 0, mesh=mesh)
    losses = [float(step(model, tokens, idx, s)) for s in range(steps)]
    np.savez(f"{out}/rank{rank}.npz", losses=np.array(losses),
             idx=idx.numpy(),
             **{k: v.numpy() for k, v in model.state_dict().items()})
    dist.destroy_process_group()
    print(f"TRAIN_OK rank={rank}")
""")


def test_train_step_matches_jax_dp2(tmp_path):
    """Two gloo processes (dp = 2, each importing only the port) against
    the JAX step on the conftest's virtual mesh (2, 1)."""
    jcfg, cfg = _pair("tiny", "f32")
    tokens = _tokens(cfg)
    jmesh = JT.make_mesh(2, tp=1)
    assert dict(jmesh.shape) == {"dp": 2, "tp": 1}
    start, jparams, jlosses, jidx = _jax_steps(
        jcfg, jmesh, tokens, TRAIN["n"], TRAIN["window"], TRAIN["seed"],
        TRAIN["batch"])
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(start)[0]}
    np.savez(tmp_path / "params.npz", **flat)
    np.save(tmp_path / "tokens.npy", tokens)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    arg = repr((TRAIN["n"], TRAIN["window"], TRAIN["seed"], TRAIN["batch"],
                STEPS))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(tmp_path), arg],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT),
                                OMP_NUM_THREADS="2"))
        for r in (0, 1)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=180))
    except subprocess.TimeoutExpired:
        pytest.fail("the gloo workers did not finish in 180 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
        assert "TRAIN_OK" in stdout
    for r in (0, 1):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_array_equal(res.pop("idx"), jidx[r])
        losses = res.pop("losses")
        model = MiniGPT(cfg)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in res.items()})
        _assert_trained_alike(jparams, model, jlosses, losses)


# ---------------------------------------------------------------- runners
RUN = dict(n_samples=64, window=16, batch_per_dp=2, steps_per_epoch=2,
           epochs=2)
TINY = GPTConfig(**GPT_SHAPES["tiny"])


def test_runners_equal_the_step_loop(mesh):
    stepped = demo_training_run(mesh, TINY, **RUN)
    scanned = demo_training_run(mesh, TINY, scan_epochs=True, **RUN)
    whole = demo_training_run(mesh, TINY, one_program=True, **RUN)
    assert len(stepped) == 4 and all(np.isfinite(stepped))
    assert scanned == stepped
    assert whole == stepped
    # a fixed config reruns bit-identically
    assert demo_training_run(mesh, TINY, **RUN) == stepped


def test_run_runner_shape_and_first_epoch(mesh):
    model, opt = create_state(TINY, mesh, 1)
    tokens = T.synthetic_tokens(TINY, 64, 2, "cpu")
    run = make_run_runner(TINY, opt, mesh, 2, 3, 2, 64, 16)
    losses = run(model, tokens, parallel.make_seed_triple(4, 0, mesh=mesh), 5)
    assert losses.shape == (2, 3)
    # the same epochs by hand: epoch 5 and 6 through the epoch runner
    model2, opt2 = create_state(TINY, mesh, 1)
    epoch_run = make_epoch_runner(TINY, opt2, mesh, 2, 3)
    manual = [epoch_run(model2, tokens, parallel.sharded_epoch_indices(
        64, 16, 4, e, mesh=mesh)) for e in (5, 6)]
    assert torch.equal(losses, torch.stack(manual))


def test_mixture_run_runner_equals_manual_epochs(mesh):
    spec = MixtureSpec([60, 40, 20], [3, 2, 1], windows=8, block=12)
    tokens = T.synthetic_tokens(TINY, spec.total_sources_len, 2, "cpu")
    model, opt = create_state(TINY, mesh, 3)
    run = make_mixture_run_runner(TINY, opt, mesh, 2, 2, 2, spec)
    whole = run(model, tokens, parallel.make_seed_triple(5, 0, mesh=mesh), 0)
    model2, opt2 = create_state(TINY, mesh, 3)
    epoch_run = make_epoch_runner(TINY, opt2, mesh, 2, 2)
    manual = [epoch_run(model2, tokens, parallel.sharded_mixture_indices(
        spec, 5, e, mesh=mesh)) for e in (0, 1)]
    assert whole.shape == (2, 2)
    assert torch.equal(whole, torch.stack(manual))
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, q)


def test_run_guards(mesh):
    model, opt = create_state(TINY, mesh, 0)
    for steps in (0, 33):  # 64 samples / batch 2 = 32 whole steps
        with pytest.raises(ValueError, match="steps_per_epoch"):
            make_run_runner(TINY, opt, mesh, 2, steps, 1, 64, 16)
    with pytest.raises(TypeError):
        make_run_runner(TINY, opt, mesh, 2, 1, 1, 64, 16,
                        sampler_kwargs={"bogus": 1})
    with pytest.raises(ValueError, match="samples/rank"):
        demo_vit_run(mesh, ViTConfig(**VIT_SHAPES["tiny"]), n_samples=128,
                     batch_per_dp=4, steps_per_epoch=50)
    with pytest.raises(ValueError, match="built for"):
        forward(GPTConfig(), model, torch.zeros(1, 4, dtype=torch.long))


def test_demo_vit_run_trains(mesh):
    """32 images seen 5 times over: each epoch's mean loss is below the
    one before (a single step's loss at batch 8 is too noisy to order)."""
    losses = demo_vit_run(mesh, ViTConfig(**VIT_SHAPES["tiny"]),
                          n_samples=32, window=16, batch_per_dp=8,
                          steps_per_epoch=4, epochs=5)
    assert len(losses) == 20 and all(np.isfinite(losses))
    means = np.asarray(losses).reshape(5, 4).mean(axis=1)
    assert (np.diff(means) < 0).all(), means


def test_demo_training_run_falls(mesh):
    losses = demo_training_run(mesh, TINY, n_samples=32, window=16,
                               batch_per_dp=8, steps_per_epoch=4, epochs=5,
                               one_program=True)
    assert len(losses) == 20 and all(np.isfinite(losses))
    means = np.asarray(losses).reshape(5, 4).mean(axis=1)
    assert (np.diff(means) < 0).all(), means
