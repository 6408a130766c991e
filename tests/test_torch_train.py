"""The port's training slice against the JAX package's, on the CPU.

The same numpy weights and batches go through both packages:
- ``llama.forward`` logits, ``loss_fn`` and every gradient on
  ``LlamaConfig.tiny()`` against the JAX forward and ``jax.grad``, with the
  JAX side attending through its Pallas flash kernel (interpret mode) and
  through its XLA path; fp32, tolerances stated where used;
- activation checkpointing (``full``, ``dots_saveable``) against none;
- adamw, adam with weight decay and sgd: 5 updates against optax;
- every learning-rate schedule against the JAX schedules;
- ``update_loss_scale`` over a scripted finite/overflow sequence;
- an 8-step loss trajectory of ``Engine.train_batch`` against the JAX
  ``Engine`` (same weights through ``initial_params``, same batches, GAS 2,
  clipping 1.0, remat on), in fp32 and in bf16;
- a non-finite step skips, as in JAX.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.config.config import load_config as jax_load_config
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.ops.optimizers import build_optimizer as jax_build_optimizer
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import precision as jax_precision
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime import lr_schedules, precision
from deepspeed_tpu_torch.runtime.engine import initialize, resolve_remat_policy

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: under pytest-xdist every
    worker would otherwise start as many as the host has cores, and the
    engines' many small ops spend most of their time contending for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    p = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    # copies, not views: a numpy view keeps its JAX buffer in jax.live_arrays()
    return jax.tree_util.tree_map(np.array, p)


def _ids(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s), dtype=np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _torch_params(np_params):
    params = params_from_numpy(np_params, torch.float32)
    for leaf in _leaves(params).values():
        leaf.requires_grad_(True)
    return params


# --------------------------------------------------------------- model
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_forward_loss_and_grads_match_jax(np_params, jax_impl):
    """fp32. Logits 2e-5 and loss 1e-5 absolute; gradients 1e-5 absolute
    plus 1e-4 relative: summation order differs (the port's plain flash
    path vs Pallas interpret mode or XLA's einsums)."""
    ids = _ids()
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    want_logits = jax_llama.forward(JCFG, jp, jnp.asarray(ids), attn_impl=jax_impl)
    jspec = jax_llama.build(JCFG, attn_impl=jax_impl)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jspec.loss_fn(p, {"input_ids": jnp.asarray(ids)}))(jp)

    params = _torch_params(np_params)
    batch = {"input_ids": torch.from_numpy(ids)}
    logits = llama.forward(CFG, params, batch["input_ids"])
    loss = llama.build(CFG).loss_fn(params, batch)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    got = _leaves(params)
    for name, w in _leaves(want_grads).items():
        np.testing.assert_allclose(got[name].grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_remat_gives_the_same_grads(np_params, policy):
    """Per-layer checkpointing recomputes the layer in the backward (the
    flash forward runs again: 2 calls per layer instead of 1) and yields the
    same gradients, bit for bit, as no checkpointing."""
    batch = {"input_ids": torch.from_numpy(_ids(1))}
    grads, calls = {}, {}
    for remat in (False, True):
        params = _torch_params(np_params)
        spec = llama.build(CFG, remat=remat, remat_policy=resolve_remat_policy(policy))
        fa.reset_counts()
        spec.loss_fn(params, batch).backward()
        calls[remat] = fa.flash_attention_fwd_ref.calls
        grads[remat] = {k: v.grad for k, v in _leaves(params).items()}
    assert calls == {False: CFG.num_layers, True: 2 * CFG.num_layers}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("case", ["shifted", "labels_ignore", "z_loss"])
def test_causal_lm_loss_matches_jax(case):
    """fp32, 1e-6 relative: one logsumexp and one gather on each side."""
    from deepspeed_tpu.models.api import causal_lm_loss as jax_loss
    from deepspeed_tpu_torch.models.api import causal_lm_loss

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 9, 33)).astype(np.float32) * 3
    ids = rng.integers(0, 33, (2, 9)).astype(np.int32)
    labels = None
    kw = {"z_loss": 1e-3} if case == "z_loss" else {}
    if case == "labels_ignore":
        labels = rng.integers(0, 33, (2, 9)).astype(np.int32)
        labels[0, :4] = -100
    want = jax_loss(jnp.asarray(logits), jnp.asarray(ids),
                    None if labels is None else jnp.asarray(labels), **kw)
    got = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                         None if labels is None else torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ----------------------------------------------------------- optimizers
OPTIMIZERS = {
    "adamw": {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                          "betas": [0.8, 0.99], "eps": 1e-6}},
    "adam_wd": {"type": "adam", "params": {"lr": 1e-2, "weight_decay": 0.05}},
    "sgd": {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.9}},
    "sgd_nesterov": {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.9,
                                               "nesterov": True}},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """5 updates of two leaves; rtol 2e-6: both sides are fp32 and round
    each elementwise step, in a possibly different association."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (11,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    cfg = {"train_batch_size": 1, "optimizer": OPTIMIZERS[name]}

    jtx = jax_build_optimizer(jax_load_config(cfg).optimizer)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    ttx = build_optimizer(load_config(cfg).optimizer)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tp)
    for g in grads:
        jupd, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update([torch.from_numpy(x) for x in g], tstate, tp)
        torch._foreach_add_(tp, tupd)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)


# ------------------------------------------------------------ schedules
SCHEDULES = {
    "none": None,
    "WarmupLR_log": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-5,
                                                    "warmup_max_lr": 1e-3,
                                                    "warmup_num_steps": 10}},
    "WarmupLR_linear": {"type": "WarmupLR", "params": {"warmup_num_steps": 7,
                                                       "warmup_type": "linear"}},
    "WarmupDecayLR": {"type": "WarmupDecayLR", "params": {"total_num_steps": 30,
                                                          "warmup_num_steps": 5}},
    "WarmupCosineLR": {"type": "WarmupCosineLR", "params": {
        "total_num_steps": 30, "warmup_num_steps": 5, "warmup_min_ratio": 0.1,
        "cos_min_ratio": 0.01}},
    "OneCycle": {"type": "OneCycle", "params": {
        "cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 8,
        "cycle_second_step_size": 6, "decay_step_size": 3, "decay_lr_rate": 0.5}},
    "LRRangeTest": {"type": "LRRangeTest", "params": {
        "lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 4,
        "lr_range_test_step_rate": 2.0, "lr_range_test_staircase": True}},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    """Steps 0..39; rtol 5e-6: JAX evaluates in fp32, the port in Python
    floats (fp32's cos of a progress near 1 keeps fewer digits, 1.2e-6
    relative at worst here)."""
    cfg = {"train_batch_size": 1, "optimizer": {"type": "adamw", "params": {"lr": 3e-3}}}
    if SCHEDULES[name] is not None:
        cfg["scheduler"] = SCHEDULES[name]
    jsched = jax_lr.build_schedule(jax_load_config(cfg).scheduler, 3e-3)
    tsched = lr_schedules.build_schedule(load_config(cfg).scheduler, 3e-3)
    want = [float(jsched(jnp.int32(s))) for s in range(40)]
    got = [tsched(s) for s in range(40)]
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=1e-12)


@pytest.mark.parametrize("fp16", [
    {"enabled": True, "initial_scale_power": 4, "hysteresis": 2, "loss_scale_window": 3},
    {"enabled": True, "initial_scale_power": 2, "hysteresis": 1, "loss_scale_window": 2,
     "min_loss_scale": 2.0},
    {"enabled": True, "loss_scale": 128.0},
    {"enabled": False},
], ids=["hysteresis", "min_scale", "static", "off"])
def test_loss_scale_matches_jax(fp16):
    cfg = {"train_batch_size": 1, "fp16": fp16}
    if not fp16["enabled"]:
        cfg["bf16"] = {"enabled": False}
    jcfg, tcfg = jax_load_config(cfg).fp16, load_config(cfg).fp16
    js, ts = jax_precision.init_loss_scale(jcfg), precision.init_loss_scale(tcfg)
    script = [True, False, True, True, True, False, False, False, True, True, True, True,
              False, True, True, True]
    for finite in script:
        js = jax_precision.update_loss_scale(js, jnp.asarray(finite), jcfg)
        ts = precision.update_loss_scale(ts, torch.tensor(finite), tcfg)
        assert float(ts.scale) == float(js.scale)
        assert int(ts.good_steps) == int(js.good_steps)
        assert int(ts.hysteresis) == int(js.hysteresis)


def test_grads_finite():
    assert bool(precision.grads_finite([torch.ones(3), torch.zeros(2, 2)]))
    assert not bool(precision.grads_finite([torch.ones(3), torch.tensor([1.0, float("inf")])]))
    assert not bool(precision.grads_finite([torch.tensor([float("nan")])]))


# ------------------------------------------------------ engine trajectory
def _train_config(bf16: bool, extra=None):
    cfg = {
        "train_micro_batch_size_per_device": 2, "gradient_accumulation_steps": 2,
        "steps_per_print": 0, "gradient_clipping": 1.0, "sequence_length": S,
        "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                     "warmup_max_lr": 3e-3}},
        "mesh": {"data": 1}, "bf16": {"enabled": bf16},
        "activation_checkpointing": {"enabled": True, "policy": "dots_saveable"},
    }
    cfg.update(extra or {})
    return cfg


def _run_both(np_params, config, steps):
    batches = [{"input_ids": _ids(100 + i, b=4)} for i in range(steps)]
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=lambda ctx: jax_llama.build(JCFG, ctx=ctx), config=copy.deepcopy(config),
        initial_params=np_params, mesh_devices=jax.devices()[:1])
    teng, _, _, _ = initialize(model=partial(llama.build, CFG), config=copy.deepcopy(config),
                               initial_params=np_params, device="cpu")
    jl = [float(jeng.train_batch(b)) for b in batches]
    tl = [float(teng.train_batch(b)) for b in batches]
    return jeng, teng, np.asarray(jl), np.asarray(tl)


def _max_param_diff(jeng, teng):
    got = _leaves(teng.module_state())
    return max(float(np.abs(got[k].detach().numpy() - np.asarray(w)).max())
               for k, w in _leaves(jeng.module_state()).items())


def test_trajectory_matches_jax_engine_fp32(np_params):
    """fp32, 8 steps: losses rtol 1e-5, final params max abs 1e-5."""
    jeng, teng, jl, tl = _run_both(np_params, _train_config(bf16=False), 8)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert _max_param_diff(jeng, teng) < 1e-5
    assert teng.global_steps == jeng.global_steps == 8
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert teng.get_global_grad_norm() == pytest.approx(jeng.get_global_grad_norm(), rel=1e-4)


def test_trajectory_matches_jax_engine_bf16(np_params):
    """bf16 compute over fp32 masters, 8 steps. Drift bound: losses within
    1e-3 relative (measured 6e-5), and the parameter updates (final minus
    initial, all leaves) within 0.1 relative Frobenius norm (measured 0.014).
    Both sides round activations and gradients to bf16 at different places
    (torch widens inside ops such as silu that XLA keeps in bf16); Adam
    turns a gradient whose bf16 sign differs into an update of the opposite
    sign, so parameters drift more than losses."""
    jeng, teng, jl, tl = _run_both(np_params, _train_config(bf16=True), 8)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    start, got = _leaves(np_params), _leaves(teng.module_state())
    diff = norm = 0.0
    for name, w in _leaves(jeng.module_state()).items():
        want_step = np.asarray(w) - start[name]
        diff += float(np.sum((got[name].detach().numpy() - start[name] - want_step) ** 2))
        norm += float(np.sum(want_step ** 2))
    assert (diff / norm) ** 0.5 < 0.1


def test_nonfinite_steps_skip_like_jax(np_params):
    """fp16 with a loss scale of 2**32 overflows every gradient: both steps
    skip, the first eats the hysteresis and the second halves the scale;
    params and optimizer state stay as they were."""
    config = _train_config(bf16=False, extra={
        "bf16": {"enabled": False},
        "fp16": {"enabled": True, "initial_scale_power": 32, "hysteresis": 2},
        "activation_checkpointing": {"enabled": False}})
    jeng, teng, jl, tl = _run_both(np_params, config, 2)
    assert teng.skipped_steps == jeng.skipped_steps == 2
    assert teng.loss_scale == jeng.loss_scale == 2.0 ** 31
    assert teng.opt_state.count == 0
    start = _leaves(np_params)
    for name, leaf in _leaves(teng.module_state()).items():
        np.testing.assert_array_equal(leaf.detach().numpy(), start[name], err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def test_initialize_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(model=partial(llama.build, CFG), config={"train_batch_size": 2})
