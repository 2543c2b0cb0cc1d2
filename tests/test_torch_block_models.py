"""The port's decoder over the other block kinds against the reference, on
the CPU at smoke size: Mixtral-8x7B (sliding window, MoE top-2), Llama-4
Maverick (dense and MoE layers alternating, top-1), Qwen2-VL (M-RoPE),
RecurrentGemma (RG-LRU, local attention, tied embeddings, a remainder
layer) and RWKV6 (time-mix and channel-mix).

The reference's weights come over through ``models.convert.params_from_jax``
(its gradients and caches too), the norm scales and biases made random so
they act.  Both packages compute in float32 unless a case says bf16, with
the dense tests' tolerances (``tests/test_torch_models.py``):

* ``train_loss``, its ``ce_loss`` and ``moe_aux`` within 1e-5 (bf16 2e-2),
  every gradient within 1e-4 (float32), at 64 tokens, past the smoke
  windows of 32 (the reference's banded schedule);
* all ten ids' configs, full and smoke, equal the reference's, and each
  model builds with the reference's parameter shapes.

Prefill and decode of the same configs: ``tests/test_torch_block_decode.py``.
No bf16 routing flip between the packages shows at these seeds: the MoE
configs' bf16 cases meet the same tolerances as the others.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.pytree import flatten_with_path, leaves

BLOCKS = ["mixtral-8x7b", "llama4-maverick-400b-a17b", "qwen2-vl-7b", "recurrentgemma-2b",
          "rwkv6-1.6b"]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = 1e-4
CASES = [(a, dt) for a in BLOCKS for dt in ("float32", "bfloat16")]
CASE_IDS = [f"{a}-{dt}" for a, dt in CASES]
RANDOM_LEAVES = ("ln1", "ln2", "final_ln", "conv_b")


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    cfg = RC.get_config(arch, smoke=True)
    return jax.tree.map(np.asarray, RM.build_model(cfg).init(jax.random.PRNGKey(0)))


def _pair(arch, compute_dtype, seed=0):
    """The reference's smoke model, its parameters as numpy (norm scales and
    conv biases random), and the port's config and parameters."""
    cfg = RC.get_config(arch, smoke=True).replace(compute_dtype=compute_dtype)
    rng = np.random.default_rng(seed)

    def randomize(path, x):
        name = getattr(path[-1], "key", "")
        if name in RANDOM_LEAVES:
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        return np.copy(x)

    tree = jax.tree_util.tree_map_with_path(randomize, _ref_init(arch))
    port_cfg = get_config(arch, smoke=True).replace(compute_dtype=compute_dtype)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    return RM.build_model(cfg), tree, port_cfg, params_from_jax(tree, port_cfg)


def _ref_fn(fn, compute_dtype):
    return jax.jit(fn) if compute_dtype == "float32" else fn


def _batch(vocab, b=2, s=64, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[:, -3:] = 0.0
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _as_ref_layout(cache, cfg):
    """The port's cache (one per layer, or stacked) in the reference's
    layout: ``scan/pos{j}`` stacked over the groups, ``rem{j}``."""
    per = [transformer.layer_cache(cache, i) for i in range(cfg.num_layers)]
    p, g = cfg.pattern_period, cfg.scan_groups
    out = {}
    if g:
        out["scan"] = {f"pos{j}": type(per[j])(*(torch.stack([per[i * p + j][f] for i in range(g)])
                                                 for f in range(len(per[j]))))
                       for j in range(p)}
    for j in range(len(cfg.remainder_kinds)):
        out[f"rem{j}"] = per[g * p + j]
    return out


def _close_trees(mine, theirs, tol, scaled, what):
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    ours = flatten_with_path(mine)
    assert len(ours) == len(flat), what
    for (path, m), (rpath, r) in zip(ours, flat):
        r = np.asarray(r, np.float32)
        scale = max(1.0, float(np.abs(r).max())) if scaled else 1.0
        np.testing.assert_allclose(m.float().numpy(), r, atol=tol * scale,
                                   err_msg=f"{what} {'/'.join(path)}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_matches_reference_and_builds(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(RC.get_config(arch, smoke))
    params = build_model(get_config(arch, smoke=True)).init(torch.Generator().manual_seed(0))
    ref = jax.tree.map(lambda x: x.shape, _ref_init(arch))
    assert [tuple(t.shape) for t in leaves(params)] == \
        [tuple(s) for s in jax.tree.leaves(ref, is_leaf=lambda x: isinstance(x, tuple))]


@pytest.mark.parametrize("arch,compute_dtype", CASES, ids=CASE_IDS)
def test_train_loss_and_grads_match_reference(arch, compute_dtype):
    ref, tree, cfg, params = _pair(arch, compute_dtype)
    batch = _batch(cfg.vocab_size)
    args = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch)
    if compute_dtype == "float32":
        (want, want_m), want_g = jax.jit(jax.value_and_grad(ref.train_loss, has_aux=True))(*args)
    else:
        want, want_m = ref.train_loss(*args)
    for t in leaves(params):
        t.requires_grad_(True)
    got, got_m = build_model(cfg).train_loss(params, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    tol = LOSS_TOL[compute_dtype]
    for a, b in ((got, want), (got_m["ce_loss"], want_m["ce_loss"]),
                 (got_m["moe_aux"], want_m["moe_aux"])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.item(), float(b), rtol=tol, atol=tol)
    assert (got_m["moe_aux"].item() > 0) == (cfg.num_experts > 0)
    got.backward()
    assert all(t.grad is not None and t.grad.dtype == torch.float32 for t in leaves(params))
    if compute_dtype != "float32":
        return
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g), cfg)
    for (path, t), w in zip(flatten_with_path(params), leaves(want_g)):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=GRAD_TOL, err_msg="/".join(path))
