"""The port's checkpoints (``repro_torch.ckpt.checkpoint``): the reference's
four tests of ``tests/test_checkpoint.py`` on the port, and what only the
port must do: bf16 leaves round-trip bit for bit (stored as their uint16
bits), ``save(..., async_save=True)`` copies every leaf before it returns,
leaf names and manifests follow the reference's rule, a checkpoint the
reference's ``save`` wrote restores, and a leaf of another shape is
refused."""

import json
import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.pytree import leaves, tree_map


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(5)},
            "opt": (torch.zeros(3), torch.full((2, 2), 7.0))}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    ckpt.save(d, 3, tree, extra={"note": "hi"})
    assert ckpt.latest_step(d) == 3
    out = ckpt.restore(d, 3, tree_map(lambda t: torch.empty_like(t, device="meta"), tree))
    for a, b in zip(leaves(tree), leaves(out)):
        assert b.device.type == "cpu" and torch.equal(a, b)
    placed = ckpt.restore(d, 3, tree, device="cpu")  # the reference's ``shardings``
    assert all(torch.equal(a, b) for a, b in zip(leaves(tree), leaves(placed)))
    assert ckpt.restore_extra(d, 3)["note"] == "hi"


def test_latest_ignores_incomplete(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_9"))  # crashed save: no manifest
    assert ckpt.latest_step(d) == 1


def test_async_save_joins(tmp_path):
    d = str(tmp_path)
    t = ckpt.save(d, 5, _tree(), async_save=True)
    assert isinstance(t, threading.Thread)
    t.join(10)
    assert not t.is_alive()
    assert ckpt.latest_step(d) == 5


def test_multiple_steps_pick_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 7, 4):
        ckpt.save(d, s, _tree())
    assert ckpt.latest_step(d) == 7


def test_bf16_leaves_roundtrip_bit_for_bit(tmp_path):
    d = str(tmp_path)
    g = torch.Generator().manual_seed(0)
    tree = {"m": torch.randn(4, 33, generator=g).to(torch.bfloat16),
            "s": torch.tensor(-3.5, dtype=torch.bfloat16),
            "special": torch.tensor([float("inf"), -0.0, float("nan"), 1e-40]).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(d, 2, tree)
    manifest = json.load(open(os.path.join(d, "step_2", "manifest.json")))
    assert {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]} == \
        {"m": "bfloat16", "s": "bfloat16", "special": "bfloat16", "step": "int32"}
    assert np.load(os.path.join(d, "step_2", "m.npy")).dtype == np.uint16
    out = ckpt.restore(d, 2, tree)
    for key, t in tree.items():
        assert out[key].dtype == t.dtype and out[key].shape == t.shape
        assert torch.equal(out[key].view(torch.int16) if t.dtype == torch.bfloat16 else out[key],
                           t.view(torch.int16) if t.dtype == torch.bfloat16 else t)


def test_async_save_copies_before_it_returns(tmp_path):
    """An in-place change after ``save`` returns (an optimizer step) does not
    reach the files the writer thread is still writing."""
    d = str(tmp_path)
    big = torch.zeros(1 << 20)
    tree = {"a": big, "b": torch.zeros(3, dtype=torch.bfloat16)}
    t = ckpt.save(d, 1, tree, async_save=True)
    big.add_(1.0)
    tree["b"].fill_(2.0)
    t.join(30)
    out = ckpt.restore(d, 1, tree)
    assert not out["a"].any() and not out["b"].float().any()


def test_leaf_names_follow_the_reference(tmp_path):
    """Dict keys sorted, tuple indices and NamedTuple fields joined by ``__``:
    the same file names as the reference's for the same tree."""
    from repro_torch.train.optimizer import AdamWState

    mine = {"params": {"w": torch.ones(2, 2), "layers": {"b": torch.ones(1)}},
            "opt": AdamWState(torch.tensor(1, dtype=torch.int32), {"w": torch.ones(2)},
                              {"w": torch.ones(2)}),
            "t": (torch.ones(1), torch.ones(1))}
    from repro.train.optimizer import AdamWState as RefState
    theirs = {"params": {"w": jnp.ones((2, 2)), "layers": {"b": jnp.ones(1)}},
              "opt": RefState(jnp.int32(1), {"w": jnp.ones(2)}, {"w": jnp.ones(2)}),
              "t": (jnp.ones(1), jnp.ones(1))}
    ckpt.save(str(tmp_path / "port"), 1, mine)
    ref_ckpt.save(str(tmp_path / "ref"), 1, theirs)
    names = [sorted(os.listdir(tmp_path / which / "step_1")) for which in ("port", "ref")]
    assert names[0] == names[1]
    manifests = [json.load(open(tmp_path / which / "step_1" / "manifest.json"))["leaves"]
                 for which in ("port", "ref")]
    assert manifests[0] == manifests[1]


def test_restore_refuses_another_shape(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 1, {"w": torch.zeros(4, 3)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(d, 1, {"v": torch.zeros(3, 4)})


def test_reference_checkpoint_restores(tmp_path):
    """A tree the reference's ``ckpt.save`` wrote (float32, int32 and bf16
    leaves, a NamedTuple, nested dicts) restores into the port's tensors of
    the same structure, bit for bit, with its ``extra``."""
    from repro.train.optimizer import AdamWState as RefState
    from repro_torch.train.optimizer import AdamWState

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    mu = rng.standard_normal(5).astype(np.float32)
    theirs = {"params": {"w": jnp.asarray(w), "layers": {"b": jnp.arange(6, dtype=jnp.int32)}},
              "opt": RefState(jnp.int32(4), {"w": jnp.asarray(mu).astype(jnp.bfloat16)},
                              {"w": jnp.asarray(mu ** 2)})}
    ref_ckpt.save(str(tmp_path), 4, theirs, extra={"losses": [1.5], "step": 4})
    like = {"params": {"w": torch.zeros(3, 4), "layers": {"b": torch.zeros(6, dtype=torch.int32)}},
            "opt": AdamWState(torch.tensor(0, dtype=torch.int32),
                              {"w": torch.zeros(5, dtype=torch.bfloat16)}, {"w": torch.zeros(5)})}
    assert ckpt.latest_step(str(tmp_path)) == 4
    out = ckpt.restore(str(tmp_path), 4, like)
    assert torch.equal(out["params"]["w"], torch.from_numpy(w))
    assert torch.equal(out["params"]["layers"]["b"], torch.arange(6, dtype=torch.int32))
    assert isinstance(out["opt"], AdamWState) and int(out["opt"].step) == 4
    assert out["opt"].mu["w"].dtype == torch.bfloat16
    want_mu = mu.astype(ml_dtypes.bfloat16).view(np.int16)
    assert torch.equal(out["opt"].mu["w"].view(torch.int16), torch.from_numpy(want_mu))
    assert torch.equal(out["opt"].nu["w"], torch.from_numpy(mu ** 2))
    assert ckpt.restore_extra(str(tmp_path), 4) == {"losses": [1.5], "step": 4}


def _block_tree(arch):
    """A smoke model's parameters and its AdamW state after one update (so
    the moments are not zero)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamW

    cfg = get_config(arch, smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=1e-2, warmup_steps=1)
    gen = torch.Generator().manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    _, state = opt.update(grads, opt.init(params), params)
    return cfg, {"params": params, "opt": state}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-2b"])
def test_block_model_trees_roundtrip(tmp_path, arch):
    """A MoE tree (Mixtral: experts stacked under ``scan/pos0/mlp``) and one
    with remainder layers (RecurrentGemma: ``scan/pos{0,1,2}`` and ``rem0``)
    with their AdamW state round-trip bit for bit, under the reference's leaf
    names (its ``save`` of its own tree of the same config)."""
    import jax
    import repro.configs as RC
    import repro.models as RM
    import repro.train.optimizer as RO

    cfg, tree = _block_tree(arch)
    ckpt.save(str(tmp_path / "port"), 1, tree)
    out = ckpt.restore(str(tmp_path / "port"), 1,
                       tree_map(lambda t: torch.empty_like(t, device="meta"), tree))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves(tree), leaves(out)))
    rp = RM.build_model(RC.get_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    ref_ckpt.save(str(tmp_path / "ref"), 1, {"params": rp, "opt": RO.AdamW().init(rp)})
    names = [sorted(os.listdir(tmp_path / which / "step_1")) for which in ("port", "ref")]
    assert names[0] == names[1]
    if arch == "recurrentgemma-2b":
        assert "params__rem0__mixer__lam.npy" in names[0]


def test_earlier_dense_layout_restores(tmp_path):
    """A dense checkpoint in the port's earlier layout (every layer weight
    stacked under ``layers``) restores into today's ``scan/pos0`` layout,
    bit for bit; a leaf that neither layout holds is still refused by
    name."""
    from repro_torch.train.optimizer import AdamWState

    _, tree = _block_tree("tinyllama-1.1b")

    def earlier(p):
        layer = p["scan"]["pos0"]
        return {"embed": p["embed"], "unembed": p["unembed"], "final_ln": p["final_ln"],
                "layers": {"ln1": layer["ln1"], "ln2": layer["ln2"], **layer["mixer"],
                           **layer["mlp"]}}

    opt = tree["opt"]
    old = {"params": earlier(tree["params"]),
           "opt": AdamWState(opt.step, earlier(opt.mu), earlier(opt.nu))}
    ckpt.save(str(tmp_path), 5, old)
    assert "params__layers__wq.npy" in os.listdir(tmp_path / "step_5")
    out = ckpt.restore(str(tmp_path), 5, tree)
    assert all(torch.equal(a, b) for a, b in zip(leaves(tree), leaves(out)))
    with pytest.raises(KeyError, match="missing leaf params__scan__pos1__ln1"):
        ckpt.restore(str(tmp_path), 5, {"params": {"scan": {"pos1": {"ln1": torch.zeros(2)}}}})
