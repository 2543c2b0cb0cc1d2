"""The port's partition rules (``repro_torch.sharding``,
``repro_torch.act_sharding``) and logical axes against the reference's, on
the CPU, with no process group.

Run: PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py

* The axes tree of every id's smoke variant equals the reference's
  ``unzip_params`` axes, and ``abstract_params`` gives the reference's
  shapes and dtypes at full size, on ``meta``.
* ``param_pspecs`` (train and serve, with and without FSDP), ``batch_pspecs``
  and ``cache_pspecs`` equal the reference's entry for entry, for every id
  at full size, every ``configs/shapes.py`` shape and both production
  meshes; the reference runs there on a ``jax.sharding.AbstractMesh``, and
  its cache tree is mapped into the port's cache layout.
* ``shard_act``'s spec equals the one the reference constrains to.
* The reference's five cases of ``tests/test_act_sharding_and_partition.py``
  run on the port; ``shard_act`` returns its input outside a mesh.
* The sharded train step builds under every remat policy and refuses
  plain parameters.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

import repro.act_sharding as RA
import repro.sharding as RS
from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.act_sharding import (DEFAULT_ACT_RULES, act_spec, activation_rules,
                                      placements, shard_act)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, transformer
from repro_torch.models.model import build_model
from repro_torch.pytree import tree_map
from repro_torch.sharding import batch_pspecs, cache_pspecs, param_pspecs, spec_for_axes

MESHES = {"16x16": False, "2x16x16": True}


def _abstract_mesh(multi_pod: bool) -> AbstractMesh:
    shape = make_production_mesh(multi_pod=multi_pod)
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _plain(tree):
    """A reference spec tree with each ``PartitionSpec`` as its tuple and
    each NamedTuple as (type name, fields)."""
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(_plain(v) for v in tree))
    return tree


def _port(tree):
    """The port's spec tree in ``_plain``'s form."""
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port(v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(_port(v) for v in tree))
    return tree


def _ref_cache_in_port_layout(cfg, ref):
    """The reference's cache spec tree (``_plain``'s form: ``scan``/``pos{j}``
    stacked over the groups, then ``rem{j}``) in the port's layout
    (``transformer.init_cache``): one spec stacked over the layers when
    every layer has the same one, else a list with one spec per layer."""
    if cfg.is_encdec:  # one layout in both packages
        return ref
    grouped = cfg.scan_groups * cfg.pattern_period
    layers = []
    for i in range(len(cfg.layer_kinds)):
        if i < grouped:  # the stacked spec without its group axis
            name, fields = ref["scan"][f"pos{i % cfg.pattern_period}"]
            layers.append((name, tuple(f[1:] for f in fields)))
        else:
            layers.append(ref[f"rem{i - grouped}"])
    if transformer.stacked_cache(cfg):
        assert all(layer == layers[0] for layer in layers)
        name, fields = layers[0]
        return (name, tuple((None,) + f for f in fields))
    return layers


@pytest.fixture(scope="module")
def ref_abstract():
    out = {}
    for arch in ARCH_IDS:
        out[arch] = ref_build(ref_config(arch)).abstract_params()
    return out


# ---------------------------------------------------------------------------
# Logical axes and abstract parameters.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_tree_matches_reference_smoke(arch):
    _, ref_axes = ref_build(ref_config(arch, smoke=True)).abstract_params()
    assert build_model(get_config(arch, smoke=True)).param_axes() == ref_axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference_full(arch, ref_abstract):
    values, axes = build_model(get_config(arch)).abstract_params()
    ref_sds, ref_axes = ref_abstract[arch]
    assert axes == ref_axes

    def check(v, sds):
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(sds.shape)
        assert str(v.dtype).removeprefix("torch.") == str(sds.dtype)

    tree_map(check, values, ref_sds)


def test_init_params_follow_the_axes_tree():
    """``init`` (real tensors) and ``abstract_params`` (``meta``) make the
    same tree; the random draws are those of ``init`` before axes existed
    (a fixed seed's first embedding values)."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    meta, _ = model.abstract_params()
    tree_map(lambda a, b: a.shape == b.shape or pytest.fail("shape"), params, meta)
    first = torch.randn((cfg.vocab_size, cfg.d_model), generator=torch.Generator().manual_seed(0))
    assert torch.equal(params["embed"], (first * 0.02).to(params["embed"].dtype))


# ---------------------------------------------------------------------------
# Parameter, batch and cache specs on the production meshes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, mesh_name, ref_abstract):
    multi = MESHES[mesh_name]
    ref_mesh, mesh = _abstract_mesh(multi), make_production_mesh(multi_pod=multi)
    ref_sds, ref_axes = ref_abstract[arch]
    values, axes = build_model(get_config(arch)).abstract_params()
    for mode in ("train", "serve"):
        for fsdp in (True, False):
            ref = RS.param_pspecs(ref_sds, ref_axes, ref_mesh, mode=mode, fsdp=fsdp)
            assert param_pspecs(values, axes, mesh, mode=mode, fsdp=fsdp) == _plain(ref), \
                (mode, fsdp)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_pspecs_match_reference(arch, mesh_name):
    multi = MESHES[mesh_name]
    ref_mesh, mesh = _abstract_mesh(multi), make_production_mesh(multi_pod=multi)
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    for shape in SHAPES.values():
        b = shape.global_batch
        for kind in ("train", "prefill"):
            assert batch_pspecs(cfg, kind, b, mesh) == \
                _plain(RS.batch_pspecs(ref_cfg, kind, b, ref_mesh)), (shape.name, kind)
        enc = shape.seq_len if cfg.is_encdec else 0
        slots = min(cfg.decoder_slots, 448) if cfg.is_encdec else shape.seq_len
        assert _port(cache_pspecs(cfg, mesh, b, slots, enc)) == _ref_cache_in_port_layout(
            cfg, _plain(RS.cache_pspecs(ref_cfg, ref_mesh, b, slots, enc))), shape.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_follow_init_cache(arch):
    """``cache_pspecs`` has ``Model.init_cache``'s structure, a spec of each
    leaf's rank."""
    cfg = get_config(arch)
    enc = 1500 if cfg.is_encdec else 0
    specs = cache_pspecs(cfg, make_production_mesh(), 128, 448 if cfg.is_encdec else 4096, enc)
    if cfg.is_encdec:
        cache = encdec.init_dec_cache(cfg, 128, 448, enc, device="meta")
    else:
        cache = transformer.init_cache(cfg, 128, 4096, device="meta")
    tree_map(lambda t, s: len(s) == t.ndim or pytest.fail(f"{t.shape} {s}"), cache, specs)

# ---------------------------------------------------------------------------
# Activation specs.
# ---------------------------------------------------------------------------

ACT_CASES = [
    ((256, 4096, 2048), ("batch", "seq", "embed_act")),
    ((32, 32768, 32, 64), ("batch", "attn_seq", "heads", None)),
    ((32, 32768, 4, 64), ("batch", "attn_seq", "kv_heads", None)),
    ((1, 4096, 56, 128), ("batch", "attn_seq", "heads", None)),
    ((8, 512, 32000), ("batch", "seq", "vocab_act")),
    ((48, 512, 32064), ("batch", "seq", "vocab_act")),
    ((128, 32, 64, 64), ("batch", "heads", None, None)),
    ((2, 4096, 2560), ("batch", "attn_seq", "rnn_act")),
    ((8, 1024, 128), ("moe_cap", None, "ff_act")),
    ((24, 16), ("batch", None)),
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_act_spec_matches_reference_constraint(mesh_name, monkeypatch):
    """The spec the reference's ``shard_act`` hands
    ``with_sharding_constraint`` (captured), against ``act_spec``."""
    multi = MESHES[mesh_name]
    ref_mesh, mesh = _abstract_mesh(multi), make_production_mesh(multi_pod=multi)
    monkeypatch.setattr(RA, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    for rules in (None, {"seq": None, "batch": "data"}):
        merged = dict(DEFAULT_ACT_RULES, **(rules or {}))
        with RA.activation_rules(ref_mesh, rules):
            for shape, names in ACT_CASES:
                ref = RA.shard_act(jax.ShapeDtypeStruct(shape, np.float32), names)
                assert act_spec(shape, names, mesh, merged) == tuple(ref), (shape, names)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # the two attributes ``mesh_shape`` reads
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.zeros(2, 16, 16)

    assert placements(("model", ("pod", "data")), Mesh) == [Shard(1), Shard(1), Shard(0)]
    assert placements((None, None), Mesh) == [Replicate()] * 3


# ---------------------------------------------------------------------------
# The reference's own cases (tests/test_act_sharding_and_partition.py).
# ---------------------------------------------------------------------------

MESH = {"data": 16, "model": 16}
RULES = {"heads": ("model",), "embed": ("data",), "ff": ("model",), "experts": ("model",),
         "kv_heads": ("model",), "vocab": ("model",)}


def test_divisibility_gates_sharding():
    # 28 heads don't divide 16 -> replicated; ff 18944 does -> model
    assert spec_for_axes((3584, 28, 128), ("embed", "heads", "head_dim"), MESH, RULES) == \
        ("data",)
    assert spec_for_axes((3584, 18944), ("embed", "ff"), MESH, RULES) == ("data", "model")


def test_mesh_axis_used_once_per_tensor():
    spec = spec_for_axes((64, 14336, 4096), ("experts", "ff", "embed"), MESH, RULES)
    assert spec == ("model", None, "data")  # ff can't reuse "model"


def test_ep_vs_tp_expert_choice():
    # llama4: 128 experts divide 16 -> EP on experts
    assert spec_for_axes((128, 5120, 8192), ("experts", "embed", "ff"), MESH, RULES) == \
        ("model", "data")
    # mixtral: 8 experts don't -> ff gets model
    assert spec_for_axes((8, 4096, 14336), ("experts", "embed", "ff"), MESH, RULES) == \
        (None, "data", "model")


def test_shard_act_noop_without_context():
    x = torch.ones((4, 8))
    assert shard_act(x, ("batch", None)) is x
    with activation_rules(MESH):  # a mesh shape alone: nothing to redistribute
        assert shard_act(x, ("batch", None)) is x


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-67b", "rwkv6-1.6b", "whisper-small"])
def test_param_specs_cover_all_leaves(arch):
    values, axes = build_model(get_config(arch)).abstract_params()
    specs = param_pspecs(values, axes, MESH, mode="train", fsdp=True)
    n_specs = []
    tree_map(lambda v, s: n_specs.append(s), values, specs)
    n_params = []
    tree_map(n_params.append, values)
    assert len(n_specs) == len(n_params)


# ---------------------------------------------------------------------------
# The sharded train step's guards.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_sharded_train_step_refuses_remat(remat):
    """The name is kept from when the sharded step refused every remat
    policy but "none".  It now takes "full" and "dots" (its local regions
    recompute in the backward pass; the 2 x 2 runs are in
    test_torch_distributed.py): the step builds under each, and under each
    still refuses a plain parameter leaf before it runs."""
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_sharded_train_step, trainable

    model = build_model(get_config("tinyllama-1.1b", smoke=True), remat=remat)
    step = make_sharded_train_step(model, AdamW(), MESH)
    params = trainable(model.init(torch.Generator().manual_seed(0)))
    batch = {"inputs": torch.zeros(2, 8, dtype=torch.int32),
             "targets": torch.zeros(2, 8, dtype=torch.int32), "mask": torch.ones(2, 8)}
    with pytest.raises(ValueError, match="parameter leaves are not DTensors"):
        step(params, AdamW().init(params), batch)


def test_sharded_train_step_refuses_plain_params():
    """Plain parameters would join the step as replicated, each rank with
    its own values: the step raises before it runs."""
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_sharded_train_step, trainable

    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = build_model(cfg)
    params = trainable(model.init(torch.Generator().manual_seed(0)))
    opt = AdamW()
    batch = {"inputs": torch.zeros(2, 8, dtype=torch.int32),
             "targets": torch.zeros(2, 8, dtype=torch.int32), "mask": torch.ones(2, 8)}
    with pytest.raises(ValueError, match="parameter leaves are not DTensors"):
        make_sharded_train_step(model, opt, MESH)(params, opt.init(params), batch)
