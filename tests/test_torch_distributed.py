"""The port's multi-process sharding against the reference, on the CPU:
gloo, 4 processes, a 2 x 2 ("data", "model") mesh.

Run: PYTHONPATH=src python -m pytest -q tests/test_torch_distributed.py

One spawn of 4 processes (``torch.multiprocessing.spawn(..., join=False)``,
joined within ``JOIN_S``) meets over a ``FileStore`` in the test's
temporary directory (no port is picked), with a 120 s timeout on the group
and one intra-op thread a process.  Each rank runs every case and saves
what it got; the tests below read those files and hold them against the
reference, run here in this process:

* the MoE's mesh branch (``models/moe.py``) against the local MoE within
  1e-5 (the reference's own bound is 1e-4), for E = 4 (expert parallelism)
  and E = 3 (tensor-parallel experts), at d 16, ff 32, capacity 8.0 and
  the reference's weights; its aux loss is the reference's mesh aux, the
  first batch shard's (ROADMAP section 3);
* ``compressed_psum_mean`` bit-equal to an oracle built from the
  reference's ``_quantize``, and within 5% of the exact mean;
* a checkpoint saved from the (2, 2) mesh restored onto (1, 4) and onto
  one process, exactly;
* the sharded TinyLlama smoke step (float32) against the one-process step:
  losses within 1e-4, weights within ROADMAP section 3's AdamW tolerance;
  in bfloat16, losses within its 5e-2; a batch or moment leaf that is not
  a DTensor is refused.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
JOIN_S = 300  # bounded; about 35 s alone, more beside 5 busy workers
SEQ, BATCH = 64, 8


# ---------------------------------------------------------------------------
# What each rank runs.
# ---------------------------------------------------------------------------


def _moe_cases(rank, mesh, inputs, out):
    from repro_torch.act_sharding import activation_rules
    from repro_torch.models import moe
    from repro_torch.sharding import distribute_tree

    for e in (4, 3):
        params = {k: torch.from_numpy(v) for k, v in inputs[f"moe{e}"].items()}
        x = torch.from_numpy(inputs["moe_x"])
        kw = dict(top_k=2, capacity_factor=8.0, act="swiglu")
        local, aux_local = moe.moe_apply(params, x, **kw)
        with activation_rules(mesh):
            sharded, aux = moe.moe_apply(params, x, **kw)
            # the same on DTensors: tokens split over "data", weights by rule
            dx = distribute_tree({"x": x}, {"x": ("data",)}, mesh)["x"]
            dout, daux = moe.moe_apply(params, dx, **kw)
        # gradients of sum(out * w) + 0.01 aux: the mesh branch's aux is the
        # first batch shard's (rows 0-1), the local one's taken alike
        w = torch.from_numpy(inputs["moe_w"])

        def grads(fn):
            ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            xx = x.clone().requires_grad_(True)
            y, a = fn(ps, xx)
            return torch.autograd.grad((y * w).sum() + 0.01 * a, [xx] + [ps[k] for k in sorted(ps)])

        def local_fn(ps, xx):
            first = moe.moe_local(xx[:2].reshape(-1, 16), ps["router"], ps["w_in"], ps["w_gate"],
                                  ps["w_out"], **kw)[1]
            return moe.moe_apply(ps, xx, **kw)[0], first

        want = grads(local_fn)
        with activation_rules(mesh):
            got = grads(lambda ps, xx: moe.moe_apply(ps, xx, **kw))
        out[f"moe{e}"] = dict(local=local, aux_local=aux_local, sharded=sharded, aux=aux,
                              dtensor=dout.full_tensor(), dtensor_aux=daux.full_tensor(),
                              grads=want, mesh_grads=got)


def _compression_case(rank, out):
    from repro_torch.train.compression import compressed_psum_mean

    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(1000).astype(np.float32))
    out["compressed"] = compressed_psum_mean(x)


def _restore_case(rank, mesh22, mesh14, ckpt_dir, out):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.sharding import distribute_tree

    w = torch.arange(64.0).reshape(8, 8)
    tree = distribute_tree({"w": w, "b": torch.arange(6.0)}, {"w": ("data", "model"), "b": ()},
                           mesh22)
    ckpt.save(ckpt_dir, 1, tree)
    like = {"w": torch.empty(8, 8, device="meta"), "b": torch.empty(6, device="meta")}
    back = ckpt.restore(ckpt_dir, 1, like, mesh=mesh14, specs={"w": ("data", "model"),
                                                                "b": ("model",)})
    out["restore14"] = {k: v.full_tensor() for k, v in back.items()}
    out["restore14_placements"] = str(back["w"].placements)
    out["restore14_local"] = back["w"].to_local().clone()
    out["restore1"] = ckpt.restore(ckpt_dir, 1, like)


def _train_case(rank, mesh22, mesh14, ckpt_dir, compute_dtype, out):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import (make_sharded_train_step, make_train_step,
                                              trainable)

    cfg = get_config("tinyllama-1.1b", smoke=True).replace(param_dtype="float32",
                                                           compute_dtype=compute_dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batches = [{"inputs": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g),
                "targets": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g),
                "mask": torch.ones(BATCH, SEQ)} for _ in range(2)]
    opt = AdamW(learning_rate=1e-3, warmup_steps=1, schedule="constant")

    plain = trainable(tree_map(torch.clone, params))
    state = opt.init(plain)
    step = make_train_step(model, opt)
    losses = []
    for b in batches:
        plain, state, loss, _ = step(plain, state, b)
        losses.append(loss)

    sds, axes = model.abstract_params()
    specs = param_pspecs(sds, axes, mesh22, mode="train", fsdp=True)
    sharded = trainable(distribute_tree(tree_map(torch.clone, params), specs, mesh22))
    dstate = opt.init(sharded)
    bspecs = batch_pspecs(cfg, "train", BATCH, mesh22)
    sstep = make_sharded_train_step(model, opt, mesh22)
    dlosses = []
    for b in batches:
        sharded, dstate, loss, _ = sstep(sharded, dstate, distribute_tree(b, bspecs, mesh22))
        dlosses.append(loss)
    tag = f"train_{compute_dtype}"
    out[tag] = dict(losses=torch.stack(losses), dlosses=torch.stack(dlosses),
                    plain=[p.detach() for p in leaves(plain)],
                    sharded=[p.full_tensor().detach() for p in leaves(sharded)],
                    mu=[m.full_tensor() for m in leaves(dstate.mu)],
                    plain_mu=list(leaves(state.mu)))
    if compute_dtype == "float32":
        # a batch or moment leaf left unplaced is refused, not taken as replicated
        refused = []
        for args in ((sharded, dstate, batches[0]),
                     (sharded, dstate._replace(mu=tree_map(lambda m: m.full_tensor(), dstate.mu)),
                      distribute_tree(batches[0], bspecs, mesh22))):
            try:
                sstep(*args)
            except ValueError as err:
                refused.append(str(err))
        out["refused"] = refused
        # the trained weights, saved from (2, 2) and restored onto (1, 4)
        ckpt.save(os.path.join(ckpt_dir, "params"), 2, sharded)
        specs14 = param_pspecs(sds, axes, mesh14, mode="train", fsdp=True)
        back = ckpt.restore(os.path.join(ckpt_dir, "params"), 2, sds, mesh=mesh14, specs=specs14)
        out["params14"] = [p.full_tensor() for p in leaves(back)]


def _worker(rank, store_path, out_dir, inputs):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        out = {}
        _moe_cases(rank, mesh22, inputs, out)
        _compression_case(rank, out)
        ckpt_dir = os.path.join(out_dir, "ckpt")
        _restore_case(rank, mesh22, mesh14, ckpt_dir, out)
        _train_case(rank, mesh22, mesh14, ckpt_dir, "float32", out)
        _train_case(rank, mesh22, mesh14, ckpt_dir, "bfloat16", out)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The run, once for the file.
# ---------------------------------------------------------------------------


def _ref_moe_params(e):
    import jax
    import jax.numpy as jnp

    import repro.models.moe as RMOE
    from repro.models.layers import ParamFactory, unzip_params

    params, _ = unzip_params(RMOE.init_moe(ParamFactory(jax.random.PRNGKey(0), jnp.float32),
                                           16, 32, e, "swiglu"))
    return {k: np.array(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    base = tmp_path_factory.mktemp("dist")
    inputs = {"moe4": _ref_moe_params(4), "moe3": _ref_moe_params(3),
              "moe_x": np.random.default_rng(0).standard_normal((4, 16, 16)).astype(np.float32),
              "moe_w": np.random.default_rng(1).standard_normal((4, 16, 16)).astype(np.float32)}
    ctx = mp.spawn(_worker, args=(str(base / "store"), str(base), inputs), nprocs=WORLD,
                   join=False)
    deadline = time.monotonic() + JOIN_S
    done = False
    try:
        # join returns as each process ends; raises if one failed
        while not done and time.monotonic() < deadline:
            done = ctx.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert done, f"the {WORLD} processes did not finish within {JOIN_S} s"
    return {"inputs": inputs,
            "out": [torch.load(base / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]}


# ---------------------------------------------------------------------------
# MoE.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e", [4, 3], ids=["expert-parallel", "tp-experts"])
def test_moe_mesh_branch_matches_local(ranks, e):
    import jax.numpy as jnp

    import repro.models.moe as RMOE

    params = {k: jnp.asarray(v) for k, v in ranks["inputs"][f"moe{e}"].items()}
    ref, ref_aux = RMOE.moe_apply(params, jnp.asarray(ranks["inputs"]["moe_x"]), top_k=2,
                                  capacity_factor=8.0, act="swiglu")
    for out in ranks["out"]:
        got = out[f"moe{e}"]
        np.testing.assert_allclose(got["local"].numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        for key in ("sharded", "dtensor"):
            assert float((got[key] - got["local"]).abs().max()) < 1e-5, key
        assert abs(float(got["aux_local"]) - float(ref_aux)) < 1e-6


@pytest.mark.parametrize("e", [4, 3], ids=["expert-parallel", "tp-experts"])
def test_moe_mesh_branch_gradients(ranks, e):
    """Gradients through the mesh branch (of x, the router and the three
    expert weights) equal the local MoE's within 1e-5 of each one's
    largest: the partial sums over "model" and the batch shards, and the
    aux term's (pmean's) 1 / m."""
    for out in ranks["out"]:
        got = out[f"moe{e}"]
        for a, b in zip(got["mesh_grads"], got["grads"]):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("e", [4, 3], ids=["expert-parallel", "tp-experts"])
def test_moe_mesh_aux_is_the_first_batch_shards(ranks, e):
    """The reference's mesh branch returns device 0's aux (its
    ``out_specs=P()``): the aux of the tokens of the first "data" shard, not
    the batch's; the port returns that value on every rank."""
    import jax.numpy as jnp

    import repro.models.moe as RMOE

    params = {k: jnp.asarray(v) for k, v in ranks["inputs"][f"moe{e}"].items()}
    x = jnp.asarray(ranks["inputs"]["moe_x"])
    first = RMOE._moe_local(x[:2].reshape(-1, 16), params["router"], params["w_in"],
                            params["w_gate"], params["w_out"], top_k=2, capacity_factor=8.0,
                            act="swiglu", expert_offset=jnp.int32(0), psum_axes=())[1]
    for out in ranks["out"]:
        got = out[f"moe{e}"]
        for key in ("aux", "dtensor_aux"):
            assert abs(float(got[key]) - float(first)) < 1e-6, key
        assert abs(float(got["aux"]) - float(got["aux_local"])) > 1e-5  # not the whole batch's


# ---------------------------------------------------------------------------
# Int8 compressed mean.
# ---------------------------------------------------------------------------


def _oracle_compressed_mean(xs):
    """The reference's ``compressed_psum_mean`` for the ranks' inputs, its
    quantisations by the reference's own ``_quantize`` (JAX), its local sum
    over the ranks in rank order in float32."""
    import jax.numpy as jnp

    from repro.train.compression import _quantize

    n, size = len(xs), xs[0].size
    pad = (-size) % (n * 256)
    sent = []
    for x in xs:
        q, s = _quantize(jnp.asarray(np.pad(x, (0, pad))))
        sent.append((np.asarray(q).reshape(n, -1, 256), np.asarray(s).reshape(n, -1, 1)))
    pieces = []
    for i in range(n):
        local = sent[0][0][i].astype(np.float32) * sent[0][1][i]
        for j in range(1, n):
            local = local + sent[j][0][i].astype(np.float32) * sent[j][1][i]
        q2, s2 = _quantize(jnp.asarray(local.reshape(-1)))
        pieces.append(np.asarray(q2).astype(np.float32) * np.asarray(s2))
    return (np.concatenate(pieces).reshape(-1)[:size] / np.float32(n)).astype(np.float32)


def _rank_inputs():
    return [np.random.default_rng(r).standard_normal(1000).astype(np.float32)
            for r in range(WORLD)]


def test_compressed_mean_bit_equal_to_reference_oracle(ranks):
    oracle = _oracle_compressed_mean(_rank_inputs())
    for out in ranks["out"]:
        np.testing.assert_array_equal(out["compressed"].numpy(), oracle)


def test_compressed_mean_close_to_exact(ranks):
    exact = np.mean(_rank_inputs(), axis=0)
    for out in ranks["out"]:
        err = float(np.max(np.abs(out["compressed"].numpy() - exact)))
        assert err < 0.05 * max(float(np.max(np.abs(exact))), 1.0), err


def test_quantize_and_error_feedback_match_reference():
    """``_quantize``/``_dequantize`` and ``ErrorFeedback`` on one process,
    bit for bit (ties at half a step included)."""
    import jax.numpy as jnp

    from repro.train import compression as RC
    from repro_torch.train import compression as C

    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((7, 61)).astype(np.float32),
         "b": (np.arange(300, dtype=np.float32) - 150) / 2.0}
    q, s = C._quantize(torch.from_numpy(g["a"]))
    rq, rs = RC._quantize(jnp.asarray(g["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    err = C.ErrorFeedback.init({k: torch.from_numpy(v) for k, v in g.items()})
    rerr = RC.ErrorFeedback.init({k: jnp.asarray(v) for k, v in g.items()})
    for _ in range(2):
        deq, err = C.ErrorFeedback.apply({k: torch.from_numpy(v) for k, v in g.items()}, err)
        rdeq, rerr = RC.ErrorFeedback.apply({k: jnp.asarray(v) for k, v in g.items()}, rerr)
        for k in g:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(rdeq[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(rerr[k]))


# ---------------------------------------------------------------------------
# Elastic restore.
# ---------------------------------------------------------------------------


def test_restore_across_mesh_shapes(ranks):
    w = torch.arange(64.0).reshape(8, 8)
    for r, out in enumerate(ranks["out"]):
        assert torch.equal(out["restore14"]["w"], w)
        assert torch.equal(out["restore14"]["b"], torch.arange(6.0))
        # (1, 4): "data" has one rank, "model" splits the columns in 4
        assert torch.equal(out["restore14_local"], w[:, 2 * r:2 * r + 2])
        assert out["restore14_placements"] == "(Shard(dim=0), Shard(dim=1))"


def test_restore_onto_one_process(ranks):
    for out in ranks["out"]:
        assert torch.equal(out["restore1"]["w"], torch.arange(64.0).reshape(8, 8))
        assert not hasattr(out["restore1"]["w"], "placements")


def test_trained_params_restore_from_2x2_onto_1x4(ranks):
    for out in ranks["out"]:
        for a, b in zip(out["params14"], out["train_float32"]["sharded"]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The sharded train step.
# ---------------------------------------------------------------------------


def test_sharded_step_loss_matches_one_process(ranks):
    for out in ranks["out"]:
        got = out["train_float32"]
        assert float((got["dlosses"] - got["losses"]).abs().max()) < 1e-4, got


def test_sharded_step_weights_match_one_process(ranks):
    """ROADMAP section 3's AdamW tolerance after two steps: every weight
    within 2.5 x lr (1e-3) a step, 99.9% within 1e-5; the moments too."""
    for out in ranks["out"]:
        got = out["train_float32"]
        diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got["sharded"], got["plain"])])
        assert float(diffs.max()) <= 2 * 2.5e-3
        assert float((diffs <= 1e-5).float().mean()) >= 0.999
        for a, b in zip(got["mu"], got["plain_mu"]):
            assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)


def test_sharded_step_refuses_unplaced_leaves(ranks):
    """A plain batch or moment leaf would join the step as replicated, each
    rank with its own values: the step raises before it runs."""
    for out in ranks["out"]:
        batch, moments = out["refused"]
        assert "batch leaves are not DTensors" in batch
        assert "AdamW moment leaves are not DTensors" in moments


def test_sharded_step_bf16_loss(ranks):
    """bfloat16 compute: the row-parallel products reduce their partial
    sums in bfloat16 across "model", so the loss is held at ROADMAP
    section 3's bf16 tolerance."""
    for out in ranks["out"]:
        got = out["train_bfloat16"]
        assert float((got["dlosses"] - got["losses"]).abs().max()) < 5e-2, got


def test_ranks_agree(ranks):
    first = ranks["out"][0]
    for out in ranks["out"][1:]:
        assert torch.equal(out["train_float32"]["dlosses"], first["train_float32"]["dlosses"])
        assert torch.equal(out["compressed"], first["compressed"])
