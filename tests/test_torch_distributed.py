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
  a DTensor is refused;
* the sharded step under remat "dots" and "full", and the sharded
  gradient-accumulation step (2 microbatches; also with mask sums that
  differ between microbatches), each against the one-process step with the
  same policy, at the same tolerances; Mixtral's accumulation step against
  the accumulation over global row blocks placed from the host (its mesh
  branch's capacity and aux loss are each batch shard's);
* sharded prefill into a cache placed by ``cache_pspecs`` and 4 sharded
  decode steps against the one-process ones (float32 logits within 1e-4)
  on four smoke block kinds and on Whisper (4 heads and 3: its encoder
  states, then the logits), whose sharded prefill encodes on the
  sequence split: every encoder layer hands on its states split over
  "model" along the sequence;
* flash attention's local region under remat "dots" and "full" (heads
  split over "model", and not): its graph rebuild in the backward pass
  makes no product, the loss and gradients bit for bit those of a
  rebuild that computes flash's forward itself and within 1e-5 of
  "none"'s;
* one attention layer (forward and gradients, float32, within 1e-5 of
  each tensor's largest) with 4 KV heads on "model" = 4 (the (1, 4) mesh)
  and with KV heads that do not divide "model": 2 on 4 (repeated until they
  split) and 3 on 2 (taken whole);
* the vocabulary-parallel lookup and loss head (``models/vocab.py``),
  tied and untied, with the residual stream's sequence split over "model"
  and whole (``{"seq": None}``): the loss within 1e-4 and the gradients
  of the table and of x within 1e-5 of each one's largest, against one
  process; the sharded step with ``{"seq": None}`` against the
  one-process step at the sharded step's tolerances; and the residual
  stream entering each block placed ``Shard`` on the sequence over
  "model" by the default rules, whole with ``{"seq": None}``;
* RWKV6's and Whisper's sharded train steps (Whisper also with 3 heads,
  whose causal self-attention takes each rank's query rows at their
  offset) against one process at the sharded step's tolerances; the
  residual stream entering RWKV6's blocks split on the sequence; and the
  split token shift on (1, 4): each rank's first row the previous rank's
  last token (rank 0 zeros), its gradient sent back.
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


def _smoke_f32(arch):
    from repro_torch.configs import get_config

    return get_config(arch, smoke=True).replace(param_dtype="float32", compute_dtype="float32")


def _run_steps(model, opt, params, batches, mesh=None, microbatches=1, rules=None):
    """Two steps from ``params`` (cloned): on one process, or sharded on
    ``mesh`` (parameters by ``param_pspecs`` with FSDP, batches by
    ``batch_pspecs``).  Returns (losses, the weights after, as full
    tensors)."""
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.train_step import (make_grad_accum_train_step,
                                              make_sharded_train_step, make_train_step,
                                              trainable)

    params = tree_map(torch.clone, params)
    if mesh is None:
        p = trainable(params)
        step = (make_train_step(model, opt) if microbatches == 1
                else make_grad_accum_train_step(model, opt, microbatches))
        place = lambda b: b
    else:
        sds, axes = model.abstract_params()
        p = trainable(distribute_tree(params, param_pspecs(sds, axes, mesh, mode="train",
                                                           fsdp=True), mesh))
        step = make_sharded_train_step(model, opt, mesh, microbatches, rules)
        bspecs = batch_pspecs(model.cfg, "train", BATCH, mesh)
        place = lambda b: distribute_tree(b, bspecs, mesh)
    state = opt.init(p)
    losses = []
    for b in batches:
        p, state, loss, _ = step(p, state, place(b))
        losses.append(loss)
    return torch.stack(losses), [t.full_tensor().detach() if mesh is not None else t.detach()
                                 for t in leaves(p)]


def _batches(cfg, seed, uneven_mask=False):
    """Two batches of BATCH x SEQ tokens; with ``uneven_mask``, row r keeps
    each position with probability 0.2 + 0.8 r / (BATCH - 1), so the
    microbatches' mask sums differ."""
    g = torch.Generator().manual_seed(seed)
    keep = torch.linspace(0.2, 1.0, BATCH)[:, None]
    return [{"inputs": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g),
             "mask": ((torch.rand(BATCH, SEQ, generator=g) < keep).float() if uneven_mask
                      else torch.ones(BATCH, SEQ))} for _ in range(2)]


def _run_block_steps(model, opt, params, batches, mesh, microbatches):
    """The sharded accumulation step written out: microbatch i cut on the
    host as the global rows i B / n to (i + 1) B / n and then placed, its
    gradients taken through the sharded loss, summed in float32 and divided
    by the count, and one AdamW update.  Returns what ``_run_steps`` does."""
    from repro_torch.act_sharding import activation_rules
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.train_step import _value_and_grad, trainable

    sds, axes = model.abstract_params()
    p = trainable(distribute_tree(tree_map(torch.clone, params),
                                  param_pspecs(sds, axes, mesh, mode="train", fsdp=True), mesh))
    state = opt.init(p)
    rows = BATCH // microbatches
    bspecs = batch_pspecs(model.cfg, "train", rows, mesh)
    losses = []
    for b in batches:
        grads = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), p)
        loss_sum = 0.0
        with activation_rules(mesh):
            for i in range(microbatches):
                part = distribute_tree({k: v[i * rows:(i + 1) * rows] for k, v in b.items()},
                                       bspecs, mesh)
                loss, _, g = _value_and_grad(model, p, part)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda t: t / microbatches, grads)
            state = opt.update_in_place(grads, state, p)
        losses.append(loss_sum / microbatches)
    return torch.stack(losses), [t.full_tensor().detach() for t in leaves(p)]


def _remat_cases(rank, mesh22, out):
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW

    cfg = _smoke_f32("tinyllama-1.1b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batches = _batches(cfg, 1)
    opt = AdamW(learning_rate=1e-3, warmup_steps=1, schedule="constant")
    for remat, mb in (("dots", 1), ("full", 1), ("none", 2)):
        model = build_model(cfg, remat=remat)
        losses, plain = _run_steps(model, opt, params, batches, microbatches=mb)
        dlosses, sharded = _run_steps(model, opt, params, batches, mesh22, microbatches=mb)
        out[f"steps_{remat}_{mb}"] = dict(losses=losses, dlosses=dlosses, plain=plain,
                                          sharded=sharded)
    # microbatches whose mask sums differ: each one's mean is over its own
    # rows, so the rows that share a microbatch decide the loss
    model = build_model(cfg)
    batches = _batches(cfg, 6, uneven_mask=True)
    losses, plain = _run_steps(model, opt, params, batches, microbatches=2)
    dlosses, sharded = _run_steps(model, opt, params, batches, mesh22, microbatches=2)
    out["steps_mask_2"] = dict(losses=losses, dlosses=dlosses, plain=plain, sharded=sharded)
    # an MoE: on a mesh its capacity and aux loss are each batch shard's (the
    # reference's mesh branch), so the step is held against the same
    # accumulation over global row blocks placed from the host
    cfg = _smoke_f32("mixtral-8x7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(7))
    batches = _batches(cfg, 8, uneven_mask=True)
    losses, plain = _run_block_steps(model, opt, params, batches, mesh22, 2)
    dlosses, sharded = _run_steps(model, opt, params, batches, mesh22, microbatches=2)
    out["steps_moe_2"] = dict(losses=losses, dlosses=dlosses, plain=plain, sharded=sharded)


# (name, arch, config changes): the decoder-only block kinds, and Whisper
# with 4 heads (split over "model" = 2) and 3 (not split: each rank's query
# rows against every frame)
SERVE_CASES = (("tinyllama-1.1b", "tinyllama-1.1b", {}), ("mixtral-8x7b", "mixtral-8x7b", {}),
               ("recurrentgemma-2b", "recurrentgemma-2b", {}), ("rwkv6-1.6b", "rwkv6-1.6b", {}),
               ("whisper-small", "whisper-small", {}),
               ("whisper-3h", "whisper-small", {"num_heads": 3, "num_kv_heads": 3}))
SERVE_DECODE = 4


def _serve_cases(rank, mesh22, out):
    """Prefill (SEQ tokens into SEQ + SERVE_DECODE slots; Whisper: SEQ frames
    and SERVE_DECODE decoder slots) and SERVE_DECODE decode steps, on one
    process and sharded on (2, 2).  Whisper's first result is its encoder
    states; the placements of the states each encoder layer hands on inside
    the sharded prefill are kept."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import encdec
    from repro_torch.models.model import build_model
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.train_step import (make_serve_step, make_sharded_prefill_step,
                                              make_sharded_serve_step)

    for name, arch, changes in SERVE_CASES:
        cfg = _smoke_f32(arch).replace(**changes)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(2))
        g = torch.Generator().manual_seed(3)
        if cfg.is_encdec:
            batch = {"encoder_embeds": torch.randn(BATCH, SEQ, cfg.d_model, generator=g)}
            start, slots = 0, SERVE_DECODE
        else:
            batch = {"inputs": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g)}
            start, slots = SEQ, SEQ + SERVE_DECODE
        steps = torch.randint(0, cfg.vocab_size, (SERVE_DECODE, BATCH, 1), generator=g)
        logits, cache = model.prefill(params, batch, slots)
        want = [logits]
        serve = make_serve_step(model)
        for i in range(SERVE_DECODE):
            logits, cache = serve(params, cache, steps[i], start + i)
            want.append(logits)
        sds, axes = model.abstract_params()
        dparams = distribute_tree(params, param_pspecs(sds, axes, mesh22, mode="serve",
                                                       fsdp=False), mesh22)
        enc_layer, seen = encdec._enc_layer, []

        def spy(*args):
            y = enc_layer(*args)
            seen.append(str(y.placements))
            return y

        encdec._enc_layer = spy
        try:
            dlogits, dcache = make_sharded_prefill_step(model, mesh22, slots)(
                dparams, distribute_tree(batch, batch_pspecs(cfg, "prefill", BATCH, mesh22),
                                         mesh22))
        finally:
            encdec._enc_layer = enc_layer
        got = [dlogits.full_tensor()]
        first = str(dlogits.placements)
        dserve = make_sharded_serve_step(model, mesh22)
        for i in range(SERVE_DECODE):
            tok = distribute_tensor(steps[i], mesh22, placements_of((), mesh22))
            dlogits, dcache = dserve(dparams, dcache, tok, start + i)
            got.append(dlogits.full_tensor())
        out[f"serve_{name}"] = dict(want=want, got=got, first=first,
                                    encoder_layers=sorted(set(seen)))


# Flash attention in a local region on (2, 2) (TinyLlama's smoke config, one
# flash chunk a layer): 4 heads, split over "model", and 3 heads on 1 KV
# head, which do not split it (each rank's query rows at their offset)
FLASH_REBUILD_HEADS = ((4, 2), (3, 1))
FLASH_PRODUCTS = ("_logits", "_pv", "_tp")


def _flash_rebuild_cases(rank, mesh22, out):
    """One sharded ``train_loss`` and its gradients under remat "none",
    "dots" and "full", and under "dots" again with the local region's graph
    rebuild computing flash's forward itself (``taken_from_rerun`` giving
    nothing back); flash's products by call (``FLASH_PRODUCTS``), those
    made while a region rebuilds its graph apart."""
    from repro_torch import act_sharding
    from repro_torch.models import attention
    from repro_torch.models.model import build_model
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.train_step import _value_and_grad, trainable

    originals = {name: getattr(attention, name) for name in FLASH_PRODUCTS}
    taken = attention.taken_from_rerun

    def counted(calls, f):
        def call(*a, **kw):
            calls["rebuild" if act_sharding.rebuilding_graph() else "products"] += 1
            return f(*a, **kw)
        return call

    for heads, kvh in FLASH_REBUILD_HEADS:
        cfg = _smoke_f32("tinyllama-1.1b").replace(num_heads=heads, num_kv_heads=kvh)
        params = build_model(cfg).init(torch.Generator().manual_seed(14))
        batch = _batches(cfg, 15)[0]
        runs = {}
        for name, remat in (("none", "none"), ("dots", "dots"), ("full", "full"),
                            ("dots_computing", "dots")):
            model = build_model(cfg, remat=remat)
            sds, axes = model.abstract_params()
            p = trainable(distribute_tree(tree_map(torch.clone, params),
                                          param_pspecs(sds, axes, mesh22, mode="train",
                                                       fsdp=True), mesh22))
            placed = distribute_tree(batch, batch_pspecs(cfg, "train", BATCH, mesh22), mesh22)
            calls = {"products": 0, "rebuild": 0}
            for fn_name, f in originals.items():
                setattr(attention, fn_name, counted(calls, f))
            if name == "dots_computing":
                attention.taken_from_rerun = lambda: None
            try:
                with act_sharding.activation_rules(mesh22):
                    loss, _, grads = _value_and_grad(model, p, placed)
            finally:
                for fn_name, f in originals.items():
                    setattr(attention, fn_name, f)
                attention.taken_from_rerun = taken
            runs[name] = dict(loss=loss, grads=[g.full_tensor() for g in leaves(grads)],
                              calls=calls)
        out[f"flash_{heads}_{kvh}"] = runs


def placements_of(spec, mesh):
    from repro_torch.act_sharding import placements

    return placements(spec, mesh)


# (heads, KV heads, mesh): 4 KV heads on "model" = 4; KV heads that do not
# divide "model" (2 on 4: repeated; 3 on 2: taken whole)
ATTN_CASES = ((8, 4, "mesh14"), (8, 2, "mesh14"), (6, 3, "mesh22"))
# unmasked attention (an encoder's) whose 3 heads do not divide "model" = 2:
# each rank attends its block of query rows against every key
ATTN_UNMASKED_CASES = ((3, 3, "mesh22"),)


def _attention_cases(rank, meshes, out):
    from repro_torch.act_sharding import activation_rules, fsdp_gather
    from repro_torch.models import attention
    from repro_torch.models.layers import AxesFactory, ParamFactory, map_dict
    from repro_torch.sharding import distribute_tree, param_pspecs

    d, hd, b, s = 32, 8, 4, 64
    for heads, kvh, mesh_name, causal in ([c + (True,) for c in ATTN_CASES]
                                          + [c + (False,) for c in ATTN_UNMASKED_CASES]):
        mesh = meshes[mesh_name]
        kw = {} if causal else dict(causal=False, use_rope=False)
        p = attention.init_attention(ParamFactory(torch.Generator().manual_seed(4),
                                                  torch.float32), d, heads, kvh, hd)
        axes = attention.init_attention(AxesFactory(), d, heads, kvh, hd)
        g = torch.Generator().manual_seed(5)
        x = torch.randn(b, s, d, generator=g)
        w = torch.randn(b, s, d, generator=g)
        pos = torch.arange(s).expand(b, s)

        def grads(weights, xx, sharded):
            weights = {k: v.detach().requires_grad_(True) for k, v in weights.items()}
            xx = xx.detach().requires_grad_(True)
            wanted = [xx] + [weights[k] for k in sorted(weights)]
            if sharded:  # backward too under the rules, as the sharded step runs it
                with activation_rules(mesh):
                    y = attention.attention_train(map_dict(fsdp_gather, weights), xx, pos,
                                                  **kw)[0]
                    loss = (y * distribute_tree(w, ("data",), mesh)).sum().full_tensor()
                    gs = torch.autograd.grad(loss, wanted)
            else:
                y = attention.attention_train(weights, xx, pos, **kw)[0]
                gs = torch.autograd.grad((y * w).sum(), wanted)
            full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
            return [full(y).detach()] + [full(t) for t in gs]

        specs = param_pspecs(p, axes, mesh, mode="train", fsdp=True)
        got = grads(distribute_tree(p, specs, mesh), distribute_tree(x, ("data",), mesh), True)
        tag = "" if causal else "_unmasked"
        out[f"attn_{heads}_{kvh}_{mesh_name}{tag}"] = dict(want=grads(p, x, False), got=got)


VOCAB_CASES = [(tied, seq) for tied in (True, False) for seq in ("split", "whole")]


def _vocab_cases(rank, mesh22, out):
    """The lookup and the loss head of a (V, d) table (tied) or a (d, V)
    ``unembed``, on one process and on (2, 2) with x's sequence split over
    "model" or whole, placed as ``param_pspecs`` and the residual stream
    place them."""
    from types import SimpleNamespace

    from repro_torch.act_sharding import activation_rules, fsdp_gather
    from repro_torch.models import transformer, vocab
    from repro_torch.sharding import distribute_tree

    v, d, b, s = 64, 16, 4, 32
    g = torch.Generator().manual_seed(9)
    embed = torch.randn(v, d, generator=g)
    unembed = torch.randn(d, v, generator=g)
    tokens = torch.randint(0, v, (b, s), generator=g)
    targets = torch.randint(0, v, (b, s), generator=g)
    mask = (torch.rand(b, s, generator=g) < 0.7).float()
    x = torch.randn(b, s, d, generator=g)
    w = torch.randn(b, s, d, generator=g)
    for tied, seq in VOCAB_CASES:
        cfg = SimpleNamespace(tie_embeddings=tied)
        rules = {"seq": None} if seq == "whole" else None

        def run(emb, tab, xx, tok, tg, mk, sharded):
            emb, xx = emb.detach().requires_grad_(True), xx.detach().requires_grad_(True)
            tab = emb if tied else tab.detach().requires_grad_(True)
            params = {"embed": emb} if tied else {"embed": emb, "unembed": tab}
            looked = transformer.lookup(emb, tok)
            loss = transformer.chunked_ce_loss(params, xx, tg, mk, cfg)
            if sharded:
                ww = distribute_tree(w, ("data", "model" if seq == "split" else None), mesh22)
                looked, loss = (looked * ww).sum().full_tensor(), loss.full_tensor()
            else:
                looked = (looked * w).sum()
            (ge,) = torch.autograd.grad(looked, [emb])
            gx, gt = torch.autograd.grad(loss, [xx, tab])
            full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
            return [loss.detach(), full(gx), full(gt), full(ge)]

        want = run(embed, unembed, x, tokens, targets, mask, False)
        with activation_rules(mesh22, rules):
            demb = distribute_tree(embed, ("model", "data"), mesh22)
            dun = distribute_tree(unembed, ("data", "model"), mesh22)
            dx = distribute_tree(x, ("data", "model" if seq == "split" else None, None), mesh22)
            dtok, dtg, dmk = (distribute_tree(t, ("data", None), mesh22)
                              for t in (tokens, targets, mask))
            plan = vocab.plan_ce(fsdp_gather(demb if tied else dun), dx, dtg, dmk, tied, s)
            lookup_axis = vocab.plan_lookup(fsdp_gather(demb), dtok)
            got = run(demb, dun, dx, dtok, dtg, dmk, True)
        out[f"vocab_{tied}_{seq}"] = dict(want=want, got=got, plan=plan, lookup_axis=lookup_axis)
    # a vocabulary that "model" does not divide: the loss head on each rank's
    # rows and sequence block, the table whole
    odd = torch.randn(d, v - 1, generator=g)
    tg = targets % (v - 1)
    cfg = SimpleNamespace(tie_embeddings=False)

    def odd_loss(tab, xx, tgt, mk, sharded):
        tab, xx = tab.detach().requires_grad_(True), xx.detach().requires_grad_(True)
        loss = transformer.chunked_ce_loss({"unembed": tab}, xx, tgt, mk, cfg)
        loss = loss.full_tensor() if sharded else loss
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        return [loss.detach()] + [full(t) for t in torch.autograd.grad(loss, [xx, tab])]

    want = odd_loss(odd, x, tg, mask, False)
    with activation_rules(mesh22):
        dodd = distribute_tree(odd, ("data", "model"), mesh22)
        dx = distribute_tree(x, ("data", "model", None), mesh22)
        dtg, dmk = (distribute_tree(t, ("data", None), mesh22) for t in (tg, mask))
        plan = vocab.plan_ce(fsdp_gather(dodd), dx, dtg, dmk, False, s)
        got = odd_loss(dodd, dx, dtg, dmk, True)
    out["vocab_odd"] = dict(want=want, got=got, plan=plan)


def _residual_cases(rank, mesh22, out):
    """The placements of the residual stream entering each block's norm in
    the sharded TinyLlama smoke step, under the default rules and with
    ``{"seq": None}``; and the sharded step under ``{"seq": None}``
    against the one-process step."""
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW

    cfg = _smoke_f32("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batches = _batches(cfg, 1)
    opt = AdamW(learning_rate=1e-3, warmup_steps=1, schedule="constant")
    norm_in = transformer.rms_norm_in
    for name, rules in (("default", None), ("seq_off", {"seq": None})):
        seen = []

        def spy(x, scale, eps):
            seen.append(str(x.placements))
            return norm_in(x, scale, eps)

        transformer.rms_norm_in = spy
        try:
            dlosses, sharded = _run_steps(model, opt, params, batches[:1], mesh22, rules=rules)
        finally:
            transformer.rms_norm_in = norm_in
        out[f"residual_{name}"] = sorted(set(seen))
        if rules:
            losses, plain = _run_steps(model, opt, params, batches)
            dlosses, sharded = _run_steps(model, opt, params, batches, mesh22, rules=rules)
            out["steps_seqoff_1"] = dict(losses=losses, dlosses=dlosses, plain=plain,
                                         sharded=sharded)


# The block kinds whose sharded train step keeps the sequence split (RWKV6's
# token shift on each rank's block; Whisper's query rows at their offset):
# (name, arch, config changes); "whisper-3h": 3 heads, which "model" = 2
# does not divide, so its causal self-attention takes each rank's query rows
# at their offset (``flash_attend(q_offset=)``)
BLOCK_STEP_CASES = (("rwkv6", "rwkv6-1.6b", {}), ("whisper", "whisper-small", {}),
                    ("whisper-3h", "whisper-small", {"num_heads": 3, "num_kv_heads": 3}))


def _encdec_batches(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return [{"encoder_embeds": torch.randn(BATCH, SEQ, cfg.d_model, generator=g),
             "decoder_tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g),
             "mask": torch.ones(BATCH, SEQ)} for _ in range(2)]


def _block_step_cases(rank, mesh22, mesh14, out):
    """RWKV6's and Whisper's sharded train steps against one process; the
    placements of the residual stream entering RWKV6's blocks; the split
    token shift on (1, 4), forward and gradient."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import act_sharding
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW

    opt = AdamW(learning_rate=1e-3, warmup_steps=1, schedule="constant")
    for name, arch, changes in BLOCK_STEP_CASES:
        cfg = _smoke_f32(arch).replace(**changes)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(10))
        batches = _encdec_batches(cfg, 11) if cfg.is_encdec else _batches(cfg, 11)
        losses, plain = _run_steps(model, opt, params, batches)
        norm_in, seen = transformer.rms_norm_in, []

        def spy(x, scale, eps):
            seen.append(str(x.placements))
            return norm_in(x, scale, eps)

        transformer.rms_norm_in = spy
        try:
            dlosses, sharded = _run_steps(model, opt, params, batches, mesh22)
        finally:
            transformer.rms_norm_in = norm_in
        out[f"steps_{name}"] = dict(losses=losses, dlosses=dlosses, plain=plain, sharded=sharded)
        if name == "rwkv6":
            out["residual_rwkv6"] = sorted(set(seen))
    # the token shift of x (2, 8, 3) split over "model" = 4
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    w = torch.randn(2, 8, 3, generator=torch.Generator().manual_seed(12))
    plc = [Replicate(), Shard(1)]
    dx = distribute_tensor(x, mesh14, plc).requires_grad_(True)
    with act_sharding.activation_rules(mesh14):
        y = act_sharding.shift_tokens(dx, "model")
        (y * distribute_tensor(w, mesh14, plc)).sum().full_tensor().backward()
    out["shift"] = dict(x=x, w=w, local=y.to_local().detach().clone(), whole=y.full_tensor(),
                        grad=dx.grad.full_tensor())


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
        _remat_cases(rank, mesh22, out)
        _flash_rebuild_cases(rank, mesh22, out)
        _serve_cases(rank, mesh22, out)
        _attention_cases(rank, {"mesh22": mesh22, "mesh14": mesh14}, out)
        _vocab_cases(rank, mesh22, out)
        _residual_cases(rank, mesh22, out)
        _block_step_cases(rank, mesh22, mesh14, out)
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


# ---------------------------------------------------------------------------
# Remat, microbatches, prefill and decode, attention heads on a mesh.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dots_1", "full_1", "none_2", "mask_2", "moe_2", "seqoff_1"],
                         ids=["remat-dots", "remat-full", "microbatches-2",
                              "microbatches-2-uneven-mask", "microbatches-2-moe", "seq-off"])
def test_sharded_step_policies_match_one_process(ranks, case):
    """The sharded step under remat "dots" and "full" (the local regions
    recomputed in backward), under ``{"seq": None}`` (the residual stream
    whole on "model") and the sharded gradient-accumulation step
    (microbatch i the global rows i B / n to (i + 1) B / n, also with mask
    sums that differ between microbatches), each against the one-process
    step with the same policy; Mixtral's accumulation against the same
    accumulation over global row blocks placed from the host
    (``_run_block_steps``).  Losses within 1e-4, weights within ROADMAP
    section 3's AdamW tolerance."""
    for out in ranks["out"]:
        got = out[f"steps_{case}"]
        assert float((got["dlosses"] - got["losses"]).abs().max()) < 1e-4, got["dlosses"]
        diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got["sharded"],
                                                                      got["plain"])])
        assert float(diffs.max()) <= 2 * 2.5e-3
        assert float((diffs <= 1e-5).float().mean()) >= 0.999


def test_remat_policies_agree_on_one_process(ranks):
    """Remat changes memory, not numbers: "dots" and "full" give "none"'s
    losses and weights (float32, 1e-5 relative), on one process."""
    out = ranks["out"][0]
    base = out["train_float32"]
    for case in ("dots_1", "full_1"):
        got = out[f"steps_{case}"]
        assert torch.allclose(got["losses"], base["losses"], rtol=1e-5, atol=0)
        for a, b in zip(got["plain"], base["plain"]):
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("heads,kvh", FLASH_REBUILD_HEADS, ids=["4-heads", "3-heads-1-kv"])
def test_flash_graph_rebuild_makes_no_products(ranks, heads, kvh):
    """Under remat "dots" and "full", flash attention's local region makes
    its graph again in the backward pass without a product: it takes the
    float32 output and log-sum-exp from the region's run in the unit's
    rerun.  So "dots" makes 9 products a key chunk where "none" makes 7
    (the rerun's forward two), and a rebuild that computes flash's forward
    itself makes two more; the loss and every gradient are equal to that
    rebuild's bit for bit, and within 1e-5 relative of "none"'s."""
    for out in ranks["out"]:
        runs = out[f"flash_{heads}_{kvh}"]
        computing = runs["dots_computing"]
        assert computing["calls"]["rebuild"] * 9 == computing["calls"]["products"] * 2 > 0
        assert runs["dots"]["calls"]["products"] * 7 == runs["none"]["calls"]["products"] * 9
        for remat in ("dots", "full"):
            got = runs[remat]
            assert got["calls"] == {"products": computing["calls"]["products"], "rebuild": 0}
            assert abs(float(got["loss"] - runs["none"]["loss"])) <= 1e-5 * abs(
                float(runs["none"]["loss"]))
            for g, n in zip(got["grads"], runs["none"]["grads"]):
                assert float((g - n).abs().max()) <= 1e-5 * float(n.abs().max())
        assert torch.equal(runs["dots"]["loss"], computing["loss"])
        assert all(torch.equal(g, c) for g, c in zip(runs["dots"]["grads"], computing["grads"]))


@pytest.mark.parametrize("arch", [c[0] for c in SERVE_CASES])
def test_sharded_prefill_and_decode_match_one_process(ranks, arch):
    """Sharded prefill into a cache placed by ``cache_pspecs`` and 4 sharded
    decode steps (tokens replicated) give the one-process logits (Whisper:
    its encoder states, then the logits) within 1e-4 (float32)."""
    for out in ranks["out"]:
        got = out[f"serve_{arch}"]
        assert len(got["got"]) == len(got["want"]) == 1 + SERVE_DECODE
        for a, b in zip(got["got"], got["want"]):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) < 1e-4


@pytest.mark.parametrize("name", ["whisper-small", "whisper-3h"])
def test_sharded_prefill_encodes_on_the_sequence_split(ranks, name):
    """Whisper's sharded prefill runs its encoder on the residual stream's
    sequence split, as the reference's GSPMD does: every encoder layer
    hands on states split over "model" along the sequence and over "data"
    along the rows, and the prefill returns them so (4 heads, split over
    "model", and 3, each rank's query rows against every frame)."""
    for out in ranks["out"]:
        got = out[f"serve_{name}"]
        assert got["encoder_layers"] == ["(Shard(dim=0), Shard(dim=1))"]
        assert got["first"] == "(Shard(dim=0), Shard(dim=1))"


@pytest.mark.parametrize("heads,kvh,mesh", ATTN_CASES,
                         ids=["4kv-on-model4", "2kv-on-model4", "3kv-on-model2"])
def test_attention_heads_on_model_axis(ranks, heads, kvh, mesh):
    """One attention layer, its output and the gradients of x and the four
    weights, sharded against one process: within 1e-5 of each one's
    largest."""
    for out in ranks["out"]:
        got = out[f"attn_{heads}_{kvh}_{mesh}"]
        for a, b in zip(got["got"], got["want"]):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ---------------------------------------------------------------------------
# The vocabulary-parallel lookup and loss head; the residual stream.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied,seq", VOCAB_CASES,
                         ids=[f"{'tied' if t else 'untied'}-seq-{q}" for t, q in VOCAB_CASES])
def test_vocab_parallel_lookup_and_loss_head(ranks, tied, seq):
    """The loss head with the table's vocabulary split over "model" (x's
    sequence split there too, or whole) and the lookup of the split
    ``embed`` against one process: the loss within 1e-4, the gradients of
    x and of the table (from the loss) and of ``embed`` (from the lookup)
    within 1e-5 of each one's largest."""
    for out in ranks["out"]:
        got = out[f"vocab_{tied}_{seq}"]
        assert got["plan"] == ("model", 32 // 2 if seq == "split" else 32, seq == "split")
        assert got["lookup_axis"] == "model"
        (loss, *grads), (want_loss, *want) = got["got"], got["want"]
        assert abs(float(loss) - float(want_loss)) < 1e-4
        for a, b in zip(grads, want):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_loss_head_of_a_vocabulary_model_does_not_divide(ranks):
    """63 columns on "model" = 2: the table stays whole and each rank takes
    the loss of its rows and sequence block; the loss within 1e-4, the
    gradients of x and the table within 1e-5 of each one's largest."""
    for out in ranks["out"]:
        got = out["vocab_odd"]
        assert got["plan"] is None
        (loss, *grads), (want_loss, *want) = got["got"], got["want"]
        assert abs(float(loss) - float(want_loss)) < 1e-4
        for a, b in zip(grads, want):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("heads,kvh,mesh", ATTN_UNMASKED_CASES, ids=["3kv-unmasked-on-model2"])
def test_unmasked_attention_split_on_query_rows(ranks, heads, kvh, mesh):
    """Unmasked attention whose heads do not divide "model" (each rank's
    query rows against every key): its output and the gradients of x and
    the four weights within 1e-5 of each one's largest, against one
    process."""
    for out in ranks["out"]:
        got = out[f"attn_{heads}_{kvh}_{mesh}_unmasked"]
        for a, b in zip(got["got"], got["want"]):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_residual_stream_split_on_sequence(ranks):
    """The residual stream entering each block's norm: its sequence split
    over "model" (``Shard(dim=1)``) and its rows over "data" by the default
    rules; whole on "model" with ``{"seq": None}``."""
    for out in ranks["out"]:
        assert out["residual_default"] == ["(Shard(dim=0), Shard(dim=1))"]
        assert out["residual_seq_off"] == ["(Shard(dim=0), Replicate())"]


# ---------------------------------------------------------------------------
# RWKV6's and Whisper's sharded train steps; the split token shift.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [c[0] for c in BLOCK_STEP_CASES])
def test_block_sharded_step_matches_one_process(ranks, name):
    """RWKV6 (its token shift, mixes and products on each rank's sequence
    block) and Whisper (4 heads, split over "model"; and 3 heads, whose
    causal self-attention takes each rank's query rows at their offset):
    two sharded steps on (2, 2) against one process, float32: losses
    within 1e-4, weights within ROADMAP section 3's AdamW tolerance."""
    for out in ranks["out"]:
        got = out[f"steps_{name}"]
        assert float((got["dlosses"] - got["losses"]).abs().max()) < 1e-4, got["dlosses"]
        diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got["sharded"],
                                                                      got["plain"])])
        assert float(diffs.max()) <= 2 * 2.5e-3
        assert float((diffs <= 1e-5).float().mean()) >= 0.999


def test_rwkv6_residual_stream_split_on_sequence(ranks):
    """The residual stream entering each RWKV6 block's norm keeps its
    sequence split over "model" and its rows over "data"."""
    for out in ranks["out"]:
        assert out["residual_rwkv6"] == ["(Shard(dim=0), Shard(dim=1))"]


def test_split_token_shift_takes_the_previous_ranks_last_token(ranks):
    """x (2, 8, 3) split over "model" = 4: on ranks 1-3 the shift's first
    row is the previous rank's last token, on rank 0 zeros; the whole is
    x one token later, and the gradient is the cotangent one token
    earlier, zeros last."""
    for r, out in enumerate(ranks["out"]):
        got = out["shift"]
        x, w = got["x"], got["w"]
        want_first = x[:, 2 * r - 1] if r else torch.zeros(2, 3)
        assert torch.equal(got["local"][:, 0], want_first)
        assert torch.equal(got["local"][:, 1], x[:, 2 * r])
        assert torch.equal(got["whole"], torch.cat([torch.zeros(2, 1, 3), x[:, :-1]], 1))
        assert torch.equal(got["grad"], torch.cat([w[:, 1:], torch.zeros(2, 1, 3)], 1))
