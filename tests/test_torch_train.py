"""The port's training stack (``repro_torch.train``, ``launch/train.py``)
against the reference, on the CPU at smoke size, float32 compute.

* ``AdamW``: ``update`` over equal gradients and equal state (the
  reference's, carried over by ``models.convert``) at steps 1 and 5, for
  both moment dtypes and both schedules, with and without the clip acting:
  weights and moments within 1e-6 relative; ``lr_at`` over steps 0 to 200;
  the decay mask per leaf; the reference's own optimizer tests.
* Train steps, from equal weights and batch: every weight within 2.5 x lr
  of the reference's and at least 99.9% of them within 1e-5.  At step 1
  Adam moves a weight by about ``lr * g / (|g| + eps)``, so an element whose
  gradient is rounding noise in either package can step by up to lr the
  other way.  ``make_grad_accum_train_step(..., 2)`` is held to the
  reference's the same way, and within 0.05 of the port's plain step.
* ``Trainer``: the reference's chaos, straggler and end-to-end tests on the
  port, and one test for each of the three faults of the reference's
  trainer that the port repairs (ROADMAP.md §3): (a) an exception in the
  producer thread reaches ``get``; (b) the producer keeps every batch it
  makes behind a slow step; (c) the batches after a restore are the
  uninterrupted run's.  A checkpoint the reference writes restores.
* The slice as a whole: the port's ``Trainer`` over ``launch/train.py``'s
  tenants with a cache that evicts nothing, then the reference's compiled
  ``make_train_step`` over the batches the port's trainer consumed, from the
  same weights: losses within 1e-3, weights within the train-step
  tolerance; the batches are the reference pipeline's.

No test here orders threads by the clock: a ``batch_fn`` the test controls
and ``threading.Event``s do, and a wait that should not end is given 10x the
reference's own 0.5 s timeout.
"""

import dataclasses
import functools
import hashlib
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as ref_ckpt
import repro.configs as RC
import repro.data.pipeline as RP
import repro.launch.train as ref_launch
import repro.models as RM
import repro.train.optimizer as RO
import repro.train.train_step as RTS
import repro_torch.data.pipeline as port_pipeline
import repro_torch.launch.train as port_launch
from repro_torch.configs import get_config
from repro_torch.data import DedupIngestPipeline, TenantSpec
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import adamw_state_from_jax, params_from_jax
from repro_torch.pytree import flatten_with_path, leaves, tree_map
from repro_torch.train.optimizer import AdamW, apply_updates
from repro_torch.train.train_step import (
    make_grad_accum_train_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    trainable,
)
from repro_torch.train.trainer import PrefetchQueue, Trainer, TrainerConfig

REL = 1e-6
WAIT_S = 60.0  # a join or wait that must end; far beyond any step here
REF_PUT_TIMEOUT_S = 0.5  # the reference producer's ``put`` timeout


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The trainer runs torch CPU work on two threads at once (the step and
    the producer's pipeline).  With each test worker's intra-op pool as wide
    as the machine, that oversubscribes the cores many times over under
    ``pytest -n 6``, and a trainer test takes 40x its time alone; one
    intra-op thread a worker keeps it near that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@functools.lru_cache(maxsize=None)
def _ref_init():
    cfg = RC.get_config("tinyllama-1.1b", smoke=True)
    return jax.tree.map(np.asarray, RM.build_model(cfg).init(jax.random.PRNGKey(0)))


def _ref_models():
    """The reference's smoke TinyLlama (float32 compute), its parameters as
    numpy (initialised once, copied for each caller), and the port's model
    and parameters with the same weights."""
    cfg = RC.get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype="float32")
    ref = RM.build_model(cfg)
    tree = jax.tree.map(np.copy, _ref_init())
    port_cfg = get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype="float32")
    return ref, tree, build_model(port_cfg), params_from_jax(tree, port_cfg)


def _digest(batch) -> str:
    h = hashlib.blake2b(digest_size=16)
    for key in ("inputs", "targets", "mask"):
        h.update(np.ascontiguousarray(np.asarray(batch[key])).tobytes())
    return h.hexdigest()


def _join(thread: threading.Thread) -> None:
    thread.join(WAIT_S)
    assert not thread.is_alive(), "a thread did not end"


# -- AdamW -------------------------------------------------------------------------


def _grads(tree, rng, clipped: bool):
    """Gradients in the reference's layout.  Unclipped: normal, with a norm
    well under 1, so the clip's scale is exactly 1 in both packages.
    Clipped: multiples of 2^-6 up to 1, whose squares and their sums are
    exact in float32, so both packages clip by the same scale although they
    sum the norm in another order."""
    if clipped:
        return jax.tree.map(
            lambda x: (rng.integers(-64, 65, x.shape) / 64.0).astype(np.float32), tree)
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(np.float32), tree)


@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adamw_update_matches_reference(schedule, moment_dtype, clipped):
    """Step 1 from ``init`` and step 5 from the reference's state after four
    steps, carried over with ``adamw_state_from_jax``."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, schedule=schedule,
              moment_dtype=moment_dtype)
    ref, mine = RO.AdamW(**kw), AdamW(**kw)
    _, tree, port, _ = _ref_models()
    rng = np.random.default_rng(7)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref.init(rp)
    for step in (1, 5):
        while int(rs.step) < step - 1:  # the reference alone, to reach step 4
            upd, rs = ref.update(jax.tree.map(jnp.asarray, _grads(tree, rng, False)), rs, rp)
            rp = RO.apply_updates(rp, upd)
        mp = params_from_jax(jax.tree.map(np.asarray, rp), port.cfg)
        ms = adamw_state_from_jax(jax.tree.map(np.asarray, rs), port.cfg)
        assert int(ms.step) == step - 1
        g = _grads(tree, rng, clipped)
        rupd, rs_next = ref.update(jax.tree.map(jnp.asarray, g), rs, rp)
        mupd, ms = mine.update(params_from_jax(g, port.cfg), ms, mp)
        assert int(ms.step) == int(rs_next.step) == step
        want = params_from_jax(jax.tree.map(np.asarray, RO.apply_updates(rp, rupd)), port.cfg)
        got = apply_updates(mp, mupd)
        for (path, w), r in zip(flatten_with_path(got), leaves(want)):
            assert _rel(w.numpy(), r.numpy()) <= REL, (step, path)
        for mine_m, ref_m in ((ms.mu, rs_next.mu), (ms.nu, rs_next.nu)):
            ref_m = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), ref_m),
                                    port.cfg)
            for (path, m), r in zip(flatten_with_path(mine_m), leaves(ref_m)):
                assert m.dtype == getattr(torch, moment_dtype), path
                assert _rel(m.float().numpy(), r.numpy()) <= REL, (step, path)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_update_in_place_equals_update(moment_dtype, monkeypatch):
    """The train steps' ``update_in_place`` (moments and weights written in
    place, a leaf at a time in pieces, here of 7 elements) equals ``update``
    then ``apply_updates`` bit for bit, at steps 1 and 2 with the clip
    acting."""
    import repro_torch.train.optimizer as port_opt

    monkeypatch.setattr(port_opt, "IN_PLACE_PIECE", 7)
    opt = AdamW(learning_rate=1e-2, warmup_steps=2, moment_dtype=moment_dtype)
    _, tree, port, _ = _ref_models()
    gen = torch.Generator().manual_seed(3)
    a = params_from_jax(tree, port.cfg)
    b = tree_map(torch.clone, a)
    sa, sb = opt.init(a), opt.init(b)
    for _ in range(2):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 3, a)
        upd, sa = opt.update(grads, sa, a)
        apply_updates(a, upd)
        sb = opt.update_in_place(grads, sb, b)
        assert int(sa.step) == int(sb.step)
        for x, y in zip(leaves((a, sa.mu, sa.nu)), leaves((b, sb.mu, sb.nu))):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_reference(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=10, total_steps=150, schedule=schedule)
    ref, mine = RO.AdamW(**kw), AdamW(**kw)
    for step in range(201):
        got, want = float(mine.lr_at(step)), float(ref.lr_at(jnp.int32(step)))
        assert abs(got - want) <= REL * max(abs(want), 1e-30), step


def test_weight_decay_mask_is_pinned_per_leaf():
    """Decoupled decay acts where a leaf has two or more dimensions: the
    stacked per-layer norm scales (layers, d) decay and ``final_ln`` (d,)
    does not, as in the reference, whose scan stacks its layers the same
    way.  Zero gradients: what moves is the decay alone."""
    _, tree, port, _ = _ref_models()
    tree = jax.tree.map(lambda x: np.full_like(x, 0.5), tree)
    zeros = jax.tree.map(np.zeros_like, tree)
    kw = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=1, schedule="constant")
    p = params_from_jax(tree, port.cfg)
    mupd, _ = AdamW(**kw).update(params_from_jax(zeros, port.cfg), AdamW(**kw).init(p), p)
    rp = jax.tree.map(jnp.asarray, tree)
    rupd, _ = RO.AdamW(**kw).update(jax.tree.map(jnp.asarray, zeros), RO.AdamW(**kw).init(rp), rp)
    decays = {"/".join(path): bool(u.any()) for path, u in flatten_with_path(mupd)}
    assert decays == {"embed": True, "unembed": True, "final_ln": False,
                      **{f"scan/pos0/{k}": True for k in ("ln1", "ln2")},
                      **{f"scan/pos0/mixer/{k}": True for k in ("wq", "wk", "wv", "wo")},
                      **{f"scan/pos0/mlp/{k}": True for k in ("w_in", "w_gate", "w_out")}}
    want = params_from_jax(jax.tree.map(np.asarray, rupd), port.cfg)
    for (path, u), r in zip(flatten_with_path(mupd), leaves(want)):
        assert (_rel(u.numpy(), r.numpy()) <= REL) if r.any() else not u.any(), path


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_minimizes_quadratic(moment_dtype):
    opt = AdamW(learning_rate=0.1, weight_decay=0.0, warmup_steps=1, schedule="constant",
                moment_dtype=moment_dtype)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - 1.0)}
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
    np.testing.assert_allclose(params["w"].numpy(), 1.0, atol=1e-2)


def test_warmup_then_decay():
    opt = AdamW(learning_rate=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(opt.lr_at(s)) for s in range(1, 100, 7)]
    assert lrs[0] < lrs[1]
    assert lrs[-1] < max(lrs)


def test_grad_clip_bounds_update():
    opt = AdamW(learning_rate=1.0, grad_clip_norm=1.0, warmup_steps=1, schedule="constant",
                weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    upd, _ = opt.update({"w": torch.full((3,), 1e6)}, opt.init(params), params)
    assert float(upd["w"].abs().max()) <= 1.1


def test_moment_state_mirrors_param_tree():
    params = {"a": torch.zeros(4, 4), "b": {"c": torch.zeros(3)}}
    st = AdamW().init(params)
    for tree in (st.mu, st.nu):
        assert [p for p, _ in flatten_with_path(tree)] == [p for p, _ in flatten_with_path(params)]
    assert st.step.dtype == torch.int32 and int(st.step) == 0


# -- train steps -------------------------------------------------------------------

LR = 1e-3


def _batch(vocab, b=4, s=32, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": np.ones((b, s), np.float32)}


def _weights_close(got, want, lr=LR):
    """The train-step tolerance: every weight within 2.5 x lr of the
    reference's, and at least 99.9% of them within 1e-5."""
    diffs = torch.cat([(x.detach() - y).abs().flatten() for x, y in zip(leaves(got), leaves(want))])
    assert float(diffs.max()) <= 2.5 * lr, float(diffs.max())
    assert float((diffs <= 1e-5).float().mean()) >= 0.999, float((diffs > 1e-5).sum())


def _step_pair(make_ref, make_port):
    """One step of each package from equal weights and batch: the reference's
    loss and weights (in the port's layout), and the port's."""
    ref, tree, port, params = _ref_models()
    opt_kw = dict(learning_rate=LR, warmup_steps=1, schedule="constant")
    batch = _batch(port.cfg.vocab_size)
    rp = jax.tree.map(jnp.asarray, tree)
    ropt = RO.AdamW(**opt_kw)
    rp, _, rloss, _ = jax.jit(make_ref(ref, ropt))(rp, ropt.init(rp),
                                                   jax.tree.map(jnp.asarray, batch))
    opt = AdamW(**opt_kw)
    mp = trainable(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mp, state, loss, _ = make_port(port, opt)(mp, opt.init(mp), tb)
    assert int(state.step) == 1
    return float(rloss), params_from_jax(jax.tree.map(np.asarray, rp), port.cfg), float(loss), mp


def test_train_step_matches_reference():
    rloss, rp, loss, mp = _step_pair(RTS.make_train_step, make_train_step)
    assert abs(loss - rloss) <= 1e-5
    _weights_close(mp, rp)


def test_grad_accum_train_step_matches_reference():
    rloss, rp, loss, mp = _step_pair(lambda m, o: RTS.make_grad_accum_train_step(m, o, 2),
                                     lambda m, o: make_grad_accum_train_step(m, o, 2))
    assert abs(loss - rloss) <= 1e-5
    _weights_close(mp, rp)
    _, _, port, params = _ref_models()
    opt = AdamW(learning_rate=LR, warmup_steps=1, schedule="constant")
    plain = trainable(params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(port.cfg.vocab_size).items()}
    plain, _, plain_loss, _ = make_train_step(port, opt)(plain, opt.init(plain), batch)
    assert abs(loss - float(plain_loss)) < 0.05  # as tests/test_trainer_fault_tolerance.py holds
    assert max(float((a - b).detach().abs().max()) for a, b in zip(leaves(mp), leaves(plain))) < 0.05


def test_serve_and_prefill_steps_take_master_weights():
    _, _, port, params = _ref_models()
    cfg = port.cfg
    step = make_serve_step(port)
    port.load(params)
    want, _ = port.decode_step(port.init_cache(1, 4), torch.tensor([[3]]), 0)
    got, _ = step(trainable(params), port.init_cache(1, 4), torch.tensor([[3]]), 0)
    assert not got.requires_grad and got.dtype == getattr(torch, cfg.compute_dtype)
    assert torch.equal(got, want)
    toks = torch.tensor([[3, 9, 4]])
    logits, cache = make_prefill_step(port)(trainable(params), {"inputs": toks})
    want, want_cache = transformer.prefill(params, toks, None, cfg)
    assert not logits.requires_grad and torch.equal(logits, want)
    assert torch.equal(cache.k, want_cache.k) and torch.equal(cache.v, want_cache.v)


# -- the prefetch queue ------------------------------------------------------------


def _counter():
    """A batch function returning 1, 2, 3, ..., and the count of its calls."""
    calls = {"n": 0}

    def batch_fn():
        calls["n"] += 1
        return calls["n"]

    return batch_fn, calls


def test_straggler_backup_fires():
    """The third batch is late: the producer is held inside ``batch_fn``
    until the consumer's deadline has passed and a backup has fired.  The
    backup waits for the batch function's lock and then takes the batch the
    producer queued, so the batches stay in order."""
    batch_fn, calls = _counter()
    gate = threading.Event()

    def held_batch():
        if calls["n"] == 2:
            assert gate.wait(WAIT_S)
        return batch_fn()

    q = PrefetchQueue(held_batch, depth=1)
    release = threading.Thread(target=lambda: _release_after_backup(q, gate), daemon=True)
    release.start()
    try:
        got = [q.get(None), q.get(None), q.get(deadline_s=0.01), q.get(None)]
    finally:
        gate.set()
        q.stop()
    _join(release)
    assert q.backup_fires == 1
    assert got == [1, 2, 3, 4]


def _release_after_backup(q: PrefetchQueue, gate: threading.Event) -> None:
    while q.backup_fires == 0 and not gate.is_set():
        gate.wait(0.001)
    gate.set()


def test_producer_failure_reaches_get():
    """Repair (a): the reference's producer thread dies in silence when
    ``batch_fn`` raises, and the next ``get(None)`` waits forever.  The
    port's ``get`` raises the exception after the batches made before it,
    and on every later call; ``snapshot`` raises it too."""
    batch_fn, calls = _counter()

    def fn():
        if calls["n"] == 2:
            raise RuntimeError("launch failed")
        return batch_fn()

    q = PrefetchQueue(fn, depth=2)
    outcome = []

    def consume():
        try:
            outcome.extend(q.get(None) for _ in range(3))
        except RuntimeError as e:
            outcome.append(str(e))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    _join(t)
    assert outcome == [1, 2, "launch failed"]
    with pytest.raises(RuntimeError, match="launch failed"):
        q.get(None)
    with pytest.raises(RuntimeError, match="launch failed"):
        q.snapshot(dict)
    assert q.stop() == []


def test_producer_keeps_its_batches_behind_a_slow_step():
    """Repair (b): the reference's producer makes a batch, and when the queue
    stays full for 0.5 s drops it and makes the next, so a trainer behind a
    slow step skips batches.  The port's producer makes no batch while the
    queue is full: with a consumer stalled for 10x the reference's timeout,
    ``batch_fn`` is not called a second time, and the batches come in order."""
    batch_fn, calls = _counter()
    second = threading.Event()

    def fn():
        n = batch_fn()
        if n == 2:
            second.set()
        return n

    q = PrefetchQueue(fn, depth=1)
    try:
        assert not second.wait(10 * REF_PUT_TIMEOUT_S)  # the slow step
        assert calls["n"] == 1
        got = [q.get(None) for _ in range(3)]
    finally:
        rest = q.stop()
    assert got == [1, 2, 3]
    assert got + rest == list(range(1, calls["n"] + 1))


def test_snapshot_holds_the_batches_made_but_not_served():
    """Repair (c), in the queue: the batch function's state is taken while
    no batch is being made, beside exactly the batches made before it and
    not yet served; after a restore of that state, a queue primed with them
    serves them first and then goes on where the state left off."""
    state = {"made": 0}

    def fn():
        state["made"] += 1
        return state["made"]

    q = PrefetchQueue(fn, depth=3)
    assert q.get(None) == 1
    snap, pending = q.snapshot(lambda: dict(state))
    rest = q.stop()
    assert pending == list(range(2, snap["made"] + 1))
    assert rest[:len(pending)] == pending
    state.update(snap)  # a restore
    q = PrefetchQueue(fn, depth=3, primed=pending)
    try:
        got = [q.get(None) for _ in range(6)]
    finally:
        q.stop()
    assert got == list(range(2, 8))


# -- the trainer -------------------------------------------------------------------


def _setup(tenants=None, **pipe_kw):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tenants = tenants or [TenantSpec(0, rate=2.0, dup_ratio=0.6, locality="good"),
                          TenantSpec(1, rate=1.0, dup_ratio=0.1, locality="weak")]
    kw = dict(block_tokens=32, vocab=cfg.vocab_size, cache_entries=256, fingerprint_batch=16)
    kw.update(pipe_kw)
    pipe = DedupIngestPipeline(tenants, device="cpu", **kw)
    return cfg, model, params, pipe


def _recording(tr: Trainer) -> list:
    """The digest of each batch ``tr`` consumes, in order."""
    consumed, to_device = [], tr._device_batch
    tr._device_batch = lambda b: (consumed.append(_digest(b)), to_device(b))[1]
    return consumed


def test_chaos_recovery_and_loss_decreases(tmp_path):
    cfg, model, params, pipe = _setup()
    it = pipe.batches(batch_size=4, seq_len=64)
    fired = {"n": 0}

    def chaos(step):
        if step == 8 and fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("node died")

    tr = Trainer(model, AdamW(learning_rate=1e-3, warmup_steps=3), params, it,
                 TrainerConfig(steps=12, ckpt_dir=str(tmp_path), ckpt_every=4, log_every=0),
                 pipeline_state_fn=pipe.state_dict, pipeline_restore_fn=pipe.load_state,
                 chaos=chaos)
    out = tr.run()
    assert out["restarts"] == 1
    assert out["final_step"] == 12
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3]) + 0.02
    assert pipe.metrics.blocks_deduped_inline > 0


def _recorded_run(tmp_path, chaos_at=None, fail_launch_at_ckpt=None, ckpt_async=False):
    """10 steps, a checkpoint every 5, optionally a failure before step
    ``chaos_at``, or ``fail_launch_at_ckpt`` called where the first
    checkpoint takes the pipeline's state; the run's outcome and the digests
    of the batches the trainer consumed, in order."""
    cfg, model, params, pipe = _setup()
    fired = []

    def state_fn():
        if fail_launch_at_ckpt:
            fail_launch_at_ckpt()
        return pipe.state_dict()

    def chaos(step):
        if step == chaos_at and not fired:
            fired.append(step)
            raise RuntimeError("node died")

    tr = Trainer(model, AdamW(learning_rate=1e-3, warmup_steps=3), params,
                 pipe.batches(batch_size=4, seq_len=64),
                 TrainerConfig(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=0,
                               ckpt_async=ckpt_async),
                 pipeline_state_fn=state_fn, pipeline_restore_fn=pipe.load_state,
                 chaos=chaos)
    consumed = _recording(tr)
    return tr.run(), consumed


def test_batches_after_a_restore_are_the_uninterrupted_runs(tmp_path):
    """Repair (c): the checkpoint at step 5 holds the pipeline's state with
    the batches made ahead of the trainer (as many as the producer had made
    by then); after the failure before step 7, steps 5-9 consume the
    uninterrupted run's batches 5-9 and give its losses.  The reference's
    checkpoint skips the batches its producer had made ahead."""
    plain, want = _recorded_run(tmp_path / "plain")
    out, got = _recorded_run(tmp_path / "chaos", chaos_at=7)
    assert (out["restarts"], out["final_step"], plain["restarts"]) == (1, 10, 0)
    assert got[:7] == want[:7] and got[7:] == want[5:]
    np.testing.assert_allclose(out["losses"], plain["losses"], atol=1e-5)


def _fail_a_fingerprint_launch(monkeypatch):
    """Patch the pipeline's fingerprint call; returns ``arm``, after which
    the next launch raises (once)."""
    armed = []
    real = port_pipeline.fingerprint_ints

    def flaky(*args, **kwargs):
        if armed == ["armed"]:
            armed[0] = "fired"
            raise RuntimeError("fingerprint launch failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(port_pipeline, "fingerprint_ints", flaky)
    return lambda: armed or armed.append("armed")


def test_trainer_restores_after_a_failed_fingerprint_launch(tmp_path, monkeypatch, capsys):
    """Repair (a) in the trainer: the launcher's batch source, ``pipe.batches``,
    hits a failed fingerprint launch in the producer after the checkpoint at
    step 5; the trainer counts one restart, restores, and goes on with the
    uninterrupted run's batches and losses."""
    plain, want = _recorded_run(tmp_path / "plain")
    arm = _fail_a_fingerprint_launch(monkeypatch)
    out, got = _recorded_run(tmp_path / "fail", fail_launch_at_ckpt=arm)
    assert "RuntimeError: fingerprint launch failed); restored=True" in capsys.readouterr().out
    assert (out["restarts"], out["final_step"]) == (1, 10)
    assert got[:5] == want[:5] and got[-5:] == want[5:]
    np.testing.assert_allclose(out["losses"], plain["losses"], atol=1e-5)


def test_trainer_retries_a_failed_producer_without_a_checkpoint():
    """A batch that fails in the producer thread with nothing to restore: the
    trainer counts a restart, starts a new producer and goes on."""
    cfg, model, params, pipe = _setup()
    source = pipe.batches(batch_size=2, seq_len=32)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("fingerprint launch failed")
        return next(source)

    out = Trainer(model, AdamW(learning_rate=1e-3, warmup_steps=1), params,
                  iter(flaky, None), TrainerConfig(steps=5, log_every=0)).run()
    assert (out["restarts"], out["final_step"], len(out["losses"])) == (1, 5, 5)


def test_trainer_ends_when_its_batch_iterator_ends():
    cfg, model, params, pipe = _setup()
    batches = [pipe.next_batch(2, 32) for _ in range(2)]
    tr = Trainer(model, AdamW(learning_rate=1e-3, warmup_steps=1), params, iter(batches),
                 TrainerConfig(steps=5, log_every=0))
    with pytest.raises(RuntimeError, match="the batch iterator ended"):
        tr.run()
    assert tr.step == 2


def test_reference_checkpoint_restores(tmp_path):
    """A checkpoint the reference's ``ckpt.save`` wrote, of the port's tree
    and with the reference trainer's ``extra`` (no ``prefetched``): a
    failure before step 3 restores it (step 2, its losses and pipeline
    state) and the run goes on from there to the end."""
    cfg, model, params, pipe = _setup()
    opt = AdamW(learning_rate=1e-3, warmup_steps=1)
    for _ in range(3):
        pipe.next_batch(4, 64)
    saved = {"params": tree_map(lambda t: t.numpy() + 0.25, params),
             "opt": tree_map(lambda t: t.numpy(), opt.init(params))}
    saved["opt"] = saved["opt"]._replace(step=np.int32(2))
    from repro_torch.train.trainer import _jsonable
    extra = {"losses": [6.5, 6.25], "step": 2, "pipeline": _jsonable(pipe.state_dict())}
    ref_ckpt.save(str(tmp_path), 2, saved, extra=extra)
    want_next = [_digest(pipe.next_batch(4, 64)) for _ in range(2)]

    _, model, params, fresh = _setup()
    fired = []

    def chaos(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("node died")

    tr = Trainer(model, opt, params, fresh.batches(4, 64),
                 TrainerConfig(steps=4, ckpt_dir=str(tmp_path), ckpt_every=0, log_every=0),
                 pipeline_state_fn=fresh.state_dict, pipeline_restore_fn=fresh.load_state,
                 chaos=chaos)
    consumed = _recording(tr)
    out = tr.run()
    assert (out["restarts"], out["final_step"]) == (1, 4)
    assert out["losses"][:2] == [6.5, 6.25]
    assert consumed[3:] == want_next
    assert int(tr.opt_state.step) == 4


def test_dedup_training_end_to_end(tmp_path):
    cfg, model, params, pipe = _setup(
        tenants=[TenantSpec(0, rate=3.0, dup_ratio=0.8, locality="good", overlap_group="g"),
                 TenantSpec(1, rate=1.0, dup_ratio=0.05, locality="weak", overlap_group="g"),
                 TenantSpec(2, rate=0.5, dup_ratio=0.4, locality="good")],
        cache_entries=512, postprocess_every_blocks=1024)
    tr = Trainer(model, AdamW(learning_rate=2e-3, warmup_steps=3), params,
                 pipe.batches(batch_size=4, seq_len=64),
                 TrainerConfig(steps=14, ckpt_dir=str(tmp_path), ckpt_every=7, log_every=0),
                 pipeline_state_fn=pipe.state_dict, pipeline_restore_fn=pipe.load_state)
    out = tr.run()
    m = pipe.metrics
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])
    assert m.blocks_deduped_inline > 0.2 * m.blocks_in
    eng = pipe.engine
    eng.run_postprocess(to_exact=True)
    assert eng.store.duplicate_fingerprints() == []


# -- the slice as a whole ------------------------------------------------------------


def test_trainer_matches_reference_train_steps_over_the_launchers_tenants():
    """The port's ``Trainer`` for 12 steps over ``default_tenants()`` at the
    launcher's block size, learning rate and warmup, with a cache that
    evicts nothing; then the reference's compiled ``make_train_step`` over
    the batches the port consumed, one step at a time, from the same
    weights.  The batches are the reference pipeline's ``next_batch``
    output, batch by batch with its metrics."""
    steps, (b, s) = 12, (8, 256)
    ref, tree, port, params = _ref_models()
    assert [dataclasses.asdict(t) for t in port_launch.default_tenants()] == \
        [dataclasses.asdict(t) for t in ref_launch.default_tenants()]
    kw = dict(block_tokens=64, vocab=port.cfg.vocab_size, cache_entries=1 << 16, seed=0)
    opt_kw = dict(learning_rate=LR, warmup_steps=max(steps // 20, 5), total_steps=steps)
    pipe = DedupIngestPipeline(port_launch.default_tenants(), device="cpu", **kw)
    tr = Trainer(port, AdamW(**opt_kw), params, pipe.batches(b, s),
                 TrainerConfig(steps=steps, log_every=0))
    consumed = []
    to_device = tr._device_batch
    tr._device_batch = lambda batch: (consumed.append(batch), to_device(batch))[1]
    out = tr.run()
    assert (out["final_step"], out["restarts"], len(consumed)) == (steps, 0, steps)

    ref_pipe = RP.DedupIngestPipeline(ref_launch.default_tenants(), **kw)
    want = [ref_pipe.next_batch(b, s) for _ in range(steps)]
    assert [_digest(x) for x in consumed] == [_digest(x) for x in want]

    ropt = RO.AdamW(**opt_kw)
    step = jax.jit(RTS.make_train_step(ref, ropt))
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ropt.init(rp)
    losses = []
    for batch in consumed:
        rp, rs, loss, _ = step(rp, rs, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    np.testing.assert_allclose(out["losses"], losses, atol=1e-3)
    _weights_close(tr.params, params_from_jax(jax.tree.map(np.asarray, rp), port.cfg))


def test_launcher_prints_the_reference_fields(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "tinyllama-1.1b", "--smoke",
                                      "--steps", "3", "--device", "cpu"])
    port_launch.main()
    text = capsys.readouterr().out
    out = json.loads(text[text.index("{"):])
    assert list(out) == ["final_loss", "first_loss", "steps", "restarts", "ingest_blocks",
                         "inline_deduped", "dedup_saving"]
    assert out["steps"] == 3 and out["restarts"] == 0 and out["ingest_blocks"] > 0
    assert np.isfinite(out["final_loss"]) and np.isfinite(out["first_loss"])


def test_launcher_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_launch.main()
