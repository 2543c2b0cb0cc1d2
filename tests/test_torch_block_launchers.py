"""The other block kinds behind the port's entry points, on the CPU at smoke
size: the KV-page server (``serving/dedup_kv.py``, ``launch/serve.py``) and
the training launcher (``launch/train.py``).

* ``DedupKVServer`` serves a model whose decode cache is one KV cache a
  layer, with no window under ``max_slots``: Mixtral (a smoke variant with
  its window at 128, ``max_slots``) and Qwen2-VL give the reference's
  metrics, pages and decoded tokens (float32), and decode as a server that
  caches nothing does.  It raises ``ValueError`` naming the reason for a
  recurrent cache (RecurrentGemma, RWKV6: the reference's server raises
  ``TypeError`` on them), a window under ``max_slots`` (Mixtral's smoke
  window of 32: the reference's ``dynamic_slice_in_dim`` clamps a page's
  start and returns other positions) and an encoder-decoder model (the
  reference's launcher refuses it).
* ``launch/train.py``'s ``build`` trains every decoder-only id for a step
  and refuses Whisper.  The launcher's trainer on RWKV6 and Mixtral for 3
  steps, then the reference's compiled ``make_train_step`` over the batches
  it consumed, from the same weights: losses within 1e-3, weights within the
  train-step tolerance (every weight within 2.5 x lr, 99.9% within 1e-5).
  No test orders threads by the clock.
"""

import argparse
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.data.pipeline as RP
import repro.launch.serve as ref_serve
import repro.launch.train as ref_launch
import repro.models as RM
import repro.serving.dedup_kv as RS
import repro.train.optimizer as RO
import repro.train.train_step as RTS
import repro_torch.launch.serve as port_serve
import repro_torch.launch.train as port_launch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.pytree import leaves
from repro_torch.serving import dedup_kv as PS

SERVED = {"mixtral-8x7b": {"attn_window": 128}, "qwen2-vl-7b": {}}


def _models(arch, extra, compute_dtype="float32"):
    cfg = RC.get_config(arch, smoke=True).replace(compute_dtype=compute_dtype, **extra)
    ref = RM.build_model(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port_cfg = get_config(arch, smoke=True).replace(compute_dtype=compute_dtype, **extra)
    port = build_model(port_cfg).load(params_from_jax(tree, port_cfg))
    return ref, jax.tree.map(jnp.asarray, tree), port


def _mix(srv, vocab, rng):
    prompt = rng.integers(0, vocab, 48)
    return [srv.prefill_request(0, np.concatenate([prompt, rng.integers(0, vocab, 8)]))
            for _ in range(4)], prompt


@pytest.mark.parametrize("arch", list(SERVED))
def test_server_matches_reference(arch):
    ref, params, port = _models(arch, SERVED[arch])
    kw = dict(page_tokens=16, max_slots=128, cache_entries=128)
    ref_srv = RS.DedupKVServer(ref, params, **kw)
    srv = PS.DedupKVServer(port, None, device="cpu", **kw)
    ref_out, _ = _mix(ref_srv, 512, np.random.default_rng(0))
    out, _ = _mix(srv, 512, np.random.default_rng(0))
    assert dataclasses.asdict(srv.metrics) == dataclasses.asdict(ref_srv.metrics)
    assert srv.metrics.blocks_prefill_skipped > 0
    assert [o[1:] for o in out] == [o[1:] for o in ref_out]
    assert sorted(srv.pages) == sorted(ref_srv.pages)
    for (c, p, _), (rc, rp, _) in zip(out, ref_out):
        assert srv.decode(c, p, steps=3)[0] == ref_srv.decode(rc, rp, steps=3)[0]
    nodedup = PS.DedupKVServer(port, None, device="cpu", **{**kw, "cache_entries": 0})
    rng = np.random.default_rng(0)
    _, prompt = _mix(nodedup, 512, np.random.default_rng(0))
    toks = np.concatenate([prompt, rng.integers(0, 512, 8)])
    (c1, p1, info), (c2, p2, _) = srv.prefill_request(0, toks), nodedup.prefill_request(0, toks)
    assert info["hit_blocks"] == 3 and torch.equal(c1.k, c2.k)
    assert srv.decode(c1, p1, steps=4)[0] == nodedup.decode(c2, p2, steps=4)[0]


@pytest.mark.parametrize("arch,reason", [
    ("recurrentgemma-2b", "recurrent state"), ("rwkv6-1.6b", "recurrent state"),
    ("mixtral-8x7b", "window of 32 under max_slots 64"),
    ("whisper-small", "encoder-decoder")])
def test_server_refuses_what_it_cannot_page(arch, reason):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    with pytest.raises(ValueError, match=reason):
        PS.DedupKVServer(model, model.init(torch.Generator().manual_seed(0)), max_slots=64,
                         device="cpu")


def test_reference_server_fails_on_a_recurrent_cache():
    """The fault the first refusal reflects: the reference's page slice
    takes axis -3 of every leaf, which an RG-LRU state lacks."""
    cfg = RC.get_config("recurrentgemma-2b", smoke=True)
    ref = RM.build_model(cfg)
    srv = RS.DedupKVServer(ref, ref.init(jax.random.PRNGKey(0)), page_tokens=16, max_slots=64)
    with pytest.raises(TypeError, match="slice_sizes"):
        srv.prefill_request(0, np.arange(48) % cfg.vocab_size)


def test_reference_page_of_a_ring_is_clamped():
    """The fault the second refusal reflects: on a 32-slot ring the
    reference's page of slots 40-55 is slots 16-31, positions the page does
    not hold."""
    ring = jnp.arange(32)[None, :, None, None] * jnp.ones((1, 32, 1, 2))
    page = RS._slot_slice({"k": ring}, 40, 16)["k"]
    assert np.array_equal(np.asarray(page[0, :, 0, 0]), np.arange(16, 32))


def test_serve_cli_on_qwen2_vl_matches_reference(monkeypatch, capsys):
    args = ["--arch", "qwen2-vl-7b", "--smoke", "--requests", "8", "--decode-steps", "2"]
    outs = []
    for main, extra in ((ref_serve.main, []), (port_serve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve", *args, *extra])
        main()
        outs.append(json.loads(capsys.readouterr().out))
    ref_out, out = outs
    assert len(out.pop("decoded_tokens")) == len(ref_out.pop("decoded_tokens")) == 2
    assert out == ref_out and out["blocks_prefill_skipped"] > 0


# -- the training launcher -----------------------------------------------------------


def _args(arch, steps, **kw):
    args = port_launch.parse_args(["--arch", arch, "--smoke", "--steps", str(steps),
                                   "--device", "cpu", "--batch", "2", "--seq", "64"])
    return argparse.Namespace(**{**vars(args), **kw})


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if not get_config(a).is_encdec])
def test_build_trains_every_decoder_only_id(arch):
    trainer, pipe = port_launch.build(_args(arch, 1))
    out = trainer.run()
    assert out["final_step"] == 1 and np.isfinite(out["losses"]).all()
    assert pipe.metrics.blocks_in > 0


def test_build_refuses_an_encoder_decoder_model():
    with pytest.raises(ValueError, match="encoder_embeds"):
        port_launch.build(_args("whisper-small", 1))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "mixtral-8x7b"])
def test_launcher_trainer_matches_reference_train_steps(arch):
    steps, lr = 3, 1e-3
    args = _args(arch, steps, lr=lr)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    rcfg = RC.get_config(arch, smoke=True).replace(compute_dtype="float32")
    ref = RM.build_model(rcfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    trainer, pipe = port_launch.build(args, cfg=cfg)
    params = params_from_jax(tree, cfg)
    for mine, theirs in zip(leaves(trainer.params), leaves(params)):
        mine.data.copy_(theirs)   # the reference's weights, in the trainer's own tensors
    start = [t.detach().clone() for t in leaves(trainer.params)]
    consumed = []
    to_device = trainer._device_batch
    trainer._device_batch = lambda batch: (consumed.append(batch), to_device(batch))[1]
    out = trainer.run()
    assert (out["final_step"], out["restarts"], len(consumed)) == (steps, 0, steps)
    ref_pipe = RP.DedupIngestPipeline(ref_launch.default_tenants(), block_tokens=64,
                                      vocab=cfg.vocab_size, cache_entries=4096, seed=0)
    for got in consumed:
        want = ref_pipe.next_batch(2, 64)
        assert all(np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
                   for k in ("inputs", "targets", "mask"))
    ropt = RO.AdamW(learning_rate=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    step = jax.jit(RTS.make_train_step(ref, ropt))
    rp = jax.tree.map(jnp.asarray, tree)
    assert all(torch.equal(a, b) for a, b in zip(start, leaves(params)))
    rs = ropt.init(rp)
    losses = []
    for batch in consumed:
        rp, rs, loss, _ = step(rp, rs, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    np.testing.assert_allclose(out["losses"], losses, atol=1e-3)
    want = params_from_jax(jax.tree.map(np.asarray, rp), cfg)
    diffs = torch.cat([(x.detach() - y).abs().flatten()
                       for x, y in zip(leaves(trainer.params), leaves(want))])
    assert float(diffs.max()) <= 2.5 * lr, float(diffs.max())
    assert float((diffs <= 1e-5).float().mean()) >= 0.999
