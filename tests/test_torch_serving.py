"""The port's serving path (model stack + KV-page dedup server) against the
reference, on the CPU at TinyLlama's smoke size.

* ``decode_step`` logits of ``repro_torch.models`` equal ``repro.models``'
  with the reference's weights carried over by ``params_from_jax``:
  float32 compute within atol 1e-4, bf16 within 5e-2 (the two frameworks
  round bf16 at other places).
* ``chain_fingerprint`` and ``chain_fingerprints_batched`` equal bit for bit.
* ``DedupKVServer`` gives the reference's ``ServeMetrics`` and pages on the
  reference test's request mix, and its decoded tokens (float32 compute; in
  bf16 its logits, within 5e-2), and it decodes the same as a server that
  caches nothing (page reuse is exact).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core as R
import repro.models.layers as RL
import repro.launch.serve as ref_serve
import repro.models as RM
import repro.serving.dedup_kv as RS
import repro_torch.launch.serve as port_serve
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import HPDedup, ShardedCluster, snapshot_engine
from repro_torch.launch.serve import request_mix
from repro_torch.models import build_model, layers
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import dedup_kv as PS

ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _models(compute_dtype="bfloat16", seed=0, scales=True):
    """The reference's smoke TinyLlama and the port's with the same weights;
    with ``scales`` the zero-initialised norm scales get random values, so
    the ``(1 + scale)`` path is exercised."""
    cfg = RC.get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=compute_dtype)
    ref = RM.build_model(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    if scales:
        rng = np.random.default_rng(seed)
        layer = tree["scan"]["pos0"]
        for name in ("ln1", "ln2"):
            layer[name] = rng.normal(0, 0.2, layer[name].shape).astype(np.float32)
        tree["final_ln"] = rng.normal(0, 0.2, tree["final_ln"].shape).astype(np.float32)
    port_cfg = get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=compute_dtype)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    port = build_model(port_cfg).load(params_from_jax(tree, port_cfg))
    return ref, jax.tree.map(jnp.asarray, tree), port


def test_configs_match_reference():
    assert ARCH_IDS == RC.ARCH_IDS
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("tinyllama-1.1b", smoke)) == \
            dataclasses.asdict(RC.get_config("tinyllama-1.1b", smoke))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("mixtral-8x7b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_layers_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)), atol=1e-4)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    scale = rng.normal(0, 0.3, 64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(h), torch.from_numpy(scale), 1e-6).numpy(),
        np.asarray(RL.rms_norm(jnp.asarray(h), jnp.asarray(scale), 1e-6)), atol=1e-5)
    w = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in ((64, 96), (64, 96), (96, 64))]
    np.testing.assert_allclose(
        layers.mlp_apply(torch.from_numpy(h), *map(torch.from_numpy, w), "swiglu").numpy(),
        np.asarray(RL.mlp_apply(jnp.asarray(h), *map(jnp.asarray, w), "swiglu")), atol=1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_step_logits_match_reference(compute_dtype):
    ref, params, port = _models(compute_dtype)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, 12)
    ref_cache = ref.init_cache(1, 16)
    cache = port.init_cache(1, 16)
    for pos, t in enumerate(tokens):
        want, ref_cache = ref.decode_step(params, ref_cache, jnp.full((1, 1), t, jnp.int32),
                                          jnp.int32(pos))
        got, cache = port.decode_step(cache, torch.full((1, 1), int(t)), pos)
        assert got.dtype == getattr(torch, compute_dtype) and got.shape == (1, 512)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=ATOL[compute_dtype])
    ref_k = np.asarray(ref_cache["scan"]["pos0"].k, np.float32)
    np.testing.assert_allclose(cache.k.float().numpy(), ref_k, atol=ATOL[compute_dtype])


def test_decode_step_batched_rows_are_independent():
    _, _, port = _models("float32")
    cache = port.init_cache(2, 8)
    one = port.init_cache(1, 8)
    for pos, (a, b) in enumerate([(3, 7), (5, 5), (9, 2)]):
        both, cache = port.decode_step(cache, torch.tensor([[a], [b]]), pos)
        first, one = port.decode_step(one, torch.tensor([[a]]), pos)
        np.testing.assert_allclose(both[:1].numpy(), first.numpy(), atol=1e-6)


def test_chain_fingerprints_match_reference():
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 32000, (9, 16)).astype(np.int32)
    for prev in (0, 1, 0xDEADBEEFCAFEF00D):
        assert PS.chain_fingerprint(prev, blocks[0], device="cpu") == \
            RS.chain_fingerprint(prev, blocks[0])
        assert PS.chain_fingerprints_batched(prev, blocks, device="cpu") == \
            RS.chain_fingerprints_batched(prev, blocks)
    assert PS.chain_fingerprints_batched(0, blocks[:0], device="cpu") == []
    assert PS._mix64(0, 0) == RS._mix64(0, 0) and PS._mix64(2**63, 5) == RS._mix64(2**63, 5)


def _serve_mix(srv, vocab, rng):
    """The reference test's mix: four requests sharing a 48-token prompt."""
    prompt = rng.integers(0, vocab, 48)
    return [srv.prefill_request(0, np.concatenate([prompt, rng.integers(0, vocab, 8)]))
            for _ in range(4)], prompt


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_server_matches_reference(compute_dtype):
    ref, params, port = _models(compute_dtype, scales=False)
    kw = dict(page_tokens=16, max_slots=128, cache_entries=128)
    ref_srv = RS.DedupKVServer(ref, params, **kw)
    srv = PS.DedupKVServer(port, None, device="cpu", **kw)
    ref_out, prompt = _serve_mix(ref_srv, 512, np.random.default_rng(0))
    out, _ = _serve_mix(srv, 512, np.random.default_rng(0))
    assert dataclasses.asdict(srv.metrics) == dataclasses.asdict(ref_srv.metrics)
    assert srv.metrics.blocks_prefill_skipped > 0 and srv.metrics.prefill_saving > 0.2
    assert [o[1:] for o in out] == [o[1:] for o in ref_out]  # positions and hit counts
    assert sorted(srv.pages) == sorted(ref_srv.pages)
    for (c, p, _), (rc, rp, _) in zip(out, ref_out):
        if compute_dtype == "float32":
            assert srv.decode(c, p, steps=3)[0] == ref_srv.decode(rc, rp, steps=3)[0]
            continue
        # bf16 rounds at other places in the two frameworks, so a greedy
        # decode may part at a near-tie: feed both the same tokens and hold
        # the logits to the bf16 tolerance instead
        for j, t in enumerate([0, 7, 300]):
            got, c = srv.model.decode_step(c, torch.full((1, 1), t), p + j)
            want, rc = ref_srv._decode(params, rc, jnp.full((1, 1), t, jnp.int32),
                                       jnp.int32(rp + j))
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=ATOL[compute_dtype])
    assert srv.run_postprocess() == ref_srv.run_postprocess()
    assert dataclasses.asdict(srv.metrics) == dataclasses.asdict(ref_srv.metrics)
    srv.dedup.store.check_consistency()


def test_dedup_server_decodes_as_one_that_caches_nothing():
    _, _, port = _models("bfloat16")
    srv = PS.DedupKVServer(port, None, page_tokens=16, max_slots=128, cache_entries=128,
                           device="cpu")
    nodedup = PS.DedupKVServer(port, None, page_tokens=16, max_slots=128, cache_entries=0,
                               device="cpu")
    rng = np.random.default_rng(0)
    _, prompt = _serve_mix(srv, 512, rng)
    toks = np.concatenate([prompt, rng.integers(0, 512, 8)])
    c1, p1, info = srv.prefill_request(0, toks)
    c2, p2, _ = nodedup.prefill_request(0, toks)
    assert info["hit_blocks"] == 3 and nodedup.metrics.blocks_prefill_skipped == 0
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)  # reused pages are exact
    assert srv.decode(c1, p1, steps=4)[0] == nodedup.decode(c2, p2, steps=4)[0]


def test_postprocess_merges_pages_like_reference():
    ref, params, port = _models("bfloat16", scales=False)
    kw = dict(page_tokens=16, max_slots=64, cache_entries=1)
    servers = [RS.DedupKVServer(ref, params, **kw),
               PS.DedupKVServer(port, None, device="cpu", **kw)]
    for srv in servers:
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, 512, 32)
        for _ in range(3):
            srv.prefill_request(0, np.concatenate([prompt, rng.integers(0, 512, 16)]))
            srv.prefill_request(1, rng.integers(0, 512, 48))
        before = len(srv.pages)
        srv.run_postprocess()
        assert len(srv.pages) <= before
        assert srv.dedup.store.duplicate_fingerprints() == []
    assert dataclasses.asdict(servers[1].metrics) == dataclasses.asdict(servers[0].metrics)
    assert sorted(servers[1].pages) == sorted(servers[0].pages)


def test_server_refuses_what_is_not_ported():
    """Every part of the server is ported now: the cluster-backed server,
    snapshots and online GC run on the host when asked.  What it still
    refuses is a card that is not there: by default it runs on the card."""
    _, _, port = _models("float32")
    for num_shards in (1, 4):
        srv = PS.DedupKVServer(port, None, num_shards=num_shards, device="cpu")
        assert isinstance(srv.dedup, ShardedCluster) == (num_shards > 1)
        assert json.loads(json.dumps(srv.snapshot(include_pages=False)))["engine"]["kind"] == \
            ("cluster" if num_shards > 1 else "hpdedup")
        assert srv.run_gc()["moved"] == 0
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
                PS.DedupKVServer(port, None, num_shards=num_shards)


def test_serve_cli_matches_reference(monkeypatch, capsys):
    """The CLI's counts depend on the tokens and the engine, not on the
    weights (drawn from different generators), so they equal the reference's."""
    args = ["--arch", "tinyllama-1.1b", "--smoke", "--requests", "8", "--decode-steps", "2"]
    outs = []
    for main, extra in ((ref_serve.main, []), (port_serve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve", *args, *extra])
        main()
        outs.append(json.loads(capsys.readouterr().out))
    ref_out, out = outs
    assert len(out.pop("decoded_tokens")) == len(ref_out.pop("decoded_tokens")) == 2
    assert out == ref_out
    assert out["blocks_prefill_skipped"] == 3 * 6


def test_write_batch_keeps_fingerprints_from_2_63_up():
    """A Python list of fingerprints that mixes values at or above 2^63 with
    smaller ones: the reference's ``np.asarray`` makes it float64 and stores
    them rounded to 53 bits; the port keeps every bit (ROADMAP, faults found
    against the reference)."""
    fps = [2**63 + 5, 3, 2**63 + 2**40 + 1]
    kw = dict(fixed_threshold=1, adaptive_threshold=False)
    port = HPDedup(device="cpu", **kw)
    ref = R.HPDedup(**kw)
    for engine in (port, ref):
        engine.write_batch(np.zeros(3, np.int64), [0, 1, 2], fps)
    assert sorted(int(v) for v in port.store.fp_of_pba.values()) == sorted(fps)
    assert sorted(int(v) for v in ref.store.fp_of_pba.values()) != sorted(fps)


def test_every_block_maps_to_a_page():
    """After the launcher's mix, each request's LBAs map to PBAs that hold a
    page, so the page pool serves a block table per request (the
    ``paged_attention`` phase of ``chip_smoke.py`` builds its tables so)."""
    _, _, port = _models("float32", scales=False)
    srv = PS.DedupKVServer(port, None, page_tokens=16, max_slots=256, cache_entries=512,
                           device="cpu")
    mix = request_mix(512, 12, 96, np.random.default_rng(0))
    for tenant, toks in mix:
        srv.prefill_request(tenant, toks)
    srv.run_postprocess()
    for r, (tenant, toks) in enumerate(mix):
        row = [srv.dedup.store.lba_map[(tenant, (r << 24) | i)] for i in range(toks.size // 16)]
        assert all(pba in srv.pages for pba in row), r
        if tenant == 0 and r:
            first = [srv.dedup.store.lba_map[(0, i)] for i in range(6)]
            assert row[:6] == first  # the shared prompt's pages, deduplicated


# -- the cluster-backed server ----------------------------------------------------------


def _uint64_writes(ref_srv):
    """Make the reference server's cluster take its fingerprint lists as
    ``uint64``.  Unpatched, ``np.asarray`` turns a request's list that mixes
    values at or above 2^63 with smaller ones into float64 (ROADMAP §3, the
    ``write_batch`` fault): the cluster then routes each write by a rounded
    fingerprint, while the server's cache lookups route by the exact one, so
    prefix hits go to the wrong shard and are lost.  The port converts with
    ``dtype=np.uint64``; the patch shows that this fault is the only
    difference."""
    write_batch = ref_srv.dedup.write_batch
    ref_srv.dedup.write_batch = lambda streams, lbas, fps: write_batch(
        streams, lbas, np.asarray(fps, dtype=np.uint64))
    return ref_srv


def _cluster_servers(compute_dtype, num_shards, patched=True, **kw):
    ref, params, port = _models(compute_dtype, scales=False)
    kw = dict(dict(page_tokens=16, max_slots=128, cache_entries=128), num_shards=num_shards, **kw)
    ref_srv = RS.DedupKVServer(ref, params, **kw)
    return (ref, params, _uint64_writes(ref_srv) if patched else ref_srv,
            PS.DedupKVServer(port, None, device="cpu", **kw))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cluster_server_matches_reference(compute_dtype):
    """``DedupKVServer(num_shards=4)``: the reference's metrics, hit counts,
    page ids (each shard's PBA namespace), engine tree, post-process and GC
    results; float32 decodes the reference's tokens, and every dtype decodes
    what a one-engine server decodes."""
    _, _, ref_srv, srv = _cluster_servers(compute_dtype, 4)
    one = PS.DedupKVServer(srv.model, None, page_tokens=16, max_slots=128, cache_entries=128,
                           device="cpu")
    ref_out, _ = _serve_mix(ref_srv, 512, np.random.default_rng(0))
    out, _ = _serve_mix(srv, 512, np.random.default_rng(0))
    one_out, _ = _serve_mix(one, 512, np.random.default_rng(0))
    assert dataclasses.asdict(srv.metrics) == dataclasses.asdict(ref_srv.metrics) == \
        dataclasses.asdict(one.metrics)
    assert srv.metrics.blocks_prefill_skipped > 0
    assert [o[1:] for o in out] == [o[1:] for o in ref_out]
    assert sorted(srv.pages) == sorted(ref_srv.pages)
    assert len({pba >> 48 for pba in srv.pages}) > 1  # pages live on several shards
    assert json.dumps(snapshot_engine(srv.dedup)) == json.dumps(R.snapshot_engine(ref_srv.dedup))
    for (c, p, _), (rc, rp, _), (oc, op, _) in zip(out, ref_out, one_out):
        tokens = srv.decode(c, p, steps=3)[0]
        assert tokens == one.decode(oc, op, steps=3)[0]
        if compute_dtype == "float32":
            assert tokens == ref_srv.decode(rc, rp, steps=3)[0]
    assert srv.run_postprocess() == ref_srv.run_postprocess()
    assert srv.run_gc(max_moves=8) == ref_srv.run_gc(max_moves=8)
    assert dataclasses.asdict(srv.metrics) == dataclasses.asdict(ref_srv.metrics)
    srv.dedup.check_consistency()


@pytest.mark.parametrize("num_shards", [2, 4])
def test_cluster_server_snapshot_resumes_like_reference(num_shards):
    """Snapshot after three requests, go on; a second server loads the
    snapshot and serves the same rest: equal metrics and engine trees, in
    the port and against the reference.  A JSON-only snapshot of the
    reference's server loads into the port's."""
    ref, params, r1, s1 = _cluster_servers("float32", num_shards)
    faulty = RS.DedupKVServer(ref, params, page_tokens=16, max_slots=128, cache_entries=128,
                              num_shards=num_shards)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, 48)
    requests = [np.concatenate([prompt, rng.integers(0, 512, 8)]) for _ in range(6)]
    snaps = []
    for srv in (r1, s1, faulty):
        for toks in requests[:3]:
            srv.prefill_request(0, toks)
        snaps.append(srv.snapshot())
        for toks in requests[3:]:
            srv.prefill_request(0, toks)
    s2 = PS.DedupKVServer(s1.model, None, page_tokens=16, max_slots=128, cache_entries=128,
                          num_shards=num_shards, device="cpu")
    s2.load_state(snaps[1])
    assert all(isinstance(p.k, torch.Tensor) and p.k.device.type == "cpu"
               for p in s2.pages.values())
    outs = [s2.prefill_request(0, toks) for toks in requests[3:]]
    assert s2.metrics == s1.metrics
    assert dataclasses.asdict(s1.metrics) == dataclasses.asdict(r1.metrics)
    assert json.dumps(snapshot_engine(s2.dedup)) == json.dumps(snapshot_engine(s1.dedup)) == \
        json.dumps(R.snapshot_engine(r1.dedup))
    assert all(info["hit_blocks"] == 3 for _, _, info in outs)
    # the unpatched reference loses prefix hits to its write_batch fault
    assert faulty.metrics.blocks_prefill_skipped < s1.metrics.blocks_prefill_skipped
    # the reference's JSON-only snapshot: the port restores its engine tree
    s3 = PS.DedupKVServer(s1.model, None, page_tokens=16, max_slots=128, cache_entries=128,
                          num_shards=num_shards, device="cpu")
    s3.load_state(json.loads(json.dumps(dict(snaps[0], pages=None))))
    assert s3.pages == {}
    assert json.dumps(snapshot_engine(s3.dedup)) == json.dumps(snaps[0]["engine"])
    c, p, info = s3.prefill_request(0, requests[3])
    assert info["hit_blocks"] == 0  # no pages: prefilled again, never wrong
    s3.run_postprocess()  # the reclaim hooks sit on every shard again
    s3.dedup.check_consistency()


def test_cluster_server_pages_follow_compaction_like_reference():
    """Cache of one entry: duplicates reach the pages, the post-process pass
    frees PBAs, and ``run_gc`` moves blocks on every shard; pages follow
    their blocks and a request decodes as on a server that caches nothing."""
    ref, params, ref_srv, srv = _cluster_servers("float32", 4, cache_entries=1)
    for s in (ref_srv, srv):
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, 512, 32)
        for _ in range(3):
            s.prefill_request(0, np.concatenate([prompt, rng.integers(0, 512, 16)]))
            s.prefill_request(1, rng.integers(0, 512, 48))
    assert srv.run_postprocess() == ref_srv.run_postprocess()
    assert any(e.store._free_pbas for e in srv.dedup.shards)
    stats = srv.run_gc()
    assert stats == ref_srv.run_gc() and stats["moved"] > 0
    assert sorted(srv.pages) == sorted(ref_srv.pages)
    live = set().union(*(set(e.store.fp_of_pba) for e in srv.dedup.shards))
    assert set(srv.pages) <= live
    srv.dedup.check_consistency()
    rng = np.random.default_rng(5)
    toks = np.concatenate([rng.integers(0, 512, 32), rng.integers(0, 512, 16)])
    nodedup = PS.DedupKVServer(srv.model, None, page_tokens=16, max_slots=128, cache_entries=0,
                               device="cpu")
    c1, p1, _ = srv.prefill_request(0, toks)
    c2, p2, _ = nodedup.prefill_request(0, toks)
    assert srv.decode(c1, p1, steps=3)[0] == nodedup.decode(c2, p2, steps=3)[0]
