"""The port's long-sequence attention schedules (``flash_attend``,
``banded_attend`` and ``attention_train``'s dispatch over them, in
``repro_torch.models.attention``) against the reference's ``_flash_attend``
and ``_banded_attend``, on the CPU.

* Forward at the reference test's shapes (``tests/test_attention_equivalence.py``):
  flash at S 1,024 and 2,048, causal, not causal and with a window of 512;
  banded at (S, window) (2,048, 512), (4,096, 1,024) and (2,048, 1,024); 2 or
  4 query heads per KV head, in turn (the reference repeats K and V, the
  port groups the query heads).  Float32 within 1e-5; bf16 (every other
  case) within 5e-2.
* Gradients of ``sum(out * w)`` against ``jax.grad`` through the reference
  (whose scans recompute each chunk, ``jax.checkpoint``) within 1e-4.
* ``flash_attend(q_offset=)``: a block of query rows at its offset, causal
  with and without a window, against the reference's
  ``_flash_attend(q_offset=)`` (3e-5, gradients 1e-4); four blocks give a
  whole run's rows, and their dK and dV sum to its.
* bf16 gradients within one bf16 step (2^-7 of the value) plus 1e-4: dq
  against ``jax.grad`` of the reference in bf16; dK and dV, which the
  reference rounds to bf16 for each repeated head and each band before it
  sums them, against its float32 gradient at the same bf16 inputs and
  output cotangent, rounded once.  Both schedules take ``delta = rowsum(dO
  * O)`` from the float32 output, as the reference's gradient does; from
  the output rounded to bf16, flash's dq and dK part by several bf16 steps.
* The dispatch picks what the reference picks, and raises ``ValueError``
  where the reference asserts; prefill, the encoder and cross-attention
  reach the schedules.
* ``_tp``'s row blocks add up to the whole product.
* Clock-free memory: no tensor saved for the backward pass of an attention
  layer at S = 2,048 has Sq x Sk elements (the plain version's do).
* A banded layer over 8 chunks with a window of 4 chunks (so the first
  four query chunks' bands start before position 0) under remat "none",
  "dots" and "full" (``transformer.remat_call``) equals the plain version
  within 3e-5, its gradients within 1e-4, and "dots" and "full" equal
  "none" within 1e-5 relative.  ``FlopCounterMode`` over one forward and
  backward of it counts the band's products at ``BAND_PASSES`` (the
  forward's two, the backward's recompute and four) over each chunk's
  keys from position 0 on: none against a chunk before position 0, and
  under "dots" none replayed (the unit keeps the band's output); "full"
  replays the forward's two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch.utils.flop_counter import FlopCounterMode

import repro.models.attention as RA
from repro.models.layers import ParamFactory as RefFactory
from repro.models.layers import unzip_params
from repro_torch.configs import get_config
from repro_torch.models import attention, encdec, transformer

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
GRAD_TOL = 1e-4
BF16_STEP = 2.0 ** -7   # the largest gap of two neighbouring bf16 values, relative
FLASH = [(1024, True, 0), (1024, False, 0), (2048, True, 512)]
BANDED = [(2048, 512), (4096, 1024), (2048, 1024)]


def _qkv(s, groups, seed, b=1, kv_heads=2, d=16):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, kv_heads * groups, d), (b, s, kv_heads, d), (b, s, kv_heads, d)]
    arrays = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    w = rng.standard_normal(shapes[0]).astype(np.float32)
    return arrays, w


def _ref_fn(kind, heads, **kw):
    """The reference's schedule over K and V repeated to ``heads``, as its
    ``attention_train`` calls it."""
    fn = RA._flash_attend if kind == "flash" else RA._banded_attend

    def call(q, k, v):
        return fn(q, RA._repeat_kv(k, heads), RA._repeat_kv(v, heads), **kw)
    return call


def _port_fn(kind, **kw):
    fn = attention.flash_attend if kind == "flash" else attention.banded_attend
    return lambda q, k, v: fn(q, k, v, **kw)


CASES = ([("flash", s, dict(causal=c, window=w)) for s, c, w in FLASH]
         + [("banded", s, dict(window=w)) for s, w in BANDED])
IDS = [f"{k}-{s}-" + "-".join(f"{a}{b}" for a, b in kw.items()) for k, s, kw in CASES]


@pytest.mark.parametrize("kind,s,kw,groups", [c + (2 + 2 * (i % 2),) for i, c in enumerate(CASES)],
                         ids=[f"{x}-g{2 + 2 * (i % 2)}" for i, x in enumerate(IDS)])
def test_schedule_and_gradients_match_reference(kind, s, kw, groups):
    (q, k, v), w = _qkv(s, groups, seed=s + groups)
    ref = _ref_fn(kind, q.shape[2], **kw)
    want_out = np.asarray(jax.jit(ref)(q, k, v))
    want_grads = jax.jit(jax.grad(lambda *a: jnp.sum(ref(*a) * w), argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = _port_fn(kind, **kw)(*ts)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=TOL["float32"])
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_TOL,
                                   err_msg=f"d{name}")


# flash_attend(q_offset=): (Sk, query rows, offset, window), causal; the
# schedules' limits (the card's too): output 3e-5, gradients 1e-4
OFFSET_CASES = [(2048, 512, 1024, 0), (2048, 512, 700, 0), (2048, 1024, 1024, 512),
                (1024, 256, 0, 0)]
OFFSET_TOL, OFFSET_GRAD_TOL = 3e-5, 1e-4


@pytest.mark.parametrize("sk,sq,offset,window", OFFSET_CASES,
                         ids=[f"sk{a}-sq{b}-off{c}-w{d}" for a, b, c, d in OFFSET_CASES])
def test_flash_q_offset_matches_reference(sk, sq, offset, window):
    """A block of query rows at ``q_offset`` against the whole K and V,
    causal (with and without a window), forward and gradients, against the
    reference's ``_flash_attend(q_offset=)`` in float32; a chunk after the
    block's last query is skipped (its dK and dV zero), as are the rows
    before a chunk's first key."""
    (q, k, v), w = _qkv(sk, 2, seed=sk + sq + offset)
    q, w = q[:, offset:offset + sq], w[:, offset:offset + sq]
    kw = dict(causal=True, window=window, q_offset=offset)
    ref = _ref_fn("flash", q.shape[2], **kw)
    want_out = np.asarray(jax.jit(ref)(q, k, v))
    want_grads = jax.jit(jax.grad(lambda *a: jnp.sum(ref(*a) * w), argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attention.flash_attend(*ts, **kw)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=OFFSET_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=OFFSET_GRAD_TOL,
                                   err_msg=f"d{name}")
    after = (offset + sq + attention.KV_CHUNK - 1) // attention.KV_CHUNK * attention.KV_CHUNK
    assert not ts[1].grad[:, after:].any() and not ts[2].grad[:, after:].any()


@pytest.mark.parametrize("window", [0, 512])
def test_flash_q_offset_blocks_equal_whole_run(window):
    """Four blocks of 512 query rows of a 2,048-token causal sequence, each
    at its offset against the whole K and V, give the whole run's rows (the
    output and dq) and, summed, its dK and dV, within the schedules' limits
    (3e-5, 1e-4)."""
    (q, k, v), w = _qkv(2048, 4, seed=11 + window)
    qt, kt, vt, wt = (torch.from_numpy(x) for x in (q, k, v, w))

    def run(qq, off, ww):
        ts = [qq.clone().requires_grad_(True), kt.clone().requires_grad_(True),
              vt.clone().requires_grad_(True)]
        out = attention.flash_attend(*ts, causal=True, window=window, q_offset=off)
        (out * ww).sum().backward()
        return out.detach(), [t.grad for t in ts]

    whole, (dq, dk, dv) = run(qt, 0, wt)
    rows, dqs, dk_sum, dv_sum = [], [], torch.zeros_like(dk), torch.zeros_like(dv)
    for off in range(0, 2048, 512):
        out, (gq, gk, gv) = run(qt[:, off:off + 512], off, wt[:, off:off + 512])
        rows.append(out)
        dqs.append(gq)
        dk_sum += gk
        dv_sum += gv
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), whole.numpy(), atol=OFFSET_TOL)
    for name, got, want in (("dq", torch.cat(dqs, 1), dq), ("dk", dk_sum, dk), ("dv", dv_sum, dv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=OFFSET_GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("kind,s,kw", CASES[::2], ids=IDS[::2])
def test_schedule_bf16_matches_reference(kind, s, kw):
    (q, k, v), _ = _qkv(s, 2, seed=s)
    ref = _ref_fn(kind, q.shape[2], **kw)
    want = ref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = _port_fn(kind, **kw)(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("kind,s,kw,groups", [c + (2 + 2 * (i % 2),) for i, c in enumerate(CASES)],
                         ids=[f"{x}-g{2 + 2 * (i % 2)}" for i, x in enumerate(IDS)])
def test_schedule_bf16_gradients_match_reference(kind, s, kw, groups):
    (q, k, v), w = _qkv(s, groups, seed=s + groups + 1)
    ref = _ref_fn(kind, q.shape[2], **kw)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want_bf16 = jax.jit(jax.grad(lambda *a: jnp.sum(ref(*a) * w), argnums=(0, 1, 2)))(*bf)
    # the bf16 output's cotangent is w rounded to bf16
    w_bf = jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)
    want_f32 = jax.jit(jax.grad(lambda *a: jnp.sum(ref(*a) * w_bf), argnums=(0, 1, 2)))(
        *(x.astype(jnp.float32) for x in bf))
    want = [want_bf16[0]] + [g.astype(jnp.bfloat16) for g in want_f32[1:]]
    ts = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    (_port_fn(kind, **kw)(*ts).float() * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", ts, want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(g, np.float32),
                                   rtol=BF16_STEP, atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("kind,s,kw", CASES, ids=IDS)
def test_schedule_matches_plain_version(kind, s, kw):
    (q, k, v), _ = _qkv(s, 4, seed=7)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    plain = attention.attend_plain(*ts, causal=kw.get("causal", True), window=kw["window"])
    np.testing.assert_allclose(_port_fn(kind, **kw)(*ts).numpy(), plain.numpy(),
                               atol=TOL["float32"])


@pytest.mark.parametrize("sq,groups", [(16, 4), (1000, 2), (1024, 8), (3, 1)])
def test_row_blocked_product_equals_einsum(sq, groups):
    """``_tp`` (a chunk's dK or dV) sums ``TP_ROWS`` rows a product, with a
    tail of fewer rows and chunks shorter than one product."""
    rng = np.random.default_rng(sq)
    a = torch.from_numpy(rng.standard_normal((2, 3, sq, groups, 5)))
    x = torch.from_numpy(rng.standard_normal((2, 3, sq, groups, 7)))
    np.testing.assert_allclose(attention._tp(a, x).numpy(),
                               torch.einsum("bksgc,bksgd->bkcd", a, x).numpy(), rtol=1e-12)


D, H, KVH, HD = 32, 4, 2, 8


def _layer_params(seed=0):
    p, _ = unzip_params(RA.init_attention(RefFactory(jax.random.PRNGKey(seed), jnp.float32),
                                          D, H, KVH, HD))
    p = jax.tree.map(np.array, p)
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


# (S, window, cross memory length or 0): what the reference takes.
DISPATCH = [
    (300, 0, 0),       # flash, one chunk
    (1024, 0, 0),      # flash, two chunks
    (600, 200, 0),     # banded, chunk 200
    (1536, 1024, 0),   # banded, chunk 512
    (1024, 1024, 0),   # flash: S not past the window
    (512, 256, 0),     # banded
    (64, 0, 1024),     # cross-attention over 1,024 keys
    (600, 256, 0),     # refused: flash over 600 keys
    (1280, 768, 0),    # refused: 512 does not divide 1,280
    (1000, 0, 0),      # refused
    (64, 0, 1000),     # refused: cross-attention over 1,000 keys
]


@pytest.mark.parametrize("s,window,cross", DISPATCH)
def test_dispatch_picks_what_the_reference_picks(s, window, cross, monkeypatch):
    p, pt = _layer_params()
    rng = np.random.default_rng(s + window)
    x = rng.standard_normal((1, s, D)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    mem = rng.standard_normal((1, cross, KVH, HD)).astype(np.float32) if cross else None
    picked = {"ref": [], "port": []}
    for mod, names, who in ((RA, ("_flash_attend", "_banded_attend"), "ref"),
                            (attention, ("flash_attend", "banded_attend"), "port")):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, _w=who, **kw:
                                picked[_w].append((_n.strip("_").split("_")[0],
                                                   kw.get("causal", True))) or _f(*a, **kw))
    override = (jnp.asarray(mem), jnp.asarray(mem)) if cross else None
    try:
        want = np.asarray(RA.attention_train(p, jnp.asarray(x), jnp.asarray(pos), window=window,
                                             kv_override=override))
    except AssertionError:
        want = None
    t_override = (torch.from_numpy(mem), torch.from_numpy(mem)) if cross else None
    if want is None:
        with pytest.raises(ValueError):
            attention.attention_train(pt, torch.from_numpy(x), torch.from_numpy(pos),
                                      window=window, kv_override=t_override)
        return
    got = attention.attention_train(pt, torch.from_numpy(x), torch.from_numpy(pos),
                                    window=window, kv_override=t_override)[0]
    assert picked["port"] == picked["ref"] and len(picked["ref"]) == 1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"], rtol=TOL["float32"])


def _largest_saved(fn) -> int:
    """The most elements of any tensor autograd saves while ``fn`` runs."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    out.sum().backward()
    return max(sizes)


@pytest.mark.parametrize("window", [0, 512], ids=["flash", "banded"])
def test_nothing_of_sq_by_sk_is_kept(window):
    s = 2048
    _, pt = _layer_params()
    for t in pt.values():
        t.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, s, D)).astype(np.float32))
    pos = torch.arange(s, dtype=torch.int32)[None]
    largest = _largest_saved(lambda: attention.attention_train(pt, x, pos, window=window)[0])
    assert largest < s * s, largest
    q, k, v = attention.project_qkv(pt, x, pos)
    plain = _largest_saved(lambda: attention.attend_plain(q, k, v, causal=True, window=window))
    assert plain >= H * s * s


def _counting(monkeypatch):
    calls = []
    for name in ("flash_attend", "banded_attend"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name, lambda *a, _n=name, _f=fn, **kw:
                            calls.append((_n, kw.get("causal"))) or _f(*a, **kw))
    return calls


def test_prefill_reaches_the_banded_schedule(monkeypatch):
    cfg = get_config("mixtral-8x7b", smoke=True)
    params = transformer.init_decoder_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 4 * cfg.attn_window),
                         generator=torch.Generator().manual_seed(1))
    calls = _counting(monkeypatch)
    transformer.prefill(params, toks, None, cfg)
    assert calls == [("banded_attend", None)] * cfg.num_layers


def test_encoder_and_cross_attention_reach_flash(monkeypatch):
    cfg = get_config("whisper-small", smoke=True)
    params = encdec.init_encdec_params(torch.Generator().manual_seed(0), cfg)
    frames = torch.randn(1, 1024, cfg.d_model, generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(2))
    calls = _counting(monkeypatch)
    with torch.no_grad():
        enc, _ = encdec.encode_prefill(params, frames, cfg, self_slots=16)
        assert calls == [("flash_attend", False)] * cfg.encoder_layers
        del calls[:]
        encdec.decoder_logits(params, enc, toks, cfg)
    assert calls == [("flash_attend", True), ("flash_attend", False)] * cfg.num_layers



# A banded unit over 8 chunks of 512 with a window of 4 chunks (the
# reference's RecurrentGemma-2B layer at 4,096 tokens, narrowed): the
# schedules' limits, and how many products the band takes a query chunk
# under each remat policy (forward 2, backward 5, and "full" replays the
# forward).
BAND_S, BAND_WINDOW, BAND_CHUNK, BAND_GROUPS = 4096, 2048, 512, 2
BAND_TOL, BAND_GRAD_TOL, REMAT_RTOL = 3e-5, 1e-4, 1e-5
BAND_PASSES = {"none": 7, "dots": 7, "full": 9}


def _banded_unit(remat: str, ts):
    from repro_torch.models.transformer import remat_call

    return remat_call(lambda *a: attention.banded_attend(*a, window=BAND_WINDOW), remat, *ts)


def _grads(fn, ts, w):
    out = fn()
    return out.detach(), torch.autograd.grad((out * w).sum(), ts)


@pytest.fixture(scope="module")
def band_inputs():
    (q, k, v), w = _qkv(BAND_S, BAND_GROUPS, seed=11)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    w = torch.from_numpy(w)
    plain = _grads(lambda: attention.attend_plain(*ts, causal=True, window=BAND_WINDOW), ts, w)
    none = _grads(lambda: _banded_unit("none", ts), ts, w)
    return ts, w, plain, none


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_banded_under_remat_matches_plain_version(band_inputs, remat):
    ts, w, (want, want_grads), (_, none_grads) = band_inputs
    assert attention._banded(BAND_S, BAND_WINDOW)
    out, grads = _grads(lambda: _banded_unit(remat, ts), ts, w)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=BAND_TOL)
    for name, g, ref, g0 in zip("qkv", grads, want_grads, none_grads):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=BAND_GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=REMAT_RTOL,
                                   atol=REMAT_RTOL * float(g0.abs().max()), err_msg=name)


def _band_units(s: int, window: int, c: int) -> int:
    """Query rows x keys over each query chunk's band from position 0 on."""
    p = window // c
    return sum(c * (min(i, p) + 1) * c for i in range(s // c))


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_banded_products_under_remat(band_inputs, remat):
    """The band's products (every ``aten.bmm`` of the unit) over one forward
    and backward: ``BAND_PASSES[remat]`` products of 2 x H x D x rows x
    keys over each query chunk's keys from position 0 on, so none against
    a chunk before position 0 (fewer than the whole bands' count)."""
    ts, w, _, _ = band_inputs
    with FlopCounterMode(display=False) as fc:
        _grads(lambda: _banded_unit(remat, ts), ts, w)
    flops = sum(n for op, n in fc.get_flop_counts()["Global"].items()
                if op is torch.ops.aten.bmm)
    b, s, h, d = ts[0].shape
    per_pass = 2 * b * h * d * _band_units(BAND_S, BAND_WINDOW, BAND_CHUNK)
    assert flops == BAND_PASSES[remat] * per_pass, flops / per_pass
    whole = 2 * b * h * d * (s // BAND_CHUNK) * BAND_CHUNK * (BAND_WINDOW + BAND_CHUNK)
    assert per_pass < whole
