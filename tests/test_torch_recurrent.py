"""The port's recurrent blocks (``repro_torch.models.{rglru,rwkv6}``) and
the activations they use, against the reference, on the CPU.

* Activations in bf16: ``layers.sigmoid``, ``softplus``, ``gelu`` and
  ``silu`` equal ``jax.nn``'s bit for bit (each step rounded to bf16, the
  constants rounded first); the library functions they stand in for
  (``torch.sigmoid``, ``F.softplus``, ``F.gelu(approximate="tanh")``,
  ``F.silu``) part from them in many elements, which is pinned.
* RG-LRU: ``rglru_train`` against the reference's (its associative scan
  against the port's doubling scan) and its final state against the
  reference's ``_rglru_tail_state``; ``rglru_decode`` continuing from that
  state for 8 steps; all within 1e-5 (float32).  A sequence shorter than
  the conv's 3 taps keeps the zero padding in its state.
* RWKV6: ``rwkv_tm_train`` (chunked, the log-decay clamp acting) and its
  final state against ``_rwkv_tail_state``; ``rwkv_tm_decode`` and the
  channel mix continuing from it; within 1e-5.  A length that is not a
  multiple of 32 raises ``ValueError`` where the reference asserts.

The reference's weights come from its own initialisers (bias-like and
constant leaves replaced by random values, so they act).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.models.rglru as RG
import repro.models.rwkv6 as RW
import repro.models.transformer as RT
from repro.models.config import ModelConfig
from repro.models.layers import ParamFactory as RefFactory
from repro.models.layers import unzip_params
from repro_torch.models import layers, rglru, rwkv6

TOL = 1e-5


def _ref_params(init, *args, seed=0, perturb=()):
    p, _ = unzip_params(init(RefFactory(jax.random.PRNGKey(seed), jnp.float32), *args))
    p = jax.tree.map(np.array, p)
    rng = np.random.default_rng(seed)
    for name in perturb:
        p[name] = (p[name] + rng.normal(0, 0.2, p[name].shape)).astype(np.float32)
    return p


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# -- activations ---------------------------------------------------------------------

ACTS = {
    "sigmoid": (layers.sigmoid, torch.sigmoid, jax.nn.sigmoid),
    "softplus": (layers.softplus, F.softplus, jax.nn.softplus),
    "gelu": (layers.gelu, lambda x: F.gelu(x, approximate="tanh"), jax.nn.gelu),
    "silu": (layers.silu, F.silu, jax.nn.silu),
}


@pytest.mark.parametrize("name", list(ACTS))
def test_activations_match_reference_bit_for_bit_in_bf16(name):
    mine, library, ref = ACTS[name]
    x = (np.random.default_rng(0).standard_normal(100_000) * 3).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = mine(xt)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)
    parted = float(np.mean(library(xt).float().numpy() != want))
    assert parted > 0.1, parted   # the one-rounding library function parts from it
    _close(mine(torch.from_numpy(x)), ref(jnp.asarray(x)), tol=1e-6)  # float32


# -- RG-LRU --------------------------------------------------------------------------


def _rglru(d=16, rnn=24, width=4):
    p = _ref_params(RG.init_rglru, d, rnn, width, perturb=("conv_b", "lam"))
    return p, _t(p)


def test_rglru_train_tail_state_and_decode_match_reference():
    p, pt = _rglru()
    cfg = ModelConfig(name="t", family="hybrid", num_layers=1, d_model=16, num_heads=1,
                      num_kv_heads=1, head_dim=16, d_ff=16, vocab_size=8, rnn_width=24)
    x = (np.random.default_rng(1).standard_normal((2, 40, 16)) * 0.7).astype(np.float32)
    want = jax.jit(RG.rglru_train)(p, jnp.asarray(x))
    _, want_st = RT._rglru_tail_state(p, jnp.asarray(x), cfg)
    got, st = rglru.rglru_train(pt, torch.from_numpy(x))
    _close(got, want, msg="train")
    _close(st.h, want_st.h, msg="h")
    _close(st.conv, want_st.conv, msg="conv")
    assert st.h.dtype == torch.float32
    ref_st = want_st
    for t in range(8):
        step = (np.random.default_rng(10 + t).standard_normal((2, 1, 16))).astype(np.float32)
        want, ref_st = RG.rglru_decode(p, jnp.asarray(step), ref_st)
        got, st = rglru.rglru_decode(pt, torch.from_numpy(step), st)
        _close(got, want, msg=f"decode {t}")
        _close(st.h, ref_st.h, msg=f"h {t}")
        _close(st.conv, ref_st.conv, msg=f"conv {t}")


def test_rglru_short_sequence_state_keeps_the_padding():
    """Two tokens: the conv state is the zero padding then both inputs, and
    decoding on from it equals the train path over the longer sequence."""
    _, pt = _rglru()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 3, 16)).astype(np.float32))
    _, st = rglru.rglru_train(pt, x[:, :2])
    assert st.conv.shape == (1, 3, 24) and not st.conv[:, 0].any()
    whole, _ = rglru.rglru_train(pt, x)
    got, _ = rglru.rglru_decode(pt, x[:, 2:], st)
    _close(got[:, 0], whole[:, 2].numpy())


def test_rglru_bf16_matches_reference():
    p, pt = _rglru()
    x = (np.random.default_rng(3).standard_normal((2, 32, 16)) * 0.7).astype(np.float32)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    want = RG.rglru_train(bf, jnp.asarray(x, jnp.bfloat16))
    got, _ = rglru.rglru_train({k: v.to(torch.bfloat16) for k, v in pt.items()},
                               torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), tol=5e-2)


# -- RWKV6 ---------------------------------------------------------------------------

HEADS, HD, D = 2, 8, 16


def _rwkv():
    """Time-mix weights whose decay base spreads over [-12, 2], so that both
    ends of the log-decay clamp act."""
    p = _ref_params(RW.init_rwkv_tm, D, HEADS, HD,
                    perturb=("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "bonus_u", "ln_scale"))
    base = np.random.default_rng(7).permutation(np.linspace(-12, 2, p["decay_base"].size))
    p["decay_base"] = base.reshape(p["decay_base"].shape).astype(np.float32)
    return p, _t(p)


def test_rwkv_train_tail_state_and_decode_match_reference():
    p, pt = _rwkv()
    cfg = ModelConfig(name="t", family="ssm", num_layers=1, d_model=D, num_heads=HEADS,
                      num_kv_heads=HEADS, head_dim=HD, d_ff=32, vocab_size=8)
    x = (np.random.default_rng(4).standard_normal((2, 64, D)) * 3).astype(np.float32)
    want = jax.jit(RW.rwkv_tm_train, static_argnums=(2, 3))(p, jnp.asarray(x), HEADS, HD)
    want_st = RT._rwkv_tail_state(p, jnp.asarray(x), cfg)
    *_, logw = RW._projections(p, jnp.asarray(x), RW._token_shift(
        jnp.asarray(x), jnp.zeros((2, D))), HEADS, HD)
    assert float(jnp.mean(logw == RW._LOGW_MIN)) > 0.05
    assert float(jnp.mean(logw == RW._LOGW_MAX)) > 0.05
    got, st = rwkv6.rwkv_tm_train(pt, torch.from_numpy(x), HEADS, HD)
    _close(got, want, msg="train")
    _close(st.s, want_st.s, msg="state")
    assert torch.equal(st.shift_tm, torch.from_numpy(x[:, -1]))
    s, shift = want_st.s, want_st.shift_tm
    ms, mshift = st.s, st.shift_tm
    for t in range(6):
        step = np.random.default_rng(20 + t).standard_normal((2, 1, D)).astype(np.float32)
        want, s, shift = RW.rwkv_tm_decode(p, jnp.asarray(step), s, shift, HEADS, HD)
        got, ms, mshift = rwkv6.rwkv_tm_decode(pt, torch.from_numpy(step), ms, mshift,
                                               HEADS, HD)
        _close(got, want, msg=f"decode {t}")
        _close(ms, s, msg=f"state {t}")
        assert torch.equal(mshift, torch.from_numpy(step[:, 0]))


def test_rwkv_channel_mix_matches_reference():
    p = _ref_params(RW.init_rwkv_cm, D, 32, perturb=("mu_r", "mu_k"))
    x = np.random.default_rng(5).standard_normal((2, 12, D)).astype(np.float32)
    _close(rwkv6.rwkv_cm_train(_t(p), torch.from_numpy(x)), RW.rwkv_cm_train(p, jnp.asarray(x)))
    shift = np.random.default_rng(6).standard_normal((2, D)).astype(np.float32)
    want, want_shift = RW.rwkv_cm_decode(p, jnp.asarray(x[:, :1]), jnp.asarray(shift))
    got, got_shift = rwkv6.rwkv_cm_decode(_t(p), torch.from_numpy(x[:, :1]),
                                          torch.from_numpy(shift))
    _close(got, want)
    assert torch.equal(got_shift, torch.from_numpy(np.asarray(want_shift)))


def test_rwkv_refuses_what_the_reference_asserts():
    p, pt = _rwkv()
    x = np.zeros((1, 40, D), np.float32)
    with pytest.raises(AssertionError):
        RW.rwkv_tm_train(p, jnp.asarray(x), HEADS, HD)
    with pytest.raises(ValueError, match="multiple of 32"):
        rwkv6.rwkv_tm_train(pt, torch.from_numpy(x), HEADS, HD)
