"""The port's MoE (``repro_torch.models.moe``) against the reference's
``_moe_local`` (``moe_apply`` outside a mesh), on the CPU in float32.

* Routing: the chosen experts, the expert-sorted order of the (token,
  choice) assignments and the kept-assignment mask equal the reference's
  exactly, at (E, k) in {(4, 1), (4, 2), (8, 2)}, with a capacity that
  drops nothing (cf = E / k) and with the config's 1.25 and a tight 0.5,
  which drop; the stable sort decides which assignment of an expert keeps
  its place.
* Outputs within 1e-5, the aux loss within 1e-6, and the gradients of a
  loss over both within 1e-4 (router, the three expert weights and the
  input).  The reference's weights come from its own ``init_moe``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RMOE
from repro.models.layers import ParamFactory as RefFactory
from repro.models.layers import unzip_params
from repro_torch.models import moe

CASES = [(4, 1), (4, 2), (8, 2)]
CAPACITY = {"no-drop": None, "config": 1.25, "tight": 0.5}


def _setup(e, k, t=48, d=16, ff=32, seed=0):
    params, _ = unzip_params(RMOE.init_moe(RefFactory(jax.random.PRNGKey(e * 10 + k),
                                                       jnp.float32), d, ff, e, "swiglu"))
    params = jax.tree.map(np.array, params)  # writable copies
    x = np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)
    return params, x


def _ref_routing(x, router, k, cf):
    """The reference's routing lines (``src/repro/models/moe.py:66-88``)
    written out, since ``_moe_local`` returns only its output."""
    t, e = x.shape[0], router.shape[-1]
    tk = t * k
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    capacity = int(max(1, cf * tk / e))
    flat = expert_ids.reshape(tk)
    order = jnp.argsort(flat)
    se = flat[order]
    counts = jnp.sum(jax.nn.one_hot(se, e, dtype=jnp.int32), axis=0)
    pos = jnp.arange(tk) - (jnp.cumsum(counts) - counts)[se]
    tok = jnp.repeat(jnp.arange(t), k)[order]
    return [np.asarray(a) for a in (expert_ids, se, tok, pos < capacity)]


def _ref_local(cf, k):
    def fn(x, router, w_in, w_gate, w_out):
        return RMOE._moe_local(x, router, w_in, w_gate, w_out, top_k=k, capacity_factor=cf,
                               act="swiglu", expert_offset=jnp.int32(0), psum_axes=())
    return fn


def _cf(name, e, k):
    return float(e) / k if CAPACITY[name] is None else CAPACITY[name]


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("e,k", CASES, ids=[f"E{e}-k{k}" for e, k in CASES])
def test_routing_matches_reference_exactly(e, k, capacity):
    params, x = _setup(e, k)
    cf = _cf(capacity, e, k)
    r = moe.route(torch.from_numpy(x), torch.from_numpy(params["router"]), k, cf)
    ids, se, tok, keep = _ref_routing(x, params["router"], k, cf)
    assert torch.equal(r.expert_ids, torch.from_numpy(ids).long())
    assert torch.equal(r.expert, torch.from_numpy(se).long())
    assert torch.equal(r.token, torch.from_numpy(tok).long())
    assert torch.equal(r.keep, torch.from_numpy(keep))
    if capacity == "no-drop":
        assert bool(r.keep.all())
    elif capacity == "tight":
        assert not bool(r.keep.all())
        # within an expert, the assignments that keep come first (stable sort)
        for ex in range(e):
            kept = r.keep[r.expert == ex]
            assert not bool((kept[1:] & ~kept[:-1]).any())


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("e,k", CASES, ids=[f"E{e}-k{k}" for e, k in CASES])
def test_output_aux_and_grads_match_reference(e, k, capacity):
    params, x = _setup(e, k)
    cf = _cf(capacity, e, k)
    args = (x, params["router"], params["w_in"], params["w_gate"], params["w_out"])
    probe = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def ref_loss(*a):
        out, aux = _ref_local(cf, k)(*a)
        return jnp.sum(out * probe) + aux, (out, aux)

    (_, (want, want_aux)), want_g = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*map(jnp.asarray, args))
    mine = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    out, aux = moe.moe_local(*mine, top_k=k, capacity_factor=cf, act="swiglu")
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6, atol=1e-6)
    ((out * torch.from_numpy(probe)).sum() + aux).backward()
    for name, t, g in zip(("x", "router", "w_in", "w_gate", "w_out"), mine, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4, err_msg=name)


def test_moe_apply_and_drop_share():
    """``moe_apply`` is ``moe_local`` over the (B * S) tokens; ``drop_share``
    counts the dropped assignments, none at cf = E / k."""
    e, k = 4, 2
    params, x = _setup(e, k, t=64)
    p = {n: torch.from_numpy(v) for n, v in params.items()}
    xt = torch.from_numpy(x).view(2, 32, -1)
    want, _ = RMOE.moe_apply(params, jnp.asarray(x).reshape(2, 32, -1), top_k=k,
                             capacity_factor=1.25, act="swiglu")
    got, _ = moe.moe_apply(p, xt, top_k=k, capacity_factor=1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert moe.drop_share(p, xt, k, float(e) / k) == 0.0
    keep = _ref_routing(x, params["router"], k, 0.5)[3]
    assert moe.drop_share(p, xt, k, 0.5) == pytest.approx(1 - keep.mean())
