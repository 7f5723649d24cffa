"""Port parity of the MoE substrate: routing (expert ids exactly, ties to
the lower id as `lax.top_k` breaks them), the load-balance loss, the
sort-based dispatch positions, the dense oracle, and `moe_apply` (each
expert on its own rows) against the dense oracle of both packages, on
seeded numpy inputs in float32.  Tolerance: 1e-5 relative to the largest
magnitude (float32 sums in another order), as in tests/test_torch_lm.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as j_moe
from repro_torch.nn import moe as t_moe

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _params(seed, D, F, E):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "wi": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "wg": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "wo": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("D,F,E,k,T", [(64, 32, 8, 2, 42), (64, 32, 4, 2, 9),
                                       (48, 40, 64, 6, 100),
                                       (32, 16, 16, 4, 1)])
def test_moe_apply_matches_dense_oracles(D, F, E, k, T):
    _, jp, tp = _params(D + E, D, F, E)
    x = np.random.default_rng(T).standard_normal((1, T, D)) \
        .astype(np.float32)
    yj, aj = j_moe.moe_apply_dense(jp, jnp.asarray(x), k)
    yd, ad = t_moe.moe_apply_dense(tp, torch.from_numpy(x), k)
    ya, aa = t_moe.moe_apply(tp, torch.from_numpy(x), k)
    _close(yd, yj)
    _close(ya, yj)
    _close(ya, yd.numpy())
    np.testing.assert_allclose([float(ad), float(aa)], float(aj), rtol=1e-6)
    pj, ij, probs_j = j_moe._route(jnp.asarray(x[0]), jp["router"], k)
    pt, it, probs_t = t_moe._route(torch.from_numpy(x[0]), tp["router"], k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(pt, pj)
    _close(probs_t, probs_j)


def test_route_breaks_ties_toward_the_lower_expert():
    """A zero router gives every expert the same probability: the top k
    are experts 0 .. k-1 in order, as `lax.top_k` picks them.  A router
    with duplicated columns ties pairs of experts: ids equal the
    reference's exactly."""
    D, E, k = 16, 8, 3
    x = np.random.default_rng(0).standard_normal((12, D)).astype(np.float32)
    zero = np.zeros((D, E), np.float32)
    _, it, _ = t_moe._route(torch.from_numpy(x), torch.from_numpy(zero), k)
    _, ij, _ = j_moe._route(jnp.asarray(x), jnp.asarray(zero), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (it.numpy() == np.arange(k)).all()
    router = np.random.default_rng(1).standard_normal((D, E)) \
        .astype(np.float32)
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 0]
    _, it, pt = t_moe._route(torch.from_numpy(x), torch.from_numpy(router),
                             k)
    _, ij, _ = j_moe._route(jnp.asarray(x), jnp.asarray(router), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert torch.equal(pt[:, 5], pt[:, 2])     # the ties are real
    both = [set(r) >= {2, 5} or set(r) >= {0, 7} for r in it.tolist()]
    assert any(both)


def test_dispatch_indices_and_load_balance_match_reference():
    rng = np.random.default_rng(2)
    E, k, T = 6, 2, 40
    top_i = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    want = j_moe._dispatch_indices(jnp.asarray(top_i), E, 4)
    got = t_moe._dispatch_indices(torch.as_tensor(top_i), E, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    probs = rng.dirichlet(np.ones(E), T).astype(np.float32)
    np.testing.assert_allclose(
        float(t_moe.load_balance_loss(torch.from_numpy(probs),
                                      torch.as_tensor(top_i), E)),
        float(j_moe.load_balance_loss(jnp.asarray(probs),
                                      jnp.asarray(top_i), E)), rtol=1e-6)


def test_moe_apply_bf16_matches_dense_oracle():
    """bf16 activations and weights: the same routing, and outputs within
    one bf16 spacing of the dense oracle's (the expert products round to
    bf16 in both; the float32 combine differs only in sum order)."""
    _, _, tp = _params(3, 64, 32, 8)
    tp = {k: v if k == "router" else v.bfloat16() for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, 64)).astype(np.float32)).bfloat16()
    ya, _ = t_moe.moe_apply(tp, x, 2)
    yd, _ = t_moe.moe_apply_dense(tp, x, 2)
    assert ya.dtype == yd.dtype == torch.bfloat16
    torch.testing.assert_close(ya.float(), yd.float(), atol=1e-2,
                               rtol=2.0 ** -7)


def test_moe_init_has_reference_shapes():
    p = t_moe.moe_init(torch.Generator().manual_seed(0), 16, 8, 4,
                       torch.bfloat16, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((16, 4), torch.float32), "wi": ((4, 16, 8), torch.bfloat16),
        "wg": ((4, 16, 8), torch.bfloat16), "wo": ((4, 8, 16), torch.bfloat16)}
